"""The port's bottleneck probe (``mxnet_tpu_torch/tools/bottleneck_probe.py``)
against the JAX tool's Pallas kernels.

``tools/bottleneck_probe.py`` is imported by path, and for each test
``jax.experimental.pallas.pallas_call`` is replaced by its interpret-mode
form (the tool's kernels take no ``interpret`` flag; nothing in ``tools/``
changes).  The port's wrappers run their plain versions on CPU tensors.
``mm_epilogue`` with and without ``res``, with ReLU on and off, and
``mm_with_stats``, at M = 1024, in bf16 (the ``bfloat16`` class of
``ops/fused/parity.py``, 2e-2) and fp32 (``float32`` class, 2e-5).
"""

import functools
import importlib.util
import os
import pkgutil

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch.tools import bottleneck_probe as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
M, K, N = 1024, 64, 96


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    on one CPU, and each torch op would otherwise start a thread per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bottleneck_probe", os.path.join(REPO, "tools",
                                             "bottleneck_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _inputs(dtype, m=M, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, K).astype(np.float32)
    w = (rs.randn(K, N) * 0.05).astype(np.float32)
    scale = (rs.rand(N) + 0.5).astype(np.float32)
    bias = rs.randn(N).astype(np.float32)
    res = rs.randn(m, N).astype(np.float32)
    jx, jw, jres = (jnp.asarray(a, JDT[dtype]) for a in (x, w, res))
    px, pw, pres = (torch.from_numpy(a).to(PDT[dtype]) for a in (x, w, res))
    return ((jx, jw, jnp.asarray(scale), jnp.asarray(bias), jres),
            (px, pw, torch.from_numpy(scale), torch.from_numpy(bias), pres))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_kernels_plain_versions_match_jax(jax_probe, interpret):
    """``mm_epilogue`` with and without ``res``, ReLU on and off, and
    ``mm_with_stats``, whose sums are of the fp32 accumulator, not of the
    rounded ``y``; bf16 and fp32; CPU tensors launch none of the four
    kernels.  The cases are a loop, not parameters (see the note at the
    end of test_torch_conv1x1.py)."""
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        (jx, jw, js, jb, jres), (px, pw, ps, pb, pres) = _inputs(dtype)
        for with_res in (False, True):
            for relu in (True, False):
                case = "%s res=%s relu=%s" % (dtype, with_res, relu)
                want = jax_probe.mm_epilogue(
                    jx, jw, js, jb, jres if with_res else None, relu=relu)
                for fn in (probe.mm_epilogue, probe.mm_epilogue_plain):
                    got = fn(px, pw, ps, pb, pres if with_res else None,
                             relu=relu)
                    assert got.dtype == PDT[dtype], case
                    assert tuple(got.shape) == (M, N), case
                    np.testing.assert_allclose(_f32(got), _f32(want),
                                               err_msg=case, **TOL[dtype])
        (jx, jw, *_), (px, pw, *_) = _inputs(dtype, seed=1)
        want = jax_probe.mm_with_stats(jx, jw)
        for fn in (probe.mm_with_stats, probe.mm_with_stats_plain):
            y, s1, s2 = fn(px, pw)
            assert y.dtype == PDT[dtype]
            assert s1.dtype == s2.dtype == torch.float32
            for name, g, w in zip(("y", "sum", "sum of squares"),
                                  (y, s1, s2), want):
                np.testing.assert_allclose(_f32(g), _f32(w),
                                           err_msg="%s %s" % (dtype, name),
                                           **TOL[dtype])
    counts = launch_counts()
    assert not any(counts[k.name] for k in (
        probe.MM_EPILOGUE, probe.MM_WITH_STATS, probe.MM_EPILOGUE_CORE,
        probe.MM_WITH_STATS_CORE))


def test_refusals_match_jax(jax_probe, interpret):
    """A row count no block of 8 divides raises ``ValueError`` in both
    packages; ``main`` refuses to time without a card."""
    (jx, jw, js, jb, _), (px, pw, ps, pb, _) = _inputs("float32", m=1020)
    for fn, args in ((jax_probe.mm_epilogue, (jx, jw, js, jb)),
                     (jax_probe.mm_with_stats, (jx, jw)),
                     (probe.mm_epilogue, (px, pw, ps, pb)),
                     (probe.mm_with_stats, (px, pw))):
        with pytest.raises(ValueError, match="no block size divides M=1020"):
            fn(*args)
    if not torch.cuda.is_available():
        with pytest.raises(mxnet_tpu_torch.MXNetError,
                           match="probe the card"):
            probe.main()


def test_probe_shapes_and_package_walk():
    """The five ResNet-50 batch-128 shapes are the JAX tool's; the import
    guard of ``test_torch_generation.py``, which walks the package with
    ``pkgutil``, reaches ``mxnet_tpu_torch.tools`` and slice 3's modules.
    The wrappers' choice of kernel, by shape and type alone: every probe
    shape, in both forms of ``mm_epilogue`` (``x @ w`` and ``dy @ w^T``)
    and in ``mm_with_stats``, takes the TMA + wgmma kernels of
    ``gemm_sm90``; fp32, K or N no multiple of 8 and a tensor not 16-byte
    aligned take the wmma cores of ``gemm_kernels``."""
    src = open(os.path.join(REPO, "tools", "bottleneck_probe.py")).read()
    for name, m, k, n in probe.SHAPES:
        assert '("%s", %d, %d, %d)' % (name, m, k, n) in src, name
    bf, f32 = torch.bfloat16, torch.float32
    tma = (probe.MM_EPILOGUE, probe.MM_WITH_STATS)
    core = (probe.MM_EPILOGUE_CORE, probe.MM_WITH_STATS_CORE)
    assert [(k_.name, k_.lib) for k_ in tma + core] == [
        ("mm_epilogue", "gemm_sm90"), ("mm_with_stats", "gemm_sm90"),
        ("mm_epilogue_core", "gemm_kernels"),
        ("mm_with_stats_core", "gemm_kernels")]
    aligned = (0, 256, 4096, 8192, 65536, 1 << 20)
    for name, m, k, n in probe.SHAPES:
        for kk, nn in ((k, n), (n, k)):     # forms A and C; form B
            for stats in (False, True):
                assert probe.gemm_kernel_for(stats, bf, kk, nn, *aligned) \
                    is tma[stats], (name, kk, nn, stats)
                assert probe.gemm_kernel_for(stats, f32, kk, nn, *aligned) \
                    is core[stats], (name, kk, nn, stats)
    for dtype, k, n, ptrs, which in (
            (bf, 200, 72, aligned, 0),      # K, N ragged but 8-aligned
            (bf, 60, 64, aligned, 1),       # K % 8
            (bf, 64, 36, aligned, 1),       # N % 8
            (bf, 64, 64, (0, 8, 0), 1),     # an 8-byte aligned tensor
            (f32, 64, 256, aligned, 1)):
        for stats in (False, True):
            assert probe.gemm_kernel_for(stats, dtype, k, n, *ptrs) \
                is (tma, core)[which][stats], (dtype, k, n, ptrs)
    mods = {m.name for m in pkgutil.walk_packages(
        mxnet_tpu_torch.__path__, "mxnet_tpu_torch.")}
    assert {"mxnet_tpu_torch.tools",
            "mxnet_tpu_torch.tools.bottleneck_probe",
            "mxnet_tpu_torch.models.resnet",
            "mxnet_tpu_torch.ops.fused.conv_kernels"} <= mods
