"""mxnet_tpu_torch's flash attention with its gradient against the JAX
package's Pallas flash kernels.

Forward: the port's ``fused_flash_fwd`` on CPU tensors (its plain version)
against ``_flash_fwd_pallas(..., return_lse=True, interpret=True)``, o and
lse.  Backward: ``dq, dk, dv`` of the port's ``flash_attention``
(``torch.autograd.Function``, plain versions on the CPU) against
``jax.grad`` of ``flash_attention(..., interpret=True)``, which runs the
Pallas dk/dv and dq kernels in interpret mode.  Both causal values, T 64,
a ragged T 72, Tk != T, a scale other than 1/sqrt(D), and the head dims
32 and 128 beside 16.  Tolerances as in
``tests/test_attention.py``: 2e-5 for the forward, 1e-4 for gradients
(the frameworks sum in different orders).  On bf16 inputs the plain
versions against ``_flash_fwd_pallas`` and ``_flash_bwd_pallas`` in
interpret mode, in bf16: o, dq, dk, dv bf16 within the bf16 class of the
JAX parity harness (``parity._TOL``), lse fp32 within the fp32 class;
on float64 inputs the plain versions against einsum attention in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops.fused.parity import _TOL
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as patt
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import attention_kernels as pak

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(t, tk, seed, b=1, h=2, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, t, d).astype(np.float32))


@pytest.mark.parametrize("t,tk,causal,scale", [
    (64, 64, True, None),
    (72, 72, False, 0.3),     # ragged, not causal, another scale
    (64, 48, False, None),    # Tk != T
])
def test_flash_forward_and_lse_match_pallas(t, tk, causal, scale):
    q, k, v, _ = _inputs(t, tk, seed=t + tk)
    sm = scale if scale is not None else q.shape[-1] ** -0.5
    want_o, want_lse = jatt._flash_fwd_pallas(
        *map(jnp.asarray, (q, k, v)), causal, sm, interpret=True,
        return_lse=True)
    o, lse = pak.fused_flash_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                                 scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("t,tk,causal,scale", [
    (64, 64, True, 0.2),
    (72, 72, False, None),
])
def test_flash_gradients_match_pallas_backward(t, tk, causal, scale):
    q, k, v, w = _inputs(t, tk, seed=2 * t + 1)

    def loss(q, k, v):
        return jnp.sum(jatt.flash_attention(q, k, v, causal=causal,
                                            sm_scale=scale, interpret=True)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = patt.flash_attention(*xs, causal=causal, sm_scale=scale)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("d", [32, 128])
def test_flash_gradients_match_pallas_backward_head_dims(d):
    """The other head dims the backward takes (32 on the tensor-core
    kernels, 128 on the CUDA-core pair), causal with Tk != T: the plain
    versions against the Pallas backward in interpret mode."""
    q, k, v, w = _inputs(24, 40, seed=d, d=d)

    def loss(q, k, v):
        return jnp.sum(jatt.flash_attention(q, k, v, causal=True,
                                            interpret=True)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = patt.flash_attention(*xs, causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def _float64_attention(q, k, v, causal, scale):
    """Softmax attention spelled with einsum and ``torch.softmax``, in the
    inputs' dtype (the causal mask without offset, as the kernels')."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool)
                          .triu(1), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def test_bf16_plain_versions_match_pallas_in_bf16():
    """The bench's dtype: causal, ragged T with another scale, and Tk != T.
    The products take bf16 operands with fp32 sums, p and ds are rounded to
    bf16 where the Pallas kernels round them, the softmax and lse are fp32.
    The backward of both is fed the Pallas forward's o and lse.  The same
    plain versions on float64 inputs stay in float64 (the reference the
    card's readings against float64 use): o and the gradients within 1e-12
    of einsum attention and its autograd gradients in float64."""
    for t, tk, causal, scale in ((64, 64, True, None), (72, 72, False, 0.3),
                                 (64, 48, True, None)):
        q, k, v, do = (torch.from_numpy(a).double()
                       for a in _inputs(t, tk, seed=3 * t + tk))
        sm = scale if scale is not None else q.shape[-1] ** -0.5
        xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
        want_o = _float64_attention(*xs, causal, sm)
        want = torch.autograd.grad(want_o, xs, do)
        o, lse = patt.flash_fwd_plain(q, k, v, causal, scale)
        got = patt.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        for name, g, w in zip(("o", "dq", "dk", "dv"), (o,) + got,
                              (want_o.detach(),) + want):
            assert g.dtype == torch.float64, name
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12,
                                       msg="float64 %s T=%d Tk=%d"
                                       % (name, t, tk))
        assert lse.dtype == torch.float64
    rtol, atol = _TOL["bfloat16"]
    for t, tk, causal, scale in ((64, 64, True, None), (72, 72, False, 0.3),
                                 (64, 48, True, None)):
        arrays = [a.astype(jnp.bfloat16)
                  for a in _inputs(t, tk, seed=3 * t + tk)]
        q, k, v, do = (torch.from_numpy(np.asarray(a).astype(np.float32))
                       .to(torch.bfloat16) for a in arrays)
        sm = scale if scale is not None else q.shape[-1] ** -0.5
        want_o, want_lse = jatt._flash_fwd_pallas(
            *arrays[:3], causal, sm, interpret=True, return_lse=True)
        o, lse = pak.fused_flash_fwd(q, k, v, causal, scale)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(want_o).astype(np.float32),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=_TOL["float32"][0],
                                   atol=_TOL["float32"][1])
        want = jatt._flash_bwd_pallas(*arrays[:3], want_o, want_lse,
                                      arrays[3], causal, sm, interpret=True)
        o = torch.from_numpy(np.asarray(want_o).astype(np.float32)).to(
            torch.bfloat16)
        got = pak.fused_flash_bwd(q, k, v, o, torch.from_numpy(
            np.array(want_lse)), do, causal, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w).astype(np.float32),
                rtol=rtol, atol=atol, err_msg="%s T=%d Tk=%d" % (name, t, tk))


def test_backward_kernels_by_head_dim():
    """fp32: D 32 and 64 take the tensor-core pair; D 128, where the
    tensor-core dK/dV pass would need more registers than a thread has, the
    CUDA-core pair, counted under its own names.  bf16: D 32 and 64 take
    the redesigned pair (csrc/flash_bwd_bf16_sm90.cu), never the first
    (``_v1``) one; D 128, past the redesigned consumers' registers, the
    first pair, counted under its own names.  The forward likewise: fp32
    takes the prefill kernel at every D; bf16 the redesigned forward
    (csrc/flash_fwd_bf16_sm90.cu) at D 32 and 64 and the first one
    (``_v1``, csrc/flash_bf16.cu) at D 128."""
    for d in (32, 64):
        assert pak.bwd_kernels(d) == (pak.FLASH_BWD_DKDV, pak.FLASH_BWD_DQ)
    assert pak.bwd_kernels(128) == (pak.FLASH_BWD_DKDV_SIMT,
                                    pak.FLASH_BWD_DQ_SIMT)
    names = [kern.name for kern in pak.bwd_kernels(64)
             + pak.bwd_kernels(128)]
    assert names == ["flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_simt",
                     "flash_bwd_dq_simt"]
    bf16 = torch.bfloat16
    for d in (32, 64):
        pair = pak.bwd_kernels(d, bf16)
        assert pair == (pak.FLASH_BWD_DKDV_BF16, pak.FLASH_BWD_DQ_BF16)
        assert [kern.lib for kern in pair] == ["flash_bwd_bf16_sm90"] * 2
        assert not any(kern.name.endswith("_v1") for kern in pair)
    assert pak.bwd_kernels(128, bf16) == (pak.FLASH_BWD_DKDV_BF16_V1,
                                          pak.FLASH_BWD_DQ_BF16_V1)
    names = [kern.name for kern in pak.bwd_kernels(64, bf16)
             + pak.bwd_kernels(128, bf16)]
    assert names == ["flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
                     "flash_bwd_dkdv_bf16_v1", "flash_bwd_dq_bf16_v1"]
    for d in (32, 64, 128):
        assert pak.fwd_kernel(d) is pak.FLASH_PREFILL
        assert pak.fwd_kernel(d, torch.float32).name == "flash_prefill"
    for d in (32, 64):
        kern = pak.fwd_kernel(d, bf16)
        assert kern is pak.FLASH_FWD_BF16
        assert (kern.name, kern.lib) == ("flash_fwd_bf16",
                                         "flash_fwd_bf16_sm90")
        assert not kern.name.endswith("_v1")
    kern = pak.fwd_kernel(128, bf16)
    assert kern is pak.FLASH_FWD_BF16_V1
    assert (kern.name, kern.lib) == ("flash_fwd_bf16_v1", "flash_bf16")


def test_backward_plain_agrees_with_autograd_of_the_forward():
    """The plain backward from lse equals autograd through the plain
    forward (so the lse convention is the forward's own), causal, with a
    scale other than 1/sqrt(D)."""
    q, k, v, do = map(torch.from_numpy, _inputs(40, 40, seed=5))
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    o, _ = patt.flash_fwd_plain(*xs, True, 0.37)
    want = torch.autograd.grad(o, xs, do)
    o, lse = patt.flash_fwd_plain(q, k, v, True, 0.37)
    got = patt.flash_bwd_plain(q, k, v, o, lse, do, True, 0.37)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_cpu_training_path_launches_no_kernel():
    reset_launch_counts()
    q, k, v, _ = map(torch.from_numpy, _inputs(8, 8, seed=1))
    xs = [a.requires_grad_(True) for a in (q, k, v)]
    patt.flash_attention(*xs, causal=True).sum().backward()
    counts = launch_counts()
    assert counts["flash_prefill"] == counts["flash_bwd_dkdv"] \
        == counts["flash_bwd_dq"] == counts["flash_fwd_simt"] \
        == counts["flash_bwd_dkdv_simt"] == counts["flash_bwd_dq_simt"] \
        == counts["flash_fwd_bf16"] == counts["flash_fwd_bf16_v1"] == 0


def test_flash_wrappers_refuse_other_devices():
    q = torch.empty(1, 2, 4, 16, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(MXNetError):
        pak.fused_flash_fwd(q, q, q)
    with pytest.raises(MXNetError):
        pak.fused_flash_bwd(q, q, q, q, lse, q)
