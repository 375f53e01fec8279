"""Probe: do GEMMs with fused epilogues beat cuBLAS plus elementwise passes
at ResNet-50's 1x1-conv shapes?  (The port of ``tools/bottleneck_probe.py``.)

Three head-to-heads per shape, forward only:

  A. 1x1 conv + BN affine + ReLU + residual add
     torch:  relu(scale * (x @ w) + bias + res)   (cuBLAS, then elementwise)
     kernel: :func:`mm_epilogue`, the epilogue inside the product's tiles
  B. the backward cotangent path dx = dy @ w^T + dres
     torch:  (dy @ w^T) + dres
     kernel: :func:`mm_epilogue` with scale 1, bias 0, ``res=dres``, no ReLU
  C. y = x @ w plus the per-channel sum(acc), sum(acc^2) of training BN
     torch:  y, then two reductions over y
     kernel: :func:`mm_with_stats`, column partials per block of rows

Shapes: the 1x1 convs of ResNet-50's stages at the bench configuration
(batch 128, NHWC, bf16): ``M = B*H*W`` rows, ``K -> N`` channels.

The kernels are ``mm_epilogue_kernel`` and ``mm_stats_kernel`` of
``csrc/gemm_kernels.cu`` (the JAX tool's two Pallas kernels).  Each has a
plain version here; the wrappers run it for CPU tensors.  Times are device
times from CUDA events around ``PROBE_STEPS`` (default 100) back-to-back
calls after a warm-up.

Run on the card:  python -m mxnet_tpu_torch.tools.bottleneck_probe
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..base import MXNetError
from ..ops._build import Kernel, device_kind, require

__all__ = ["MM_EPILOGUE", "MM_WITH_STATS", "SHAPES", "main", "mm_epilogue",
           "mm_epilogue_plain", "mm_with_stats", "mm_with_stats_plain",
           "probe_shape"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MM_EPILOGUE = Kernel(
    "mm_epilogue", "gemm_kernels", "mxtpu_mm_epilogue",
    [_P] * 6 + [ctypes.c_longlong, _I, _I, _I, _I])
MM_WITH_STATS = Kernel(
    "mm_with_stats", "gemm_kernels", "mxtpu_mm_stats",
    [_P] * 5 + [ctypes.c_longlong, _I, _I, _I])

# Rows of one output tile of csrc/gemm_kernels.cu (kBM): mm_with_stats
# writes one row of column partials per block of this many rows.
_TILE_ROWS = 128

# (name, M, K, N): the 1x1 convs of each ResNet-50 stage at batch 128
SHAPES = [
    ("stage2_reduce", 401408, 256, 64),
    ("stage2_expand", 401408, 64, 256),
    ("stage3_expand", 100352, 128, 512),
    ("stage4_expand", 25088, 256, 1024),
    ("stage5_expand", 6272, 512, 2048),
]


def _check_rows(m):
    """The JAX tool's ``_pick_bm`` contract: a row block of at least 8 must
    divide M."""
    if m % 8:
        raise ValueError("no block size divides M=%d" % m)


def _check(name, x, w, dtypes=(torch.bfloat16, torch.float32)):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError("%s: x %s and w %s do not chain"
                         % (name, tuple(x.shape), tuple(w.shape)))
    _check_rows(x.shape[0])
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise MXNetError("%s takes bf16 or fp32 x and w of one type, got "
                         "%s, %s" % (name, x.dtype, w.dtype))


def mm_epilogue_plain(x, w, scale, bias, res=None, relu=True):
    """``relu?(scale * (x @ w) + bias [+ res])``: the product summed in
    fp32, the epilogue in fp32, stored in x's dtype."""
    y = (x.float() @ w.float()) * scale + bias
    if res is not None:
        y = y + res.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def mm_epilogue(x, w, scale, bias, res=None, relu=True):
    """``relu?(scale * (x [M, K] @ w [K, N]) + bias [+ res [M, N]])`` in one
    kernel (the JAX tool's ``mm_epilogue``); ``scale`` and ``bias`` fp32
    ``[N]``.  ``ValueError`` when no row block divides M (M % 8)."""
    _check("mm_epilogue", x, w)
    tensors = (x, w, scale, bias) + (() if res is None else (res,))
    if device_kind(tensors) == "cpu":
        return mm_epilogue_plain(x, w, scale, bias, res, relu)
    m, k = x.shape
    n = w.shape[1]
    require("mm_epilogue", x, x.dtype)
    require("mm_epilogue", w, x.dtype)
    require("mm_epilogue", scale, torch.float32, (n,))
    require("mm_epilogue", bias, torch.float32, (n,))
    if res is not None:
        require("mm_epilogue", res, x.dtype, (m, n))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    MM_EPILOGUE.launch(x.device, x.data_ptr(), w.data_ptr(),
                       scale.data_ptr(), bias.data_ptr(),
                       None if res is None else res.data_ptr(), y.data_ptr(),
                       m, k, n, int(bool(relu)),
                       int(x.dtype == torch.bfloat16))
    return y


def mm_with_stats_plain(x, w):
    """``(y, sum_m acc, sum_m acc^2)`` with ``acc = x @ w`` in fp32 and ``y``
    the accumulator rounded to x's dtype; the sums are of ``acc``."""
    acc = x.float() @ w.float()
    return acc.to(x.dtype), acc.sum(0), (acc * acc).sum(0)


def mm_with_stats(x, w):
    """``y = x @ w`` plus the column sums of the fp32 accumulator and of its
    square (the JAX tool's ``mm_with_stats``): the kernel writes one row of
    partials per 128-row block, and a second pass adds them."""
    _check("mm_with_stats", x, w)
    if device_kind((x, w)) == "cpu":
        return mm_with_stats_plain(x, w)
    m, k = x.shape
    n = w.shape[1]
    require("mm_with_stats", x, x.dtype)
    require("mm_with_stats", w, x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    blocks = -(-m // _TILE_ROWS)
    part1 = torch.empty((blocks, n), dtype=torch.float32, device=x.device)
    part2 = torch.empty_like(part1)
    MM_WITH_STATS.launch(x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                         part1.data_ptr(), part2.data_ptr(), m, k, n,
                         int(x.dtype == torch.bfloat16))
    return y, part1.sum(0), part2.sum(0)


def _time(fn, steps):
    """Device ms of one ``fn()``: CUDA events around ``steps`` calls, after
    two warm-up calls."""
    fn(), fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / steps


def probe_shape(m, k, n, steps):
    """``{"A_torch", "A_kernel", "B_torch", "B_kernel", "C_torch",
    "C_kernel"}`` ms at one shape, bf16, inputs drawn on the card from
    seed 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf)

    x, w = randn(m, k), randn(k, n, scale=0.05)
    scale = torch.rand(n, generator=gen, device=dev) + 0.5
    bias = torch.randn(n, generator=gen, device=dev)
    res = randn(m, n)
    rows = {}

    # A: forward conv + BN affine + ReLU + residual
    rows["A_torch"] = _time(lambda: torch.relu(
        torch.matmul(x, w).float() * scale + bias + res.float()).to(bf),
        steps)
    rows["A_kernel"] = _time(
        lambda: mm_epilogue(x, w, scale, bias, res, relu=True), steps)

    # B: backward cotangent dx = dy @ w^T + dres
    dy, dres = randn(m, n), randn(m, k)
    wt = w.t().contiguous()
    ones = torch.ones(k, device=dev)
    zeros = torch.zeros(k, device=dev)
    rows["B_torch"] = _time(lambda: (
        torch.matmul(dy, wt).float() + dres.float()).to(bf), steps)
    rows["B_kernel"] = _time(lambda: mm_epilogue(
        dy, wt, ones, zeros, res=dres, relu=False), steps)

    # C: forward product + BN statistics
    def torch_c():
        y = torch.matmul(x, w)
        yf = y.float()
        return y, yf.sum(0), (yf * yf).sum(0)

    rows["C_torch"] = _time(torch_c, steps)
    rows["C_kernel"] = _time(lambda: mm_with_stats(x, w), steps)
    return rows


def main():
    """Run every shape of :data:`SHAPES` on the card and print a table of
    ms per call; returns ``{name: rows}``."""
    if not torch.cuda.is_available():
        raise MXNetError("probe the card, not the host: CUDA is not "
                         "available")
    steps = int(os.environ.get("PROBE_STEPS", "100"))
    cols = ("A_torch", "A_kernel", "B_torch", "B_kernel", "C_torch",
            "C_kernel")
    print("%-16s" % "shape" + "".join("%11s" % c for c in cols))
    out = {}
    for name, m, k, n in SHAPES:
        out[name] = rows = probe_shape(m, k, n, steps)
        print("%-16s" % name + "".join("%11.4f" % rows[c] for c in cols)
              + "  (ms, %s)" % torch.cuda.get_device_name(0))
    return out


if __name__ == "__main__":
    main()
