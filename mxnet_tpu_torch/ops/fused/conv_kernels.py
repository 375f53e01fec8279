"""The 1x1-conv dgrad: CUDA kernel wrappers and plain version.

Counterpart of ``mxnet_tpu/ops/nn.py`` ``_conv1x1_dgrad_pallas``: the input
gradient of a 1x1 stride-1 NHWC convolution, ``dx = dy @ w`` over rows
``M = B*H*W``, as one product with fp32 accumulation.  The registry's
``Convolution`` op calls :func:`conv1x1_dgrad` from its 1x1 backward when
``MXTPU_CONV1X1=pallas`` (``ops/nn.py``).

Two kernels, chosen by shape and type alone:

* ``conv1x1_dgrad`` (``csrc/gemm_sm90.cu``): bf16 with TMA loads and
  wgmma, persistent blocks.  TMA needs 16-byte aligned tensors and row
  strides, so it takes bf16 with ``O`` and ``I`` multiples of 8 (every
  dgrad of the bench ResNet-50); ragged ``M`` is fine.
* ``conv1x1_dgrad_core`` (``csrc/gemm_kernels.cu``): the cp.async + wmma
  (bf16) / fmaf (fp32) GEMM core shared with the bottleneck probe, for fp32
  and for the shapes TMA cannot take.

The bottleneck probe's two epilogue GEMMs route the same way
(:func:`tma_fits`, :func:`tma_launch_shape`).

Neither is a fallback of the other: a build or launch error raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .._build import Kernel, device_kind, require

__all__ = ["CONV1X1_DGRAD", "CONV1X1_DGRAD_CORE", "conv1x1_dgrad",
           "conv1x1_dgrad_plain", "dgrad_kernel_for", "tma_fits",
           "tma_launch_shape", "tma_tile_n"]

_P = ctypes.c_void_p
_I = ctypes.c_int
CONV1X1_DGRAD = Kernel(
    "conv1x1_dgrad", "gemm_sm90", "mxtpu_conv1x1_dgrad_sm90",
    [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I])
CONV1X1_DGRAD_CORE = Kernel(
    "conv1x1_dgrad_core", "gemm_kernels", "mxtpu_conv1x1_dgrad",
    [_P, _P, _P, ctypes.c_longlong, _I, _I, _I])
# Rows of the TMA kernel's output tile; the N of a tile is 64, 128 or 256.
_TMA_BM = 128

# The dtypes the JAX op's 1x1 path is eligible for (nn.py _conv1x1_eligible).
_DTYPES = (torch.bfloat16, torch.float32)


def conv1x1_dgrad_plain(dy2, w, out_dtype):
    """``dy2 [M, O] @ w [O, I]`` summed in fp32, cast to ``out_dtype``."""
    return (dy2.float() @ w.float()).to(out_dtype)


def tma_fits(dtype, k, n, *ptrs):
    """Whether the TMA + wgmma kernels of ``csrc/gemm_sm90.cu`` take a
    product ``[M, k] @ [k, n]`` of ``dtype`` over tensors at addresses
    ``ptrs``: bf16, ``k`` and ``n`` multiples of 8 (16-byte row strides),
    every tensor 16-byte aligned."""
    return (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and all(p % 16 == 0 for p in ptrs))


def dgrad_kernel_for(dtype, o, i, *ptrs):
    """The kernel that computes a dgrad of ``dtype`` with ``O = o`` and
    ``I = i`` from tensors at addresses ``ptrs``: :data:`CONV1X1_DGRAD`
    where TMA can take it (:func:`tma_fits`), else
    :data:`CONV1X1_DGRAD_CORE`."""
    return CONV1X1_DGRAD if tma_fits(dtype, o, i, *ptrs) \
        else CONV1X1_DGRAD_CORE


def tma_tile_n(m, k, n, sms):
    """N of the TMA kernel's output tile (64, 128 or 256) for ``a [m, k]
    @ b [k, n]`` on ``sms`` SMs.

    Every tile streams its [128, k] rows of a and the [k, N] columns of b
    from L2 and writes [128, N]; the busiest SM runs ``ceil(tiles / sms)``
    of them.  The tile that moves the fewest bytes
    through the busiest SM wins, the wider on a tie (it reads each row
    block of a fewer times).  Up to N = 256 the whole of ``n`` in one tile
    reads a once; at K >= 512 the per-tile traffic of b and the last
    partial wave decide.  (The probe's residual, another [128, N] a tile,
    changes the choice at none of its shapes, so it is not counted.)"""
    best, best_cost = None, None
    for tile in (256, 128, 64):
        if tile > 64 and tile // 2 >= n:
            continue   # a half-empty tile
        tiles = -(-m // _TMA_BM) * -(-n // tile)
        cost = -(-tiles // sms) * (_TMA_BM * k + k * tile + _TMA_BM * tile)
        if best_cost is None or cost < best_cost:
            best, best_cost = tile, cost
    return best


def tma_launch_shape(device, m, k, n):
    """``(tile_n, grid)`` of a launch of a ``csrc/gemm_sm90.cu`` kernel on
    ``device``: :func:`tma_tile_n` and one persistent block an SM, or one
    a tile where there are fewer tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tile_n = tma_tile_n(m, k, n, sms)
    return tile_n, min(-(-m // _TMA_BM) * -(-n // tile_n), sms)


def conv1x1_dgrad(dy2, w, out_dtype):
    """``dx [M, I] = dy2 [M, O] @ w [O, I]`` with fp32 accumulation, stored
    in ``out_dtype`` (the kernel for CUDA tensors, which takes bf16 or fp32
    operands of ``out_dtype``; the plain version for CPU tensors)."""
    if dy2.dim() != 2 or w.dim() != 2 or dy2.shape[1] != w.shape[0]:
        raise MXNetError("conv1x1_dgrad: dy %s and w %s do not chain"
                         % (tuple(dy2.shape), tuple(w.shape)))
    if device_kind((dy2, w)) == "cpu":
        return conv1x1_dgrad_plain(dy2, w, out_dtype)
    if out_dtype not in _DTYPES or dy2.dtype != out_dtype:
        raise MXNetError("conv1x1_dgrad kernel takes bf16 or fp32 operands "
                         "of the output's type, got dy %s, w %s -> %s"
                         % (dy2.dtype, w.dtype, out_dtype))
    m, o = dy2.shape
    i = w.shape[1]
    require("conv1x1_dgrad", dy2, out_dtype)
    require("conv1x1_dgrad", w, out_dtype)
    dx = torch.empty((m, i), dtype=out_dtype, device=dy2.device)
    ptrs = (dy2.data_ptr(), w.data_ptr(), dx.data_ptr())
    kernel = dgrad_kernel_for(out_dtype, o, i, *ptrs)
    if kernel is CONV1X1_DGRAD_CORE:
        kernel.launch(dy2.device, *ptrs, m, o, i,
                      int(out_dtype == torch.bfloat16))
        return dx
    kernel.launch(dy2.device, *ptrs, m, o, i,
                  *tma_launch_shape(dy2.device, m, o, i))
    return dx
