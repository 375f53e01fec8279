"""The 1x1-conv dgrad: CUDA kernel wrapper and plain version.

Counterpart of ``mxnet_tpu/ops/nn.py`` ``_conv1x1_dgrad_pallas``: the input
gradient of a 1x1 stride-1 NHWC convolution, ``dx = dy @ w`` over rows
``M = B*H*W``, as one product with fp32 accumulation.  The kernel is
``conv1x1_dgrad_kernel`` in ``csrc/gemm_kernels.cu`` (a tiled GEMM core
shared with the bottleneck probe's two epilogue kernels).  The registry's
``Convolution`` op calls :func:`conv1x1_dgrad` from its 1x1 backward when
``MXTPU_CONV1X1=pallas`` (``ops/nn.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .._build import Kernel, device_kind, require

__all__ = ["CONV1X1_DGRAD", "conv1x1_dgrad", "conv1x1_dgrad_plain"]

_P = ctypes.c_void_p
CONV1X1_DGRAD = Kernel(
    "conv1x1_dgrad", "gemm_kernels", "mxtpu_conv1x1_dgrad",
    [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int])

# The dtypes the JAX op's 1x1 path is eligible for (nn.py _conv1x1_eligible).
_DTYPES = (torch.bfloat16, torch.float32)


def conv1x1_dgrad_plain(dy2, w, out_dtype):
    """``dy2 [M, O] @ w [O, I]`` summed in fp32, cast to ``out_dtype``."""
    return (dy2.float() @ w.float()).to(out_dtype)


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
    CONV1X1_DGRAD.launch(dy2.device, dy2.data_ptr(), w.data_ptr(),
                         dx.data_ptr(), m, o, i,
                         int(out_dtype == torch.bfloat16))
    return dx
