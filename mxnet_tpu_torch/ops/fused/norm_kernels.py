"""LM layer norm and GELU+bias epilogue: CUDA kernels and plain versions.

Counterpart of ``mxnet_tpu/ops/fused/norm_kernels.py`` (``fused_lm_layer_norm``
and ``fused_lm_gelu_bias``).  The kernels are in ``csrc/norm_kernels.cu``.
:func:`lm_layer_norm` and :func:`lm_gelu_bias` run the kernel for a CUDA
tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...base import MXNetError
from .._build import Kernel, device_kind, require

__all__ = ["LM_GELU_BIAS", "LM_LAYER_NORM", "lm_gelu_bias",
           "lm_gelu_bias_plain", "lm_layer_norm", "lm_layer_norm_plain"]

_LN_EPS = 1e-5   # the JAX package's transformer._LN_EPS

_P = ctypes.c_void_p
LM_LAYER_NORM = Kernel(
    "lm_layer_norm", "norm_kernels", "mxtpu_lm_layer_norm",
    [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float])
LM_GELU_BIAS = Kernel(
    "lm_gelu_bias", "norm_kernels", "mxtpu_lm_gelu_bias",
    [_P, _P, _P, ctypes.c_longlong, ctypes.c_int])


def lm_layer_norm_plain(x, gamma, beta):
    """``(x - mean) / sqrt(var + 1e-5) * gamma + beta`` over the last axis,
    population variance: ``transformer._lm_ln_stock``'s spelling."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + _LN_EPS)
    return y * gamma + beta


def lm_layer_norm(x, gamma, beta):
    """LM layer norm of fp32 ``x [..., C]`` (kernel for CUDA tensors)."""
    if device_kind((x, gamma, beta)) == "cpu":
        return lm_layer_norm_plain(x, gamma, beta)
    for t in (x, gamma, beta):
        require("lm_layer_norm", t, torch.float32)
    cols = x.shape[-1]
    if gamma.shape != (cols,) or beta.shape != (cols,):
        raise MXNetError("lm_layer_norm: gamma/beta %s/%s do not match C=%d"
                         % (tuple(gamma.shape), tuple(beta.shape), cols))
    y = torch.empty_like(x)
    LM_LAYER_NORM.launch(x.device, x.data_ptr(), gamma.data_ptr(),
                         beta.data_ptr(), y.data_ptr(), x.numel() // cols,
                         cols, _LN_EPS)
    return y


def lm_gelu_bias_plain(h, bias):
    """``gelu(h + bias)`` in the tanh form (``jax.nn.gelu``'s default)."""
    return F.gelu(h + bias, approximate="tanh")


def lm_gelu_bias(h, bias):
    """FFN epilogue ``gelu_tanh(h + bias)``, bias over the last axis
    (kernel for CUDA tensors)."""
    if device_kind((h, bias)) == "cpu":
        return lm_gelu_bias_plain(h, bias)
    for t in (h, bias):
        require("lm_gelu_bias", t, torch.float32)
    f = h.shape[-1]
    if bias.shape != (f,):
        raise MXNetError("lm_gelu_bias: bias %s does not match width %d"
                         % (tuple(bias.shape), f))
    out = torch.empty_like(h)
    LM_GELU_BIAS.launch(h.device, h.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), h.numel(), f)
    return out
