"""Layer norms and the GELU+bias epilogue: CUDA kernels and plain versions.

Counterpart of ``mxnet_tpu/ops/fused/norm_kernels.py`` (``fused_lm_layer_norm``,
``fused_lm_gelu_bias`` and ``fused_layer_norm_op``).  The kernels are in
``csrc/norm_kernels.cu``; the LM layer norm and the epilogue take fp32, the
``LayerNorm`` op's forward fp32, bf16 or fp16 data (fp32 math, the output in
the data's dtype).  :func:`lm_layer_norm`, :func:`lm_gelu_bias` and
:func:`fused_layer_norm_op` run the kernel for a CUDA tensor and the plain
version for a CPU tensor.

Both layer norms run one row-resident kernel body: each row held in
registers by its threads, its statistics by warp shuffles.  The LM layer
norm gives a row four warps, which combine their partial statistics in one
shared-memory exchange, one row a block, gamma and beta loaded beside the
row: one launch shape at every row count the generation lane gives it
(1-8 decode rows, 64-512 prefill rows; ``python -m
mxnet_tpu_torch.tools.lm_layer_norm_ab`` times every shape on the card).
The ``LayerNorm`` op gives a row one warp, eight rows a block.  Rows whose
C is not a multiple of the 16-byte vector or above 256 vectors, or whose
tensors are not 16-byte aligned, take each kernel's first design (one
block a row, two block reductions), which :data:`LM_LAYER_NORM_V1` and
:data:`LAYER_NORM_OP_V1` also run alone so that a run on the card can time
the two designs in turns; no path of the package launches those two.

:func:`layer_norm_op` is the ``LayerNorm`` registry op's differentiable
form: a ``torch.autograd.Function`` whose forward is the kernel (it also
writes each row's mean and 1/std) and whose backward is the plain PyTorch
formula from those statistics.  The JAX package's Pallas LayerNorm has no
gradient rule (``jax.grad`` through it fails to linearize, so its trainer
falls back to the stock op); the port's kernel is on the training path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...base import MXNetError
from .._build import Kernel, device_kind, require

__all__ = ["LAYER_NORM_OP", "LAYER_NORM_OP_V1", "LM_GELU_BIAS", "LM_LAYER_NORM",
           "LM_LAYER_NORM_V1", "fused_layer_norm_op", "layer_norm_op",
           "layer_norm_op_backward", "layer_norm_op_plain", "lm_gelu_bias",
           "lm_gelu_bias_plain", "lm_layer_norm", "lm_layer_norm_plain"]

_LN_EPS = 1e-5   # the JAX package's transformer._LN_EPS

_P = ctypes.c_void_p
LM_LAYER_NORM = Kernel(
    "lm_layer_norm", "norm_kernels", "mxtpu_lm_layer_norm",
    [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float])
# The first LM layer norm kernel (one block a row), with LM_LAYER_NORM's
# arguments: a run on the card times it beside LM_LAYER_NORM; no path of the
# package launches it.
LM_LAYER_NORM_V1 = Kernel(
    "lm_layer_norm_v1", "norm_kernels", "mxtpu_lm_layer_norm_v1",
    [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float])
LM_GELU_BIAS = Kernel(
    "lm_gelu_bias", "norm_kernels", "mxtpu_lm_gelu_bias",
    [_P, _P, _P, ctypes.c_longlong, ctypes.c_int])
LAYER_NORM_OP = Kernel(
    "layer_norm_op", "norm_kernels", "mxtpu_layer_norm_op",
    [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_int])
# The first LayerNorm op kernel (one block a row), fp32, with
# LAYER_NORM_OP's arguments but the dtype: a run on the card times it
# beside LAYER_NORM_OP; no path of the package launches it.
LAYER_NORM_OP_V1 = Kernel(
    "layer_norm_op_v1", "norm_kernels", "mxtpu_layer_norm_op_v1",
    [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float])
_LN_OP_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def layer_norm_op_plain(x, gamma, beta, eps=_LN_EPS):
    """The ``LayerNorm`` op over the last axis → ``(y, mean, rstd)``,
    ``mean``/``rstd`` fp32 ``[rows]``: ``(x - mean) * rsqrt(var + eps) *
    gamma + beta`` in fp32, population variance (``ops/attention.py
    _layer_norm``'s spelling), ``y`` cast back to ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def fused_layer_norm_op(x, gamma, beta, eps=_LN_EPS):
    """``(y, mean, rstd)`` of the ``LayerNorm`` op on ``x [..., C]``, fp32,
    bf16 or fp16, with fp32 ``gamma``/``beta`` (kernel for CUDA tensors,
    :func:`layer_norm_op_plain` for CPU ones).  ``y`` has ``x``'s dtype;
    ``mean`` and ``rstd`` are fp32."""
    if device_kind((x, gamma, beta)) == "cpu":
        return layer_norm_op_plain(x, gamma, beta, eps)
    if x.dtype not in _LN_OP_DTYPES:
        raise MXNetError("layer_norm_op: x must be float32, bfloat16 or "
                         "float16, got %s" % x.dtype)
    require("layer_norm_op", x, x.dtype, align=x.element_size())
    for t in (gamma, beta):
        require("layer_norm_op", t, torch.float32)
    cols = x.shape[-1]
    if gamma.shape != (cols,) or beta.shape != (cols,):
        raise MXNetError("layer_norm_op: gamma/beta %s/%s do not match C=%d"
                         % (tuple(gamma.shape), tuple(beta.shape), cols))
    rows = x.numel() // cols
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    LAYER_NORM_OP.launch(x.device, x.data_ptr(), gamma.data_ptr(),
                         beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
                         rstd.data_ptr(), rows, cols, float(eps),
                         _LN_OP_DTYPES[x.dtype])
    return y, mean, rstd


def layer_norm_op_backward(dy, x, gamma, mean, rstd):
    """``(dx, dgamma, dbeta)`` of the ``LayerNorm`` op from the forward's
    row statistics (plain PyTorch on either device).  The math is fp32
    whatever the dtypes, as autodiff of the JAX op gives it: ``dx`` comes
    out in ``x``'s dtype, ``dgamma`` and ``dbeta`` in ``gamma``'s."""
    cols = x.shape[-1]
    dy, xf, g = dy.float(), x.float(), gamma.float()
    mean = mean.reshape(x.shape[:-1] + (1,))
    rstd = rstd.reshape(x.shape[:-1] + (1,))
    xhat = (xf - mean) * rstd
    dxhat = dy * g
    dgamma = (dy * xhat).reshape(-1, cols).sum(0)
    dbeta = dy.reshape(-1, cols).sum(0)
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


class _LayerNormOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = fused_layer_norm_op(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_op_backward(dy, x, gamma, mean, rstd)
        return dx, dgamma, dbeta, None


def layer_norm_op(x, gamma, beta, eps=_LN_EPS):
    """Differentiable ``LayerNorm`` over the last axis of ``x`` (fp32,
    bf16 or fp16 data, fp32 ``gamma``/``beta``).
    Meta tensors (shape inference) give an empty output of the shape."""
    if x.is_meta:
        return torch.empty_like(x)
    return _LayerNormOp.apply(x.contiguous(), gamma, beta, float(eps))
