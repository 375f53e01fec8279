"""Attention: the generation lane's shape-stable entry points, flash
attention with its gradient, and the ``LayerNorm`` and
``MultiHeadAttention`` symbol ops.

Counterpart of ``mxnet_tpu/ops/attention.py``: the generation lane's
``stable_causal_attention`` and ``paged_decode_attention``; the training
path's ``flash_attention`` (a ``torch.autograd.Function`` whose forward is
the flash kernel with its log-sum-exp and whose backward is the dK/dV
kernel, then the dQ kernel, in fp32 or bf16); and the registry ops
``LayerNorm`` and ``MultiHeadAttention``.  The public functions run the
CUDA kernels of :mod:`.fused` for CUDA tensors and the plain versions below
for CPU tensors.

The training path's plain versions (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`) are the textbook spelling with ``torch.matmul``:
they carry no decode contract.  The generation lane's are the ones below.

The plain versions keep the JAX package's promise within the port: the
bits of a query row do not depend on how many query rows ride along or on
how many padded keys follow the valid ones, so on the CPU a decode step
through the paged cache equals the full-sequence forward exactly.  The
scores are a multiply-and-reduce over the head dim (one reduction of
fixed length per score), masked to ``-1e30`` before the row max, and the
softmax stays in fp32.  Two sums run over the key axis, whose length
differs between a prefill and a decode step: the softmax denominator and
P.V.  Torch's CPU ``sum`` groups its terms by the length of the axis (a
pairwise cascade), and its ``matmul`` picks a different kernel for one
query row than for many, so both are spelled as a ``cumsum`` along the key
axis, read at its last element: a sequential sum in key order, to which
masked keys add exact zeros wherever the row ends.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import P, register

__all__ = ["flash_attention", "flash_bwd_plain", "flash_fwd_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "stable_causal_attention", "stable_causal_attention_plain"]

_NEG_INF = -1e30


def _stable_scores(q, k):
    """fp32 ``[B, H, Tq, K]`` scores by multiply-and-reduce over D."""
    return (q.float()[:, :, :, None, :] * k.float()[:, :, None, :, :]).sum(-1)


def _stable_softmax(s):
    """Row softmax of fp32 scores; masked lanes must already be -1e30."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return p / p.cumsum(-1)[..., -1:]


def _stable_pv(p, v):
    """``p [B, H, Tq, K]`` times ``v [B, H, K, D]`` summed in key order."""
    return (p[..., None] * v.float()[:, :, None, :, :]).cumsum(-2)[..., -1, :]


def _scale(q, sm_scale):
    return 1.0 / float(q.shape[-1]) ** 0.5 if sm_scale is None else sm_scale


def stable_causal_attention_plain(q, k, v, sm_scale=None):
    """Exact causal attention on ``[B, H, T, D]``; fp32 out.  ``k`` may be
    longer than ``q`` (a continuation): row ``i`` sees keys up to
    ``i + Tk - Tq``."""
    tq, tk = q.shape[2], k.shape[2]
    s = _stable_scores(q, k) * _scale(q, sm_scale)
    rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    mask = torch.arange(tk, device=q.device)[None, :] <= rows
    s = s.masked_fill(~mask, _NEG_INF)
    return _stable_pv(_stable_softmax(s), v)


def paged_decode_attention_plain(q, k_step, v_step, k_pages, v_pages,
                                 block_tables, context_lens, sm_scale=None):
    """One decode step's attention, K/V gathered through the block table.

    ``q``/``k_step``/``v_step`` ``[B, H, D]``; ``k_pages``/``v_pages``
    ``[num_blocks, block_size, H, D]`` (one layer of the pool);
    ``block_tables`` int ``[B, max_blocks]``, padded with block 0;
    ``context_lens`` int ``[B]`` counting the current token, whose K/V
    comes from ``k_step``/``v_step`` at position ``context_len - 1``.
    Returns fp32 ``[B, H, D]``.
    """
    bsz, max_blocks = block_tables.shape
    blk, heads, dim = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    kmax = max_blocks * blk
    tables = block_tables.long()
    ctx = context_lens.long()
    rows = torch.arange(bsz, device=q.device)
    k = k_pages[tables].reshape(bsz, kmax, heads, dim)   # gather: a copy
    v = v_pages[tables].reshape(bsz, kmax, heads, dim)
    k[rows, ctx - 1] = k_step.to(k.dtype)
    v[rows, ctx - 1] = v_step.to(v.dtype)
    k = k.transpose(1, 2)                                  # [B, H, Kmax, D]
    v = v.transpose(1, 2)
    s = _stable_scores(q[:, :, None, :], k) * _scale(q, sm_scale)
    pos = torch.arange(kmax, device=q.device)
    s = s.masked_fill(pos >= ctx[:, None, None, None], _NEG_INF)
    return _stable_pv(_stable_softmax(s), v)[:, :, 0, :]


def stable_causal_attention(q, k, v, sm_scale=None):
    """Causal self-attention of a prefill, ``[B, H, T, D]`` → fp32.

    CUDA tensors go to the flash prefill kernel; CPU tensors to
    :func:`stable_causal_attention_plain`."""
    from .fused.attention_kernels import fused_prefill_attention

    return fused_prefill_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), sm_scale=sm_scale)


def paged_decode_attention(q, k_step, v_step, k_pages, v_pages,
                           block_tables, context_lens, sm_scale=None):
    """One decode step through the paged cache (see
    :func:`paged_decode_attention_plain` for the shapes).  CUDA tensors go
    to the paged decode kernel, which reads the pages in place."""
    from .fused.attention_kernels import fused_paged_decode_attention

    return fused_paged_decode_attention(
        q.contiguous(), k_step.contiguous(), v_step.contiguous(), k_pages,
        v_pages, block_tables, context_lens, sm_scale=sm_scale)


# ----------------------------------------------------------------------
# flash attention with its gradient (the training path)
# ----------------------------------------------------------------------


# The dtypes the plain versions compute in as they come; any other (bf16,
# fp16) is upcast to fp32 and rounded back where the kernels round.
_WIDE = (torch.float32, torch.float64)


def _up(x):
    """``x`` itself in fp32 or float64, else upcast to fp32 (a 16-bit
    operand of a product with fp32 sums, as the kernels take it)."""
    return x if x.dtype in _WIDE else x.float()


def _flash_scores(q, k, causal, scale):
    """``[B, H, T, Tk]`` scaled scores, fp32 for 16-bit operands (upcast
    before the product) and in the operands' own dtype otherwise; under
    ``causal`` key ``j`` is masked from query ``i`` when ``j > i`` (the JAX
    kernel's mask, with no offset when ``Tk != T``)."""
    s = torch.matmul(_up(q), _up(k).transpose(-1, -2)) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        above = (torch.arange(tk, device=q.device)[None, :]
                 > torch.arange(tq, device=q.device)[:, None])
        s = s.masked_fill(above, _NEG_INF)
    return s


def _rounded(x, dtype):
    """``x`` rounded to a 16-bit ``dtype`` and back to fp32 (``x`` itself
    for fp32 and float64): where the kernels feed a product a bf16
    operand."""
    return x if dtype in _WIDE else x.to(dtype).float()


def flash_fwd_plain(q, k, v, causal=True, sm_scale=None):
    """Exact softmax attention → ``(o, lse)``: ``lse [B, H, T]`` is
    ``m + log(l)`` over the scaled scores, as the JAX package's
    ``_attention_fwd_ref(..., return_lse=True)``.  On bf16 inputs it
    rounds where the Pallas kernel does: the scores and every sum are fp32,
    ``p = exp(s - m)`` is rounded to bf16 before ``p v``, and ``o`` is
    rounded once, after the division; ``lse`` is fp32.  fp32 and float64
    inputs compute in their own dtype throughout."""
    s = _flash_scores(q, k, causal, _scale(q, sm_scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    if q.dtype in _WIDE:
        return torch.matmul(p / l, v), lse
    o = torch.matmul(_rounded(p, q.dtype), v.float()) / l
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """``(dq, dk, dv)`` from the forward's ``lse``: ``p = exp(s - lse)``,
    ``ds = p * (dp - delta) * scale`` with ``delta = rowsum(do * o)``, the
    math of the JAX package's ``_bwd_p_ds``.  On bf16 inputs the products
    take bf16 operands with fp32 sums: ``p`` is rounded to bf16 before
    ``p^T do`` and ``ds`` before ``ds k`` and ``ds^T q``; ``delta`` and
    the softmax are fp32, and the gradients come out in the inputs'
    dtype.  fp32 and float64 inputs compute in their own dtype
    throughout."""
    dtype = q.dtype
    scale = _scale(q, sm_scale)
    qf, kf, vf, dof = _up(q), _up(k), _up(v), _up(do)
    p = torch.exp(_flash_scores(q, k, causal, scale) - lse[..., None])
    dv = torch.matmul(_rounded(p, dtype).transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * _up(o)).sum(-1, keepdim=True)
    ds = _rounded(p * (dp - delta) * scale, dtype)
    return (torch.matmul(ds, kf).to(dtype),
            torch.matmul(ds.transpose(-1, -2), qf).to(dtype), dv.to(dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel with its lse (saved, never recomputed).
    Backward: the dK/dV kernel, then the dQ kernel.  The kernels are those
    of the inputs' dtype (fp32 or bf16); ``do`` arrives in the output's
    dtype and the gradients leave in the inputs'.  Autograd runs the
    backward on its own thread; the kernels launch on the device's current
    stream there, as everywhere."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        from .fused.attention_kernels import fused_flash_fwd

        o, lse = fused_flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        from .fused.attention_kernels import fused_flash_bwd

        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_flash_bwd(q, k, v, o, lse, do.contiguous(),
                                     ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Softmax attention over ``[B, H, T, D]`` tensors (``k``/``v`` may be
    longer or shorter than ``q``), differentiable.  CUDA tensors run the
    flash kernels in both directions; CPU tensors the plain versions.
    Meta tensors (shape inference) give an empty output of the shape."""
    if q.is_meta:
        return torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                           device="meta")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 float(_scale(q, sm_scale)))


# ----------------------------------------------------------------------
# symbol ops: LayerNorm, MultiHeadAttention
# ----------------------------------------------------------------------


@register("LayerNorm", arg_names=["data", "gamma", "beta"],
          params={"axis": P("int", -1), "eps": P("float", 1e-5)})
def _layer_norm(attrs, data, gamma, beta):
    """Layer norm over ``axis``: population variance, ``rsqrt``, affine
    (the JAX op's spelling), with a gradient.  fp32, bf16 or fp16 data with
    fp32 math: ``y`` and the data's gradient in the data's dtype, gamma's
    and beta's in theirs."""
    from .fused.norm_kernels import layer_norm_op

    axis = attrs["axis"] % data.dim()
    if axis == data.dim() - 1:
        return layer_norm_op(data, gamma, beta, attrs["eps"])
    x = data.movedim(axis, -1)
    return layer_norm_op(x, gamma, beta, attrs["eps"]).movedim(-1, axis)


def _mha_input_names(attrs):
    names = ["data", "qkv_weight", "out_weight"]
    if not attrs.get("no_bias", True):
        names += ["qkv_bias", "out_bias"]
    return names


@register("MultiHeadAttention", aliases=["_contrib_MultiHeadAttention"],
          arg_names=["data", "qkv_weight", "out_weight"],
          input_names_fn=_mha_input_names,
          params={"num_heads": P("int", required=True),
                  "causal": P("bool", False),
                  "no_bias": P("bool", True),
                  "context_parallel_axis": P("str", ""),
                  "interpret": P("bool", False)})
def _multi_head_attention(attrs, data, qkv_weight, out_weight,
                          qkv_bias=None, out_bias=None):
    """Self-attention on ``[B, T, C]``: fused QKV projection, flash
    attention, output projection.  Mixed precision as in the JAX op: the
    (fp32) weights and biases are cast to the activations' dtype, so a bf16
    graph projects in bf16 with fp32 master weights; fp16 computes in fp32
    and casts back.  Ring attention over a mesh axis
    (``context_parallel_axis``) is a later slice and raises.
    ``interpret`` (the JAX package's Pallas interpret switch) changes
    nothing here."""
    if attrs["context_parallel_axis"]:
        raise MXNetError("MultiHeadAttention: context_parallel_axis=%r "
                         "(ring attention) is not ported yet"
                         % attrs["context_parallel_axis"])
    out_dtype = data.dtype
    if data.dtype == torch.float16:
        data = data.float()
    dtype = data.dtype

    def cast(w):
        return None if w is None else w.to(dtype)

    b, t, c = data.shape
    h = attrs["num_heads"]
    qkv = F.linear(data, cast(qkv_weight), cast(qkv_bias))
    qkv = qkv.reshape(b, t, 3, h, c // h).permute(2, 0, 3, 1, 4)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=attrs["causal"])
    out = out.transpose(1, 2).reshape(b, t, c)
    return F.linear(out, cast(out_weight), cast(out_bias)).to(out_dtype)
