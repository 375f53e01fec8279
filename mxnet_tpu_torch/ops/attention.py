"""Shape-stable attention for the generation lane: plain versions and the
public entry points.

Counterpart of the generation-lane half of ``mxnet_tpu/ops/attention.py``
(``stable_causal_attention``, ``paged_decode_attention``).  The public
functions run the CUDA kernels of :mod:`.fused.attention_kernels` for CUDA
tensors and the plain versions below for CPU tensors.

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

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
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
