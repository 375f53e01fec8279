"""Flash prefill and paged decode attention: CUDA kernel wrappers.

Counterpart of ``mxnet_tpu/ops/fused/attention_kernels.py``
(``fused_prefill_attention``, ``fused_paged_decode_attention``).  The
kernels are in ``csrc/attention_kernels.cu``; the plain versions, which a
CPU tensor gets, are in :mod:`mxnet_tpu_torch.ops.attention`.

The flash kernel reorders the softmax sums (online softmax over key
tiles), so it agrees with the plain version to fp32 rounding, not
bitwise; the paged decode kernel likewise sums in its own order.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .. import attention as _att
from .._build import Kernel, device_kind, require

__all__ = ["FLASH_PREFILL", "PAGED_DECODE", "fused_paged_decode_attention",
           "fused_prefill_attention"]

_HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
FLASH_PREFILL = Kernel(
    "flash_prefill", "attention_kernels", "mxtpu_flash_prefill",
    [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float])
PAGED_DECODE = Kernel(
    "paged_decode", "attention_kernels", "mxtpu_paged_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float])


def fused_prefill_attention(q, k, v, sm_scale=None):
    """Causal self-attention ``[B, H, T, D]`` → fp32 ``[B, H, T, D]``.

    CPU tensors: :func:`~mxnet_tpu_torch.ops.attention.
    stable_causal_attention_plain`.  CUDA tensors: the flash prefill
    kernel, which takes q and k of one length (self-attention prefill),
    contiguous fp32 with D in (32, 64, 128), and raises on anything else.
    """
    if device_kind((q, k, v)) == "cpu":
        return _att.stable_causal_attention_plain(q, k, v, sm_scale=sm_scale)
    if q.dim() != 4 or q.shape[-1] not in _HEAD_DIMS:
        raise MXNetError("flash_prefill: q must be [B, H, T, D] with D in "
                         "%s, got %s" % (_HEAD_DIMS, tuple(q.shape)))
    for t in (q, k, v):
        require("flash_prefill", t, torch.float32, q.shape, align=16)
    bsz, heads, t_len, dim = q.shape
    scale = 1.0 / float(dim) ** 0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    FLASH_PREFILL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), bsz, heads, t_len, dim, scale)
    return out


def fused_paged_decode_attention(q, k_step, v_step, k_pages, v_pages,
                                 block_tables, context_lens, sm_scale=None):
    """One decode step's attention through the block table, fp32
    ``[B, H, D]`` (shapes as in :func:`~mxnet_tpu_torch.ops.attention.
    paged_decode_attention_plain`).

    CUDA tensors: the paged decode kernel reads each sequence's live pages
    in place (``ceil(context_len / block_size)`` of them; table entries
    past those are never read).  ``block_tables`` and ``context_lens`` are
    int32 on the same device; the caller keeps every block id below
    ``num_blocks`` and every context length in ``[1, max_blocks *
    block_size]`` (the kernel clamps the length, it cannot check ids).
    """
    tensors = (q, k_step, v_step, k_pages, v_pages, block_tables,
               context_lens)
    if device_kind(tensors) == "cpu":
        return _att.paged_decode_attention_plain(
            q, k_step, v_step, k_pages, v_pages, block_tables, context_lens,
            sm_scale=sm_scale)
    if k_pages.dim() != 4 or k_pages.shape[-1] not in _HEAD_DIMS:
        raise MXNetError("paged_decode: pages must be [N, blk, H, D] with D "
                         "in %s, got %s" % (_HEAD_DIMS, tuple(k_pages.shape)))
    _, blk, heads, dim = k_pages.shape
    bsz, max_blocks = block_tables.shape
    for t in (q, k_step, v_step):
        require("paged_decode", t, torch.float32, (bsz, heads, dim))
    for t in (k_pages, v_pages):
        require("paged_decode", t, torch.float32, k_pages.shape)
    require("paged_decode", block_tables, torch.int32)
    require("paged_decode", context_lens, torch.int32, (bsz,))
    scale = 1.0 / float(dim) ** 0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    PAGED_DECODE.launch(
        q.device, q.data_ptr(), k_step.data_ptr(), v_step.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), bsz, heads, dim, blk,
        max_blocks, scale)
    return out
