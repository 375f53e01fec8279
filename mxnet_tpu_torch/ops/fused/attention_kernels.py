"""Flash attention and paged decode attention: CUDA kernel wrappers.

Counterpart of ``mxnet_tpu/ops/fused/attention_kernels.py``
(``fused_prefill_attention``, ``fused_paged_decode_attention``) and of the
Pallas flash forward and backward of ``mxnet_tpu/ops/attention.py``
(``_flash_fwd_pallas`` with ``return_lse``, ``_flash_bwd_pallas``).  The
kernels are in ``csrc/attention_kernels.cu``; the plain versions, which a
CPU tensor gets, are in :mod:`mxnet_tpu_torch.ops.attention`.

The flash forward and, for D of 32 and 64, the backward's two passes run
every product on the tensor cores in 3xTF32 (each fp32 operand split into
two TF32 parts, three products); at D = 128 the backward runs on the CUDA
cores (:func:`bwd_kernels`).  They reorder the softmax sums (online
softmax over key tiles; the backward sums its gradients tile by tile), so
they agree with the plain versions to rounding, not bitwise; the paged
decode kernel likewise sums in its own order.  ``chip_smoke.py`` prints
the backward's errors against the plain version and, beside the plain
version's own and SDPA's, against a float64 reference.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .. import attention as _att
from .._build import Kernel, device_kind, require

__all__ = ["FLASH_BWD_DKDV", "FLASH_BWD_DKDV_SIMT", "FLASH_BWD_DQ",
           "FLASH_BWD_DQ_SIMT", "FLASH_FWD_SIMT", "FLASH_PREFILL",
           "PAGED_DECODE", "bwd_kernels", "fused_flash_bwd",
           "fused_flash_fwd", "fused_paged_decode_attention",
           "fused_prefill_attention"]

_HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
FLASH_PREFILL = Kernel(
    "flash_prefill", "attention_kernels", "mxtpu_flash_prefill",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F])
# The earlier forward, on CUDA cores (D = 64 only), with
# FLASH_PREFILL's arguments: a run on the card times it beside the
# tensor-core kernel; no path of the package launches it.
FLASH_FWD_SIMT = Kernel(
    "flash_fwd_simt", "attention_kernels", "mxtpu_flash_fwd_simt",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F])
FLASH_BWD_DKDV = Kernel(
    "flash_bwd_dkdv", "attention_kernels", "mxtpu_flash_bwd_dkdv",
    [_P] * 8 + [_I] * 6 + [_F])
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "attention_kernels", "mxtpu_flash_bwd_dq",
    [_P] * 7 + [_I] * 6 + [_F])
# The backward's two passes on CUDA cores, with the arguments above: the
# path for D = 128, where the tensor-core dK/dV pass would need more
# registers than a thread has; a run on the card also times them beside
# the tensor-core kernels.
FLASH_BWD_DKDV_SIMT = Kernel(
    "flash_bwd_dkdv_simt", "attention_kernels", "mxtpu_flash_bwd_dkdv_simt",
    [_P] * 8 + [_I] * 6 + [_F])
FLASH_BWD_DQ_SIMT = Kernel(
    "flash_bwd_dq_simt", "attention_kernels", "mxtpu_flash_bwd_dq_simt",
    [_P] * 7 + [_I] * 6 + [_F])
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
    _check_flash("flash_prefill", q, k, v, same_length=True)
    bsz, heads, t_len, dim = q.shape
    out = torch.empty_like(q)
    FLASH_PREFILL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, bsz, heads, t_len, t_len, dim,
                         1, _att._scale(q, sm_scale))
    return out


def _check_flash(name, q, k, v, same_length=False):
    if q.dim() != 4 or q.shape[-1] not in _HEAD_DIMS:
        raise MXNetError("%s: q must be [B, H, T, D] with D in %s, got %s"
                         % (name, _HEAD_DIMS, tuple(q.shape)))
    kshape = q.shape if same_length else q.shape[:2] + (k.shape[2],) \
        + q.shape[3:]
    require(name, q, torch.float32, align=16)
    for t in (k, v):
        require(name, t, torch.float32, kshape, align=16)


def fused_flash_fwd(q, k, v, causal=True, sm_scale=None):
    """Flash attention forward ``q [B, H, T, D]``, ``k``/``v`` ``[B, H,
    Tk, D]`` → ``(o [B, H, T, D], lse [B, H, T])``, fp32; ``lse`` is the
    natural log of each row's softmax denominator over the scaled scores
    (the backward's input).  ``causal`` masks key ``j`` from query ``i``
    when ``j > i``.

    CPU tensors: :func:`~mxnet_tpu_torch.ops.attention.flash_fwd_plain`.
    CUDA tensors: the flash kernel (contiguous fp32, D in 32/64/128)."""
    if device_kind((q, k, v)) == "cpu":
        return _att.flash_fwd_plain(q, k, v, causal, sm_scale)
    _check_flash("flash_prefill", q, k, v)
    bsz, heads, t_len, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    FLASH_PREFILL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), bsz, heads, t_len,
                         k.shape[2], dim, int(bool(causal)),
                         _att._scale(q, sm_scale))
    return out, lse


def bwd_kernels(head_dim):
    """The backward's ``(dK/dV, dQ)`` kernels for ``head_dim``: the
    tensor-core pair for 32 and 64, the CUDA-core pair for 128."""
    if head_dim == 128:
        return FLASH_BWD_DKDV_SIMT, FLASH_BWD_DQ_SIMT
    return FLASH_BWD_DKDV, FLASH_BWD_DQ


def fused_flash_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Flash attention backward → ``(dq, dk, dv)`` from the forward's
    inputs, its output ``o``, its ``lse`` and the output gradient ``do``.

    CPU tensors: :func:`~mxnet_tpu_torch.ops.attention.flash_bwd_plain`.
    CUDA tensors: ``delta = rowsum(do * o)`` as a torch expression (the
    JAX wrapper also computes it outside its kernels), then the dK/dV
    kernel and the dQ kernel of :func:`bwd_kernels`, each writing only its
    own rows (no atomics: the same inputs give the same bits)."""
    if device_kind((q, k, v, o, lse, do)) == "cpu":
        return _att.flash_bwd_plain(q, k, v, o, lse, do, causal, sm_scale)
    _check_flash("flash_bwd", q, k, v)
    for t in (o, do):
        require("flash_bwd", t, torch.float32, q.shape, align=16)
    require("flash_bwd", lse, torch.float32, q.shape[:3])
    bsz, heads, t_len, dim = q.shape
    tk_len = k.shape[2]
    scale = _att._scale(q, sm_scale)
    delta = (do * o).sum(-1)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (bsz, heads, t_len, tk_len, dim, int(bool(causal)), scale)
    dkdv_kernel, dq_kernel = bwd_kernels(dim)
    dkdv_kernel.launch(q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
    dq_kernel.launch(q.device, *ptrs, dq.data_ptr(), *dims)
    return dq, dk, dv


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
