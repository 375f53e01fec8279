"""Flash attention and paged decode attention: CUDA kernel wrappers.

Counterpart of ``mxnet_tpu/ops/fused/attention_kernels.py``
(``fused_prefill_attention``, ``fused_paged_decode_attention``) and of the
Pallas flash forward and backward of ``mxnet_tpu/ops/attention.py``
(``_flash_fwd_pallas`` with ``return_lse``, ``_flash_bwd_pallas``).  The
kernels are in ``csrc/attention_kernels.cu``; the plain versions, which a
CPU tensor gets, are in :mod:`mxnet_tpu_torch.ops.attention`.

On fp32 inputs the flash forward and, for D of 32 and 64, the backward's
two passes run every product on the tensor cores in 3xTF32 (each fp32
operand split into two TF32 parts, three products); at D = 128 the
backward runs on the CUDA cores (:func:`bwd_kernels`).  They reorder the
softmax sums (online softmax over key tiles; the backward sums its
gradients tile by tile), so they agree with the plain versions to
rounding, not bitwise.  The paged decode kernel (fp32 or bf16 K/V, fp32
math and output) splits each sequence's live pages over
:func:`decode_splits` blocks and merges their partial softmaxes in a fixed
order, so it too sums in its own order, and two calls on the same inputs
give the same bits.  ``chip_smoke.py`` prints
the backward's errors against the plain version and, beside the plain
version's own and SDPA's, against a float64 reference.

On bf16 inputs (the bench LM's training dtype) the flash forward is the
kernel of ``csrc/flash_fwd_bf16_sm90.cu`` and the backward's two passes
those of ``csrc/flash_bwd_bf16_sm90.cu`` (each a TMA producer warp feeding
two wgmma warpgroups through an mbarrier ring; at head dim 128 the first
bf16 kernels of ``csrc/flash_bf16.cu``, :func:`fwd_kernel`,
:func:`bwd_kernels`): one bf16 wgmma per product with fp32 sums, the
softmax in fp32, ``p`` and ``ds`` rounded to bf16 where the Pallas kernels
round them; ``o``, ``dq``, ``dk`` and ``dv`` come out in bf16, ``lse`` in
fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .. import attention as _att
from .._build import Kernel, device_kind, require

__all__ = ["FLASH_BWD_DKDV", "FLASH_BWD_DKDV_BF16", "FLASH_BWD_DKDV_BF16_V1",
           "FLASH_BWD_DKDV_SIMT", "FLASH_BWD_DQ", "FLASH_BWD_DQ_BF16",
           "FLASH_BWD_DQ_BF16_V1", "FLASH_BWD_DQ_SIMT",
           "FLASH_FWD_BF16", "FLASH_FWD_BF16_V1", "FLASH_FWD_SIMT",
           "FLASH_PREFILL", "PAGED_DECODE", "PAGED_DECODE_V1", "bwd_kernels",
           "decode_splits", "fused_flash_bwd", "fused_flash_fwd", "fwd_kernel",
           "fused_paged_decode_attention", "fused_prefill_attention"]

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
# The bf16 flash forward (csrc/flash_fwd_bf16_sm90.cu) and backward pair
# (csrc/flash_bwd_bf16_sm90.cu), each a TMA producer warp and an mbarrier
# ring, head dims 32 and 64, with the fp32 entries' arguments; o, dq, dk, dv
# bf16, lse and delta fp32.
FLASH_FWD_BF16 = Kernel(
    "flash_fwd_bf16", "flash_fwd_bf16_sm90", "mxtpu_flash_fwd_bf16",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F])
FLASH_BWD_DKDV_BF16 = Kernel(
    "flash_bwd_dkdv_bf16", "flash_bwd_bf16_sm90", "mxtpu_flash_bwd_dkdv_bf16",
    [_P] * 8 + [_I] * 6 + [_F])
FLASH_BWD_DQ_BF16 = Kernel(
    "flash_bwd_dq_bf16", "flash_bwd_bf16_sm90", "mxtpu_flash_bwd_dq_bf16",
    [_P] * 7 + [_I] * 6 + [_F])
# The first bf16 forward and backward pair (csrc/flash_bf16.cu), with the
# arguments above: the path for D = 128, which the redesigned kernels do
# not take (the forward's consumers fill the 128 registers ptxas plans
# them in at D = 64, and O of 128 columns takes 32 more; the pair's would
# need more than their 232: dK and dV totals of 64 columns each, S^T, dP^T
# and the P, dS fragments of the accumulation in flight); a run on the
# card also times them beside the redesigned kernels.
FLASH_FWD_BF16_V1 = Kernel(
    "flash_fwd_bf16_v1", "flash_bf16", "mxtpu_flash_fwd_bf16_v1",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F])
FLASH_BWD_DKDV_BF16_V1 = Kernel(
    "flash_bwd_dkdv_bf16_v1", "flash_bf16", "mxtpu_flash_bwd_dkdv_bf16_v1",
    [_P] * 8 + [_I] * 6 + [_F])
FLASH_BWD_DQ_BF16_V1 = Kernel(
    "flash_bwd_dq_bf16_v1", "flash_bf16", "mxtpu_flash_bwd_dq_bf16_v1",
    [_P] * 7 + [_I] * 6 + [_F])
# The dtypes of the flash training kernels.
_FLASH_DTYPES = (torch.float32, torch.bfloat16)
PAGED_DECODE = Kernel(
    "paged_decode", "attention_kernels", "mxtpu_paged_decode",
    [_P] * 10 + [_I] * 7 + [_F])
# The first paged decode kernel (one block per sequence and head), fp32,
# with PAGED_DECODE's arguments up to max_blocks and then the scale: a run
# on the card times it beside PAGED_DECODE; no path of the package
# launches it.
PAGED_DECODE_V1 = Kernel(
    "paged_decode_v1", "attention_kernels", "mxtpu_paged_decode_v1",
    [_P] * 8 + [_I] * 5 + [_F])
_DECODE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks per SM the paged decode's grid aims at, and the fewest keys of a
# full-length table a split may hold.
_DECODE_BLOCKS_PER_SM = 4
_DECODE_MIN_SPLIT_KEYS = 64
_counters = {}


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


def _check_flash(name, q, k, v, same_length=False,
                 dtypes=(torch.float32,)):
    """Raise unless q, k, v are contiguous ``[B, H, T|Tk, D]`` tensors of
    one dtype in ``dtypes``; returns the dtype."""
    if q.dim() != 4 or q.shape[-1] not in _HEAD_DIMS:
        raise MXNetError("%s: q must be [B, H, T, D] with D in %s, got %s"
                         % (name, _HEAD_DIMS, tuple(q.shape)))
    if q.dtype not in dtypes:
        raise MXNetError("%s: q, k, v must be %s, got %s"
                         % (name, " or ".join(str(d)[6:] for d in dtypes),
                            q.dtype))
    kshape = q.shape if same_length else q.shape[:2] + (k.shape[2],) \
        + q.shape[3:]
    require(name, q, q.dtype, align=16)
    for t in (k, v):
        require(name, t, q.dtype, kshape, align=16)
    return q.dtype


def fused_flash_fwd(q, k, v, causal=True, sm_scale=None):
    """Flash attention forward ``q [B, H, T, D]``, ``k``/``v`` ``[B, H,
    Tk, D]`` → ``(o [B, H, T, D], lse [B, H, T])``, ``o`` in the inputs'
    dtype (fp32 or bf16), ``lse`` fp32; ``lse`` is the natural log of each
    row's softmax denominator over the scaled scores (the backward's
    input).  ``causal`` masks key ``j`` from query ``i`` when ``j > i``.

    CPU tensors: :func:`~mxnet_tpu_torch.ops.attention.flash_fwd_plain`.
    CUDA tensors: the flash kernel of their dtype and head dim
    (:func:`fwd_kernel`; contiguous, all of one dtype, D in 32/64/128).
    The bf16 kernel at D 32 and 64 hands out its work from a counter of
    its own on the device, so its launches on one device must not run
    concurrently on two streams."""
    if device_kind((q, k, v)) == "cpu":
        return _att.flash_fwd_plain(q, k, v, causal, sm_scale)
    dtype = _check_flash("flash_prefill", q, k, v, dtypes=_FLASH_DTYPES)
    bsz, heads, t_len, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fwd_kernel(dim, dtype).launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bsz, heads, t_len, k.shape[2], dim, int(bool(causal)),
        _att._scale(q, sm_scale))
    return out, lse


def fwd_kernel(head_dim, dtype=torch.float32):
    """The forward's kernel for ``head_dim`` and the inputs' ``dtype``: on
    fp32 the 3xTF32 prefill kernel; on bf16 the redesigned kernel for 32
    and 64, the first bf16 kernel for 128, which the redesigned one does
    not take."""
    if dtype == torch.float32:
        return FLASH_PREFILL
    return FLASH_FWD_BF16_V1 if head_dim == 128 else FLASH_FWD_BF16


def bwd_kernels(head_dim, dtype=torch.float32):
    """The backward's ``(dK/dV, dQ)`` kernels for ``head_dim`` and the
    inputs' ``dtype``: on bf16 the redesigned pair for 32 and 64, the first
    bf16 pair for 128; on fp32 the tensor-core pair for 32 and 64, the
    CUDA-core pair for 128.  Head dim 128 takes the older kernels because
    the newer ones would need more registers than a thread has there."""
    if dtype == torch.bfloat16:
        if head_dim == 128:
            return FLASH_BWD_DKDV_BF16_V1, FLASH_BWD_DQ_BF16_V1
        return FLASH_BWD_DKDV_BF16, FLASH_BWD_DQ_BF16
    if head_dim == 128:
        return FLASH_BWD_DKDV_SIMT, FLASH_BWD_DQ_SIMT
    return FLASH_BWD_DKDV, FLASH_BWD_DQ


def fused_flash_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Flash attention backward → ``(dq, dk, dv)`` from the forward's
    inputs, its output ``o``, its ``lse`` and the output gradient ``do``.

    CPU tensors: :func:`~mxnet_tpu_torch.ops.attention.flash_bwd_plain`.
    CUDA tensors: ``delta = rowsum(do * o)`` in fp32 as a torch expression
    (the JAX wrapper also computes it outside its kernels, in fp32 from
    bf16 tensors), then the dK/dV kernel and the dQ kernel of
    :func:`bwd_kernels`, each writing only its own rows (no atomics: the
    same inputs give the same bits).  ``q``, ``k``, ``v``, ``o`` and
    ``do`` share one dtype, fp32 or bf16, which the gradients take;
    ``lse`` is fp32."""
    if device_kind((q, k, v, o, lse, do)) == "cpu":
        return _att.flash_bwd_plain(q, k, v, o, lse, do, causal, sm_scale)
    dtype = _check_flash("flash_bwd", q, k, v, dtypes=_FLASH_DTYPES)
    for t in (o, do):
        require("flash_bwd", t, dtype, q.shape, align=16)
    require("flash_bwd", lse, torch.float32, q.shape[:3])
    bsz, heads, t_len, dim = q.shape
    tk_len = k.shape[2]
    scale = _att._scale(q, sm_scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (bsz, heads, t_len, tk_len, dim, int(bool(causal)), scale)
    dkdv_kernel, dq_kernel = bwd_kernels(dim, dtype)
    dkdv_kernel.launch(q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
    dq_kernel.launch(q.device, *ptrs, dq.data_ptr(), *dims)
    return dq, dk, dv


def decode_splits(bsz, heads, max_blocks, block_size, sms):
    """How many blocks share each sequence's live pages in the paged decode
    kernel, from shapes the host knows (the context lengths stay on the
    card): enough that ``bsz * heads * splits`` blocks give each of ``sms``
    SMs about :data:`_DECODE_BLOCKS_PER_SM`, but never so many that a split
    of a full-length table (``max_blocks * block_size`` keys) holds fewer
    than :data:`_DECODE_MIN_SPLIT_KEYS` keys, nor more splits than pages."""
    want = -(-_DECODE_BLOCKS_PER_SM * sms // (bsz * heads))
    cap = max(1, max_blocks * block_size // _DECODE_MIN_SPLIT_KEYS)
    return max(1, min(want, cap, max_blocks))


def _decode_counters(device, n):
    """``n`` or more zeroed uint32 counters on ``device``, kept for the
    process: the kernel leaves them zero.  A larger request allocates
    anew and keeps the old buffer alive, since a captured CUDA graph may
    still point at it."""
    kept = _counters.setdefault(device, [])
    if not kept or kept[-1].numel() < n:
        kept.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return kept[-1]


def fused_paged_decode_attention(q, k_step, v_step, k_pages, v_pages,
                                 block_tables, context_lens, sm_scale=None):
    """One decode step's attention through the block table, fp32
    ``[B, H, D]`` (shapes as in :func:`~mxnet_tpu_torch.ops.attention.
    paged_decode_attention_plain`).

    CUDA tensors: the paged decode kernel reads each sequence's live pages
    in place (``ceil(context_len / block_size)`` of them; table entries
    past those are never read).  ``q``, ``k_step``, ``v_step`` and the
    pools share one dtype, fp32 or bf16 (converted to fp32 as they are
    loaded); ``block_tables`` and ``context_lens`` are int32 on the same
    device; the caller keeps every block id below ``num_blocks`` and every
    context length in ``[1, max_blocks * block_size]`` (the kernel clamps
    the length, it cannot check ids).  Launches on one device share the
    kernel's counters, so they must not run concurrently on two streams.
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
    dtype = k_pages.dtype
    if dtype not in _DECODE_DTYPES:
        raise MXNetError("paged_decode: pools must be float32 or bfloat16, "
                         "got %s" % dtype)
    _, blk, heads, dim = k_pages.shape
    bsz, max_blocks = block_tables.shape
    for t in (q, k_step, v_step):
        require("paged_decode", t, dtype, (bsz, heads, dim), align=16)
    for t in (k_pages, v_pages):
        require("paged_decode", t, dtype, k_pages.shape, align=16)
    require("paged_decode", block_tables, torch.int32)
    require("paged_decode", context_lens, torch.int32, (bsz,))
    scale = 1.0 / float(dim) ** 0.5 if sm_scale is None else float(sm_scale)
    splits = decode_splits(bsz, heads, max_blocks, blk,
                           torch.cuda.get_device_properties(
                               q.device).multi_processor_count)
    out = torch.empty(bsz, heads, dim, dtype=torch.float32, device=q.device)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(bsz * heads * splits * (dim + 2),
                              dtype=torch.float32, device=q.device)
        counters = _decode_counters(q.device, bsz * heads)
    PAGED_DECODE.launch(
        q.device, q.data_ptr(), k_step.data_ptr(), v_step.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), bsz, heads, dim,
        blk, max_blocks, splits, _DECODE_DTYPES[dtype], scale)
    return out
