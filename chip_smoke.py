#!/usr/bin/env python3
"""Run mxnet_tpu_torch's serving and training paths once on one NVIDIA card
and check them.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card (``nvidia-smi`` name and power limit) and the versions.
2. Build every CUDA kernel from ``mxnet_tpu_torch/csrc`` (timed; one
   ``nvcc`` per source, all at once).
3. Each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it (the generation lane's; the bench LM training
   step's: q, k, v [8, 16, 2048, 64] causal, the LayerNorm op on
   [8, 2048, 1024], the momentum step over every parameter of the bench
   model; the 1x1-conv dgrad at each of the 12 shapes of the bench ResNet-50
   step in bf16, one fp32 shape and ragged ones; the probe's two epilogue
   GEMMs at its five shapes) and at a ragged shape, with its time, the plain
   version's time, the time of one library call computing the same function
   where there is one, and the least time the card could take (its bound).
   The flash forward and the backward's two passes (3xTF32 on tensor
   cores) are also timed in turns with the earlier CUDA-core kernels, and
   given both bounds (fp32 CUDA cores, 3xTF32 tensor cores; their JSON
   bound is the latter); two backward calls on the same inputs must give
   the same bits, and the backward's errors against float64 are printed
   beside the plain version's and SDPA's, at T 2048 and 4096; the bf16
   dgrad (TMA + wgmma) in turns with the earlier wmma core, shape by
   shape, and each dgrad shape is checked to reach the kernel its shape
   takes.  The LayerNorm op (one warp a row, registers) in fp32, bf16 and
   fp16 at the training shape and at a ragged C, in turns with its first
   design (v1); the paged decode (split over the context, partials merged
   in order) in fp32 and with bf16 pools at the lane's 8 sequences, at
   B 1 and at a context of 1, two calls giving equal bits, in turns with
   its first design (v1).  The bf16 flash forward and backward pair (the
   bench LM's dtype) against their plain versions in bf16 at the training
   shape, at ragged T, Tk != T and head dims 32 and 128 (the bf16 class for
   o, dq, dk, dv; 1e-4 for lse), two backward calls giving equal bits, the
   gradients' errors against float64 at T 512 and 2048, and their times
   beside SDPA's bf16 forward and autograd backward (the latter by CUDA
   events and by its kernels' device time in one profiler window); the
   forward and the backward pair (TMA producer warp, mbarrier ring) in
   turns with the first bf16 forward and pair (v1), which keep head dim
   128, the forward's o and lse bitwise equal to v1's on every shape
   checked.  The earlier kernels kept for these timings must launch on no
   main path.
4. The generation lane at the full width of the LM the repo benches
   (``bench.py``'s transformer: 12 layers, d1024, 16 heads of 64, FFN 4096,
   vocab 32000, seq_len 2048), fp32, random weights from a seed: an
   ``LMBackend`` registered on a ``GenerationScheduler``, warmed up, then 8
   concurrent requests (prompts of 64-512 tokens, 32-64 new tokens each)
   submitted and streamed.  Every request must finish by length with no
   dispatch error, every lane kernel must have launched in that run
   (counts are zeroed just before it and read just after), and for two
   requests each step's logits are held against the full-sequence forward
   at the same position.
5. One ``ShardedTrainer`` step of the LM at full width cut to 2 layers,
   batch 1, T 512, on the card and on the CPU (plain versions) from the
   same ``init(seed=0)`` and batch, in fp32 and in bf16: outputs, weights
   and momenta agree (1e-3 and the bf16 class of each tensor's largest
   value), parameters and momenta fp32 in both.
6. Training the bench LM configuration (12 layers, batch 8, T 2048, SGD
   momentum 0.9, lr 1e-3) through ``get_symbol`` -> ``ShardedTrainer`` ->
   ``init`` -> ``place_batch`` -> ``step_fn``, in bf16 (the bench's dtype:
   fp32 parameters, bf16 activations, the bf16 flash kernels) and then in
   fp32 (the 3xTF32 flash kernels): one warm-up step and 5 timed steps on
   one seeded batch, whose losses must be finite and falling; the flash
   kernels of the dtype once a layer a step and those of the other dtype
   never; step time, tokens/s, peak memory, launches per step and, from
   one profiled step, the card's idle share and its time by kernel group
   and kernel.  Counts are zeroed just before and read just after each.
7. One ``ShardedTrainer`` step of ResNet-50 at full width, 64 px, batch 2,
   fp32, from the same ``init(seed=0)`` and batch: on the card under
   ``MXTPU_CONV1X1`` = pallas, dot and unset, on the CPU in fp32 and
   float64.  Outputs and BatchNorm's moving statistics agree with the CPU's
   fp32 step; weights and momenta of the card's modes (one forward, the
   same ReLU gates) agree with each other; and those of the card and the
   CPU agree on every tensor that no ReLU gate differing between the two
   forwards is computed from.
8. Training the bench ResNet-50 (``bench.py``: 224 px, batch 128, bf16,
   NHWC, s2d stem, SGD momentum 0.9, lr 0.1, wd 1e-4) through
   ``get_symbol`` -> ``ShardedTrainer``, with ``MXTPU_CONV1X1=pallas`` and
   then unset: one warm-up and 5 timed steps each on one seeded batch,
   losses finite and the last below the warm-up's, no NHWC tensor copied
   into row-major order; step time, images/s, peak memory, launches per
   step (the 1x1 dgrad kernel 33 a step under ``pallas``, none unset, and
   never the wmma core), the idle share and time by kernel and by op.
9. The port's bottleneck probe (``mxnet_tpu_torch.tools.bottleneck_probe
   .main``): cuBLAS plus elementwise against the epilogue kernels at its
   five ResNet-50 shapes.
10. One JSON line ``{"kernels": [...]}`` with each kernel's launches (its
    paths'; every kernel must have launched), error and times.
11. The card line again and, last, ``{"ok": true, "device": {...}}``.

It imports only ``mxnet_tpu_torch``, ``torch`` and ``numpy``, and exits
non-zero, printing no result, when CUDA is not available or the package is
not beside it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate, the fp32 rate outside the tensor cores (most fp32 kernels run on CUDA
# cores), the dense TF32 tensor-core rate (the flash forward's 3xTF32: three
# TF32 products for each fp32 one) and the dense bf16 tensor-core rate (the
# bf16 GEMM kernels).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# fp32 tolerance of the JAX package's parity classes (ops/fused/parity.py).
TOL = 2e-5
# The flash kernel sums the softmax in another order (online, over 32-key
# tiles) than the plain version (sequential over all keys): its error grows
# with T, so it is held to 1e-4.
FLASH_TOL = 1e-4
# Decode logits against the full forward: the two run different kernels
# (paged decode vs flash) and sum in different orders through 12 layers.
LOGIT_TOL = 1e-3
# The flash gradients and the LayerNorm op's gradient against their plain
# versions: the gradients sum over all rows (dK, dV, dgamma: 2048 and 16384
# terms) in another order; the JAX package holds its flash gradients to
# the same 1e-4 (tests/test_attention.py).
GRAD_TOL = 1e-4
TRAIN_BATCH = 8            # bench.py's batch on the chip

SEED = 0
CFG = {"num_classes": 32000, "seq_len": 2048, "num_embed": 1024,
       "num_heads": 16, "num_layers": 12}
BLOCK_SIZE = 16
NUM_BLOCKS = 320
PREFILL_BUCKETS = [64, 128, 256, 512]
DECODE_BUCKETS = [1, 2, 4, 8]
PROMPTS = [64, 100, 128, 200, 256, 300, 450, 512]
NEW_TOKENS = [32, 40, 48, 56, 64, 64, 48, 64]
CHECKED = (0, 7)            # requests whose logits meet the full forward
LANE_KERNELS = ("flash_prefill", "paged_decode", "lm_layer_norm",
                "lm_gelu_bias")
# Kernels replaced by a redesign and kept only for the in-turn timings of
# phase 3 (the CUDA-core backward pair and the first bf16 backward pair also
# serve head dim 128, which no main path runs; phase 6 checks they stay off
# the LM path).
EARLIER_KERNELS = ("flash_fwd_simt", "layer_norm_op_v1", "paged_decode_v1",
                   "flash_fwd_bf16_v1", "flash_bwd_dkdv_bf16_v1",
                   "flash_bwd_dq_bf16_v1")


class SmokeError(Exception):
    pass


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Device ms of one ``fn(i)``: ``iters`` calls are captured into a CUDA
    graph and the graph's replay is timed with CUDA events, so the time is
    the card's and not the host's launch rate (a small kernel launched from
    Python back to back measures the latter)."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bounds(nbytes, flops):
    """A flash kernel's two bounds (forward or a backward pass): fp32 on
    CUDA cores, and the fp32-accurate least time on the tensor cores,
    3xTF32 (three TF32 products for each fp32 one, at the TF32 rate):
    ``((ms, by), (ms, by))``."""
    return bound(nbytes, flops), bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)


def in_turns(old, new, iters):
    """Device ms of two versions of one function, timed old, new, new, old
    in one call on one card: ``(old ms, new ms)``, each the mean of its two
    readings."""
    a, b = cuda_ms(old, iters), cuda_ms(new, iters)
    c, d = cuda_ms(new, iters), cuda_ms(old, iters)
    return (a + d) / 2, (b + c) / 2


def simt_flash(q, k, v, causal, with_lse):
    """One launch of the earlier CUDA-core flash forward (kept in the
    library for this comparison only) on q, k, v [B, H, T, D=64]."""
    import torch

    from mxnet_tpu_torch.ops.fused import attention_kernels as ak

    bsz, heads, t_len, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device) if with_lse else None
    ak.FLASH_FWD_SIMT.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bsz, heads, t_len,
        k.shape[2], dim, int(causal), 1.0 / dim ** 0.5)
    return out


def max_err(got, want, tol, name):
    """Hold ``got`` within ``tol`` abs + rel of ``want``; prints the largest
    error and the largest share of the gate any element uses,
    ``|err| / (tol + tol |want|)`` (the gate fails above 1)."""
    diff = (got - want).abs()
    err = diff.max().item()
    share = (diff / (tol + tol * want.abs())).max().item()
    ok = bool(np.isfinite(err)) and share <= 1.0
    print("  %-14s max|err| %.3e  share of gate %.3f  (tolerance %.0e abs "
          "+ rel)" % (name, err, share, tol))
    if not ok:
        raise SmokeError("%s kernel disagrees with its plain version "
                         "(max |err| %.3e)" % (name, err))
    return err


# ----------------------------------------------------------------- phase 3


def check_kernels(dev, cfg):
    """Each kernel against its plain version at the lane's shapes; returns
    the kernel rows of the JSON line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.fused import attention_kernels as ak
    from mxnet_tpu_torch.ops.fused import norm_kernels as nk

    rng = np.random.RandomState(SEED + 1)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    c, heads = cfg["num_embed"], cfg["num_heads"]
    d = c // heads
    t = PREFILL_BUCKETS[-1]
    rows = []

    # LM layer norm, on the largest prefill's [1, T, C] rows
    x, g, b = randn(1, t, c), randn(c), randn(c)
    err = max_err(nk.lm_layer_norm(x, g, b), nk.lm_layer_norm_plain(x, g, b),
                  TOL, "lm_layer_norm")
    nb, by = bound((2 * x.numel() + 2 * c) * 4, 8 * x.numel())
    rows.append({
        "name": "lm_layer_norm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_kernels.cu",
        "replaces": "mxnet_tpu/ops/fused/norm_kernels.py:85",
        "max_abs_err": err,
        "ms": cuda_ms(lambda i: nk.lm_layer_norm(x, g, b), 200),
        "plain_ms": cuda_ms(lambda i: nk.lm_layer_norm_plain(x, g, b), 50),
        "bound_ms": nb, "bound_by": by,
        "library_ms": cuda_ms(
            lambda i: F.layer_norm(x, (c,), g, b, eps=1e-5), 200)})

    # GELU+bias epilogue on the FFN hidden [1, T, 4C]
    h, bias = randn(1, t, 4 * c), randn(4 * c)
    err = max_err(nk.lm_gelu_bias(h, bias), nk.lm_gelu_bias_plain(h, bias),
                  TOL, "lm_gelu_bias")
    nb, by = bound((2 * h.numel() + 4 * c) * 4, 10 * h.numel())
    rows.append({
        "name": "lm_gelu_bias", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_kernels.cu",
        "replaces": "mxnet_tpu/ops/fused/norm_kernels.py:105",
        "max_abs_err": err,
        "ms": cuda_ms(lambda i: nk.lm_gelu_bias(h, bias), 200),
        "plain_ms": cuda_ms(lambda i: nk.lm_gelu_bias_plain(h, bias), 50),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None})   # no one torch call adds the bias and gelus

    # flash prefill at the largest bucket, and a ragged length
    q, k, v = (randn(1, heads, t, d) for _ in range(3))
    err = max_err(ak.fused_prefill_attention(q, k, v),
                  att.stable_causal_attention_plain(q, k, v), FLASH_TOL,
                  "flash_prefill")
    qr, kr, vr = (randn(1, heads, 333, d) for _ in range(3))
    max_err(ak.fused_prefill_attention(qr, kr, vr),
            att.stable_causal_attention_plain(qr, kr, vr), FLASH_TOL,
            "flash T=333")
    pairs = t * (t + 1) // 2
    (nb32, _), (nb, by) = flash_bounds(4 * q.numel() * 4,
                                       4 * d * heads * pairs)
    old_ms, new_ms = in_turns(
        lambda i: simt_flash(q, k, v, True, False),
        lambda i: ak.fused_prefill_attention(q, k, v), 100)
    rows.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/attention_kernels.cu",
        "replaces": "mxnet_tpu/ops/attention.py:281",
        "max_abs_err": err, "ms": new_ms,
        "plain_ms": cuda_ms(
            lambda i: att.stable_causal_attention_plain(q, k, v), 3),
        "bound_ms": nb, "bound_by": by,
        "library_ms": cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 100)})
    print("  [flash_prefill, lane shape [1, %d, %d, %d] causal] 3xTF32 kernel "
          "%.4f ms, the earlier CUDA-core kernel %.4f ms (in turns), SDPA "
          "%.4f ms; bounds: fp32 CUDA cores %.4f ms, 3xTF32 tensor cores "
          "%.4f ms" % (heads, t, d, new_ms, old_ms, rows[-1]["library_ms"],
                       nb32, nb))

    rows.append(check_paged_decode(dev, cfg, randn))
    return rows


def _paged_tables(ctx, max_blocks):
    """Block tables for contexts ``ctx``: distinct live pages from block
    1 on, rows padded with block 0 (the cache's convention)."""
    tables = np.zeros((len(ctx), max_blocks), np.int32)
    nxt = 1
    for i, n in enumerate(ctx):
        used = -(-int(n) // BLOCK_SIZE)
        tables[i, :used] = np.arange(nxt, nxt + used)
        nxt += used
    if nxt > NUM_BLOCKS:
        raise SmokeError("paged check needs %d blocks" % nxt)
    return tables


def check_paged_decode(dev, cfg, randn):
    """Row 4 against its plain version: the lane's 8 sequences in fp32 and
    with bf16 pools and inputs, one sequence alone (B 1), a context of 1;
    two calls give equal bits; the kernel and the first design (v1) timed
    in turns over all layers' pools, as a decode step reads them.  Both
    versions convert bf16 to fp32 and do fp32 math, so every case is held
    to the fp32 tolerance.  Returns the kernel's JSON row."""
    import torch

    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.fused import attention_kernels as ak

    layers, heads = cfg["num_layers"], cfg["num_heads"]
    d = cfg["num_embed"] // heads
    max_blocks = -(-cfg["seq_len"] // BLOCK_SIZE)
    ctx = np.array([p + n for p, n in zip(PROMPTS, NEW_TOKENS)], np.int32)
    bsz = len(ctx)
    k_pages = randn(layers, NUM_BLOCKS, BLOCK_SIZE, heads, d)
    v_pages = randn(layers, NUM_BLOCKS, BLOCK_SIZE, heads, d)
    bt = torch.from_numpy(_paged_tables(ctx, max_blocks)).to(dev)
    cl = torch.from_numpy(ctx).to(dev)
    qd, ks, vs = (randn(bsz, heads, d) for _ in range(3))
    scale = 1.0 / d ** 0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def kernel(args):
        return ak.fused_paged_decode_attention(*args)

    def plain(args):
        return att.paged_decode_attention_plain(*args)

    def v1(args, out):
        q, k_s, v_s, kp, vp, tab, cls = args
        ak.PAGED_DECODE_V1.launch(
            dev, q.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), tab.data_ptr(), cls.data_ptr(), out.data_ptr(),
            tab.shape[0], heads, d, BLOCK_SIZE, tab.shape[1], scale)
        return out

    lane = (qd, ks, vs, k_pages[0], v_pages[0], bt, cl)
    lane16 = tuple(t.to(torch.bfloat16) for t in lane[:5]) + (bt, cl)
    err = max_err(kernel(lane), plain(lane), TOL, "paged_decode")
    max_err(v1(lane, torch.empty_like(qd)), plain(lane), TOL, "paged v1")
    err = max(err, max_err(kernel(lane16), plain(lane16), TOL,
                           "paged bf16"))
    one = tuple(t[7:] for t in lane[:3]) + lane[3:5] + (bt[7:], cl[7:])
    max_err(kernel(one), plain(one), TOL, "paged B=1")
    cases = [("ctx=1", np.array([1, 300], np.int32)),
             ("ctx=17,16", np.array([17, 16], np.int32))]
    for tag, c_ in cases:
        small = tuple(t[:2] for t in lane[:3]) + lane[3:5] + (
            torch.from_numpy(_paged_tables(c_, max_blocks)).to(dev),
            torch.from_numpy(c_).to(dev))
        err = max(err, max_err(kernel(small), plain(small), TOL,
                               "paged " + tag))
    for args, tag in ((lane, "fp32 B=8"), (lane16, "bf16 B=8"),
                      (one, "fp32 B=1")):
        if not torch.equal(kernel(args), kernel(args)):
            raise SmokeError("paged decode (%s): two calls on the same "
                             "inputs differ" % tag)
    print("  paged decode: two calls on the same inputs give equal bits "
          "(fp32 and bf16 at B=8, fp32 at B=1); splits: %d at B=8, %d at "
          "B=1 (%d SMs)" % (ak.decode_splits(bsz, heads, max_blocks,
                                             BLOCK_SIZE, sms),
                            ak.decode_splits(1, heads, max_blocks,
                                             BLOCK_SIZE, sms), sms))

    def layer(args, i):
        return args[:3] + (k_pages[i % layers], v_pages[i % layers]) \
            + args[5:]

    k16, v16 = k_pages.to(torch.bfloat16), v_pages.to(torch.bfloat16)

    def layer16(i):
        return lane16[:3] + (k16[i % layers], v16[i % layers]) + lane16[5:]

    out = torch.empty_like(qd)
    old_ms, new_ms = in_turns(lambda i: v1(layer(lane, i), out),
                              lambda i: kernel(layer(lane, i)), 120)
    old1, new1 = in_turns(lambda i: v1(layer(one, i), out[:1]),
                          lambda i: kernel(layer(one, i)), 120)
    bf16_ms = cuda_ms(lambda i: kernel(layer16(i)), 120)

    def bytes_of(c_, elem):
        ntok = int(c_.sum())
        pages = int(sum(-(-int(n) // BLOCK_SIZE) for n in c_))
        # K and V rows of the pools (the current token's from k_step,
        # v_step), q, the fp32 output, the live table entries, the lengths
        return ((ntok - len(c_)) * heads * d * elem * 2
                + 3 * len(c_) * heads * d * elem + len(c_) * heads * d * 4
                + pages * 4 + len(c_) * 4), 4 * d * heads * ntok

    nb, by = bound(*bytes_of(ctx, 4))
    nb16, _ = bound(*bytes_of(ctx, 2))
    nb1, _ = bound(*bytes_of(ctx[7:], 4))
    print("  [paged_decode, lane shape B=%d ctx %d-%d] kernel %.4f ms, v1 "
          "%.4f ms (in turns, %.2fx); bf16 pools %.4f ms; bounds fp32 %.4f "
          "ms, bf16 %.4f ms" % (bsz, ctx.min(), ctx.max(), new_ms, old_ms,
                                old_ms / new_ms, bf16_ms, nb, nb16))
    print("  [paged_decode, B=1 ctx %d] kernel %.4f ms, v1 %.4f ms (in "
          "turns, %.2fx); bound %.4f ms" % (ctx[7], new1, old1, old1 / new1,
                                            nb1))
    row = {
        "name": "paged_decode", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/attention_kernels.cu",
        "replaces": "mxnet_tpu/ops/fused/attention_kernels.py:117",
        "max_abs_err": err, "ms": new_ms,
        "plain_ms": cuda_ms(lambda i: plain(layer(lane, i)), 12),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None}   # no one torch call reads through a table
    del k_pages, v_pages, k16, v16
    return row


def events_ms(fn, iters, warmup=1):
    """Device ms of one ``fn()`` by CUDA events around ``iters`` calls, for
    calls that a CUDA graph cannot capture (autograd's backward) and that
    last milliseconds, so the host's launch rate does not show."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled_ms(fn, iters, warmup=1):
    """Device ms of one ``fn()`` from one ``torch.profiler`` window: the sum
    of the times of the CUDA kernels that ``iters`` calls ran, over
    ``iters``.  For calls a CUDA graph cannot capture (autograd's backward):
    unlike CUDA events around the calls, it leaves out the gaps between the
    kernels.  None when the profiler saw no CUDA kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def exact(got, want, name):
    """Bitwise agreement (the optimizer step rounds each operation on its
    own in both versions)."""
    err = (got - want).abs().max().item()
    print("  %-14s max|err| %.3e  (bitwise)" % (name, err))
    if not bool((got == want).all().item()):
        raise SmokeError("%s kernel differs from its plain version "
                         "(max |err| %.3e)" % (name, err))
    return err


def float64_errors(inputs, grads, tag):
    """Print the largest error of each ``(dq, dk, dv)`` in ``grads``
    against the float64 gradients of ``inputs`` (q, k, v, do; causal,
    ``flash_fwd_plain`` then ``flash_bwd_plain`` in float64): a control
    reading, not a gate."""
    from mxnet_tpu_torch.ops import attention as att

    q, k, v, do = (x.double() for x in inputs)
    o, lse = att.flash_fwd_plain(q, k, v, True)
    want = att.flash_bwd_plain(q, k, v, o, lse, do, True)
    del q, k, v, do, o, lse
    for name, got in grads.items():
        print("  [%s] %-10s against float64: dq %.3e, dk %.3e, dv %.3e"
              % ((tag, name) + tuple((g.double() - w).abs().max().item()
                                     for g, w in zip(got, want))))


def check_training_kernels(dev, cfg):
    """The training path's kernels against their plain versions at the
    shapes the bench step gives them (batch 8, T 2048, causal, D 64; the
    LayerNorm op on [8, 2048, 1024]; the momentum step over every
    parameter of the bench model), and once more at a ragged shape.
    Returns the kernel rows of the JSON line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.fused import attention_kernels as ak
    from mxnet_tpu_torch.ops.fused import norm_kernels as nk
    from mxnet_tpu_torch.ops.fused import optimizer_kernels as ok_
    from mxnet_tpu_torch.symbol import infer

    rng = np.random.RandomState(SEED + 3)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    b, t = TRAIN_BATCH, cfg["seq_len"]
    heads, c = cfg["num_heads"], cfg["num_embed"]
    d = c // heads
    rows = []

    # flash forward with lse (row 1) and the backward pair (rows 2, 3)
    q, k, v, do = (randn(b, heads, t, d) for _ in range(4))
    o, lse = ak.fused_flash_fwd(q, k, v, True)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, True)
    err_o = max_err(o, o_p, FLASH_TOL, "flash fwd o")
    err_l = max_err(lse, lse_p, FLASH_TOL, "flash fwd lse")
    # the backward kernels and their plain version read the kernel's o and lse
    dq, dk, dv = ak.fused_flash_bwd(q, k, v, o, lse, do, True)
    want = att.flash_bwd_plain(q, k, v, o, lse, do, True)
    err_dq = max_err(dq, want[0], FLASH_TOL, "flash dq")
    err_dk = max_err(dk, want[1], FLASH_TOL, "flash dk")
    err_dv = max_err(dv, want[2], FLASH_TOL, "flash dv")
    # control readings, not gates: SDPA's backward (3xTF32 on the tensor
    # cores too) on the same inputs against the same plain gradients, and
    # the kernels', the plain version's and SDPA's against float64
    q_, k_, v_ = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)
    lib_grads = torch.autograd.grad(lib_out, (q_, k_, v_), do,
                                    retain_graph=True)
    for name, g_, w_ in zip(("dq", "dk", "dv"), lib_grads, want):
        diff = (g_ - w_).abs()
        print("  %-14s max|err| %.3e  share of gate %.3f  (SDPA's backward, "
              "not gated)" % ("sdpa " + name, diff.max().item(),
                              (diff / (FLASH_TOL + FLASH_TOL * w_.abs()))
                              .max().item()))
    float64_errors((q, k, v, do), {"kernels": (dq, dk, dv), "plain fp32": want,
                                   "SDPA": lib_grads}, "T=%d" % t)
    del want, o_p, lse_p, lib_grads
    # twice the training length: the gradients sum over twice as many
    # streamed tiles
    ql, kl, vl, dol = (randn(1, heads, 2 * t, d) for _ in range(4))
    ol, lsel = ak.fused_flash_fwd(ql, kl, vl, True)
    got = ak.fused_flash_bwd(ql, kl, vl, ol, lsel, dol, True)
    want = att.flash_bwd_plain(ql, kl, vl, ol, lsel, dol, True)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        max_err(g_, w_, FLASH_TOL, "%s T=%d" % (name, 2 * t))
    xs = [x.clone().requires_grad_(True) for x in (ql, kl, vl)]
    sdpa = torch.autograd.grad(F.scaled_dot_product_attention(
        *xs, is_causal=True), xs, dol)
    float64_errors((ql, kl, vl, dol), {"kernels": got, "plain fp32": want,
                                       "SDPA": sdpa}, "B=1 T=%d" % (2 * t))
    del ql, kl, vl, dol, ol, lsel, got, want, xs, sdpa
    # ragged, not causal, a scale other than 1/sqrt(D), and Tk != T
    # (batch 8 gives the forward blocks of two warpgroups, batch 1 of one)
    for bq, tq, tk in ((1, 333, 333), (1, 333, 300), (TRAIN_BATCH, 333, 300)):
        qr, dor = randn(bq, heads, tq, d), randn(bq, heads, tq, d)
        kr, vr = randn(bq, heads, tk, d), randn(bq, heads, tk, d)
        orr, lr = ak.fused_flash_fwd(qr, kr, vr, False, 0.3)
        orp, lrp = att.flash_fwd_plain(qr, kr, vr, False, 0.3)
        tag = "B=%d T=%d Tk=%d" % (bq, tq, tk)
        max_err(orr, orp, FLASH_TOL, "fwd o " + tag)
        max_err(lr, lrp, FLASH_TOL, "fwd lse " + tag)
        got = ak.fused_flash_bwd(qr, kr, vr, orr, lr, dor, False, 0.3)
        want = att.flash_bwd_plain(qr, kr, vr, orr, lr, dor, False, 0.3)
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            max_err(g_, w_, FLASH_TOL, "%s %s" % (name, tag))
    # the other head dims: D = 32 on the tensor cores, D = 128 on the
    # CUDA-core pair (ak.bwd_kernels), causal with Tk != T
    for dh in (32, 128):
        qr, dor = randn(2, 4, 150, dh), randn(2, 4, 150, dh)
        kr, vr = randn(2, 4, 130, dh), randn(2, 4, 130, dh)
        orr, lr = ak.fused_flash_fwd(qr, kr, vr, True)
        got = ak.fused_flash_bwd(qr, kr, vr, orr, lr, dor, True)
        want = att.flash_bwd_plain(qr, kr, vr, orr, lr, dor, True)
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            max_err(g_, w_, FLASH_TOL, "%s D=%d" % (name, dh))

    pairs = b * heads * t * (t + 1) // 2
    nbytes = q.numel() * 4
    (nb32, _), (nb, by) = flash_bounds(4 * nbytes + lse.numel() * 4,
                                       4 * d * pairs)
    old_ms, new_ms = in_turns(lambda i: simt_flash(q, k, v, True, True),
                              lambda i: ak.fused_flash_fwd(q, k, v, True), 10)
    rows.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/attention_kernels.cu",
        "replaces": "mxnet_tpu/ops/attention.py:281",
        "max_abs_err": max(err_o, err_l), "ms": new_ms,
        "plain_ms": cuda_ms(lambda i: att.flash_fwd_plain(q, k, v, True), 2),
        "bound_ms": nb, "bound_by": by,
        "library_ms": cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)})
    print("  [flash forward with lse, training shape [%d, %d, %d, %d] causal] "
          "3xTF32 kernel %.4f ms, the earlier CUDA-core kernel %.4f ms (in "
          "turns), SDPA %.4f ms; bounds: fp32 CUDA cores %.4f ms, 3xTF32 "
          "tensor cores %.4f ms" % (b, heads, t, d, new_ms, old_ms,
                                    rows[-1]["library_ms"], nb32, nb))
    # each pass writes only its own rows (no atomics): the same inputs give
    # the same bits
    again = ak.fused_flash_bwd(q, k, v, o, lse, do, True)
    for name, first, second in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        if not torch.equal(first, second):
            raise SmokeError("flash backward: %s differs between two calls "
                             "on the same inputs" % name)
    print("  flash backward: two calls on the same inputs give bitwise-equal "
          "dq, dk, dv")
    del again
    delta = (do * o).sum(-1)
    scale = 1.0 / d ** 0.5
    dims = (b, heads, t, t, d, 1, scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    plain_bwd = cuda_ms(lambda i: att.flash_bwd_plain(q, k, v, o, lse, do,
                                                      True), 2)
    lib_bwd = events_ms(lambda: torch.autograd.grad(
        lib_out, (q_, k_, v_), do, retain_graph=True), 5)
    qa, ka, va = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    print("  [forward + backward, training shape] flash_attention %.4f ms, "
          "scaled_dot_product_attention %.4f ms"
          % (events_ms(lambda: torch.autograd.grad(att.flash_attention(
              qa, ka, va, causal=True), (qa, ka, va), do), 5),
             events_ms(lambda: torch.autograd.grad(
                 F.scaled_dot_product_attention(qa, ka, va, is_causal=True),
                 (qa, ka, va), do), 5)))
    del qa, ka, va

    def launches(kernel, *outs):
        return lambda i: kernel.launch(dev, *ptrs, *outs, *dims)

    kv_out, q_out = (dk.data_ptr(), dv.data_ptr()), (dq.data_ptr(),)
    old_kv, new_kv = in_turns(launches(ak.FLASH_BWD_DKDV_SIMT, *kv_out),
                              launches(ak.FLASH_BWD_DKDV, *kv_out), 10)
    old_q, new_q = in_turns(launches(ak.FLASH_BWD_DQ_SIMT, *q_out),
                            launches(ak.FLASH_BWD_DQ, *q_out), 10)
    (nb32_kv, _), (nb_kv, by_kv) = flash_bounds(
        6 * nbytes + 2 * lse.numel() * 4, 8 * d * pairs)
    (nb32_q, _), (nb_q, by_q) = flash_bounds(
        5 * nbytes + 2 * lse.numel() * 4, 6 * d * pairs)
    print("  [flash backward, training shape] 3xTF32 kernels: dK/dV %.4f ms "
          "+ dQ %.4f ms = %.4f ms; the earlier CUDA-core kernels (in turns): "
          "%.4f + %.4f = %.4f ms; SDPA's autograd backward %.4f ms; bounds: "
          "fp32 CUDA cores %.4f + %.4f ms, 3xTF32 tensor cores %.4f + %.4f "
          "ms" % (new_kv, new_q, new_kv + new_q, old_kv, old_q,
                  old_kv + old_q, lib_bwd, nb32_kv, nb32_q, nb_kv, nb_q))
    rows.append({
        "name": "flash_bwd_dkdv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/attention_kernels.cu",
        "replaces": "mxnet_tpu/ops/attention.py:572",
        "max_abs_err": max(err_dk, err_dv), "ms": new_kv,
        "plain_ms": plain_bwd, "bound_ms": nb_kv, "bound_by": by_kv,
        "library_ms": lib_bwd})
    rows.append({
        "name": "flash_bwd_dq", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/attention_kernels.cu",
        "replaces": "mxnet_tpu/ops/attention.py:596",
        "max_abs_err": err_dq, "ms": new_q,
        "plain_ms": plain_bwd, "bound_ms": nb_q, "bound_by": by_q,
        "library_ms": lib_bwd})
    del q, k, v, do, o, lse, dq, dk, dv, delta, q_, k_, v_, lib_out

    rows.append(check_layer_norm_op(dev, (b, t, c), randn))

    # the momentum step (row 8): per-op on one tensor, then the
    # multi-tensor entry over the bench model's parameter list
    attrs = {"lr": 1e-3, "wd": 1e-4, "momentum": 0.9,
             "rescale_grad": 1.0 / (b * t), "clip_gradient": -1.0}
    w1, g1, m1 = randn(4 * c, c), randn(4 * c, c), randn(4 * c, c)
    clipped = dict(attrs, rescale_grad=1.0, clip_gradient=0.5)
    for at, tag in ((attrs, "sgd_mom_update"), (clipped, "sgd_mom clip")):
        got = ok_.fused_sgd_mom_update(at, w1, g1, m1)
        want = ok_.sgd_mom_update_plain(at, w1, g1, m1)
        exact(got[0], want[0], tag + " w")
        exact(got[1], want[1], tag + " m")
    sym = tfm.get_symbol(**cfg)
    shapes = infer(sym, {"data": (b, t), "softmax_label": (b, t)},
                   {"data": "int32"})[0]
    names = [n for n in sym.list_arguments() if n not in ("data",
                                                          "softmax_label")]
    pshapes = dict(zip(sym.list_arguments(), shapes))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def tree():
        return {n: torch.randn(pshapes[n], device=dev, generator=gen)
                for n in names}

    params, grads, moms = tree(), tree(), tree()
    nparams = sum(p.numel() for p in params.values())
    err = 0.0
    for flag in (True, False):
        okt = torch.tensor(flag, device=dev)
        want = ok_.sgd_mom_tree_stock(attrs, params, grads, moms, okt)
        p2 = {n: t_.clone() for n, t_ in params.items()}
        m2 = {n: t_.clone() for n, t_ in moms.items()}
        ok_.fused_sgd_mom_tree(attrs, p2, grads, m2, okt)
        for n in names:
            err = max(err, (p2[n] - want[0][n]).abs().max().item(),
                      (m2[n] - want[1][n]).abs().max().item())
            if not (torch.equal(p2[n], want[0][n])
                    and torch.equal(m2[n], want[1][n])):
                raise SmokeError("sgd_mom_multi (ok=%s) differs from the "
                                 "plain tree step at %s" % (flag, n))
        print("  sgd_mom_multi  ok=%-5s %d tensors, %d elements: bitwise"
              % (flag, len(names), nparams))
        del want, p2, m2
    table_rows, chunk0 = [], 0
    for n in names:
        table_rows.append((params[n].data_ptr(), grads[n].data_ptr(),
                           moms[n].data_ptr(), params[n].numel(), chunk0))
        chunk0 += -(-params[n].numel() // ok_._CHUNK)
    table = torch.tensor(table_rows, dtype=torch.int64, device=dev)
    scalars = ok_._scalars(attrs)
    nb, by = bound(20 * nparams, 7 * nparams)
    rows.append({
        "name": "sgd_mom_multi", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/optimizer_kernels.cu",
        "replaces": "mxnet_tpu/ops/fused/optimizer_kernels.py:44",
        "max_abs_err": err,
        "ms": cuda_ms(lambda i: ok_.SGD_MOM_MULTI.launch(
            dev, table.data_ptr(), len(names), chunk0, None, *scalars), 10),
        "plain_ms": cuda_ms(lambda i: ok_.sgd_mom_tree_stock(
            attrs, params, grads, moms), 2),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None})   # no one torch call does this update
    print("  [sgd_mom_update per-op entry, [%d, %d]] %.4f ms"
          % (4 * c, c, cuda_ms(lambda i: ok_.fused_sgd_mom_update(
              attrs, w1, g1, m1), 50)))
    return rows


# The bf16 class of the JAX package's parity harness (ops/fused/parity.py):
# the bf16 flash kernels and their plain versions round p and ds to bf16 on
# the way and o, dq, dk, dv once at the end, after sums taken in other
# orders, so a value may land an ulp (2^-8 to 2^-7 of it) apart.
FLASH_BF16_TOL = 2e-2
# The same outputs held, besides, to a gate scaled to the data: two bf16
# ulps of the largest value of the element's own row (a query's o or dq, a
# key's dk or dv), |err| <= 2^-6 max_row |want|.  At the training shape
# most rows of o and dq are averages over hundreds of keys, a few e-2 in
# size, where 2e-2 absolute would pass a result that lost a key tile.  The
# kernels round p against a running row max and the plain version against
# the final one, so one p may land a bf16 ulp apart and move an early row,
# where a few keys carry the sum, by 2^-8 of one term: a share of its
# row's largest value, not of the element's own size.  A row whose
# exact value is 0 (dq of query 0 under causal: one key, so dp = delta) is
# held as a row of 2^-8 of the tensor's RMS, where the kernels' and the plain
# version's fp32 cancellations leave ~1e-8 of noise.
FLASH_BF16_ULPS = 2.0 ** -6


def bf16_share(got, want):
    """The share of the data-scaled gate each element of ``got`` uses
    against ``want`` (the gate fails above 1): ``(largest share, its row's
    largest |want|, the element's |want|)``."""
    import torch

    g, w = got.float(), want.float()
    row = torch.maximum(w.abs().amax(-1, keepdim=True),
                        2.0 ** -8 * w.pow(2).mean().sqrt())
    share = (g - w).abs() / (FLASH_BF16_ULPS * row)
    at = int(share.argmax())
    return (share.flatten()[at].item(),
            row.expand_as(w).flatten()[at].item(), w.abs().flatten()[at].item())


def bf16_err(got, want, name):
    """Hold a bf16 output to its plain version within the bf16 class and
    within the data-scaled gate; returns the largest error."""
    err = max_err(got.float(), want.float(), FLASH_BF16_TOL, name)
    share, row, val = bf16_share(got, want)
    print("  %-14s share of the data-scaled gate %.3f  (2^-6 of the row's "
          "largest |want|; worst at |want| %.3e, row's largest %.3e)"
          % ("", share, val, row))
    if not share <= 1.0:
        raise SmokeError("%s kernel disagrees with its plain version by "
                         "%.3f of the data-scaled gate" % (name, share))
    return err


def gate_control(got, want, name):
    """A planted fault must fail the data-scaled gate: prints the share
    each gate gives ``got`` (a plain version with a tile dropped) against
    ``want`` (the plain version), and raises if the data-scaled gate would
    pass it."""
    g, w = got.float(), want.float()
    parity = ((g - w).abs() / (FLASH_BF16_TOL + FLASH_BF16_TOL * w.abs())
              ).max().item()
    share = bf16_share(got, want)[0]
    print("  control %-18s max|err| %.3e  share of the bf16 class %.3f, "
          "of the data-scaled gate %.3f" % (name, (g - w).abs().max().item(),
                                            parity, share))
    if not share > 1.0:
        raise SmokeError("the data-scaled gate passes %s" % name)


def bf16_fwd_v1(q, k, v, causal, scale=None):
    """One launch of the first bf16 flash forward (kept in the library for
    these comparisons, and for head dim 128): ``(o, lse)``."""
    import torch

    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.fused import attention_kernels as ak

    bsz, heads, t_len, dim = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    ak.FLASH_FWD_BF16_V1.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bsz, heads, t_len, k.shape[2], dim, int(causal),
        att._scale(q, scale))
    return o, lse


def check_bf16_flash(dev, cfg):
    """The bf16 flash forward with lse (row 1) and backward pair (rows 2,
    3), the kernels of the bench LM's own dtype, against their plain
    versions in bf16 at the training shape (batch 8, T 2048, causal, D 64),
    at ragged T, Tk != T and the other head dims, the forward's o and lse
    also against the first bf16 forward's bits; their gradients against
    float64 at T 512 and 2048; their times beside SDPA's in bf16 and, in
    turns, the first bf16 kernels'.  Returns the kernel rows of the JSON
    line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.fused import attention_kernels as ak

    rng = np.random.RandomState(SEED + 5)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).to(bf16)

    b, t = TRAIN_BATCH, cfg["seq_len"]
    heads = cfg["num_heads"]
    d = cfg["num_embed"] // heads

    def check(q, k, v, do, causal, scale, tag):
        """Forward and backward against the plain versions; returns the
        outputs, the plain o and gradients, and the largest errors (o and
        lse, the gradients)."""
        o, lse = ak.fused_flash_fwd(q, k, v, causal, scale)
        if ak.fwd_kernel(q.shape[-1], bf16) is ak.FLASH_FWD_BF16_V1:
            print("  bf16 o, lse %s: the first forward (v1) computes them"
                  % tag)
        else:
            o1, lse1 = bf16_fwd_v1(q, k, v, causal, scale)
            if not (torch.equal(o, o1) and torch.equal(lse, lse1)):
                raise SmokeError("bf16 flash forward %s: o or lse differs "
                                 "from the first forward's bits" % tag)
            print("  bf16 o, lse %s: bitwise equal to the first forward's "
                  "(v1)" % tag)
            del o1, lse1
        o_p, lse_p = att.flash_fwd_plain(q, k, v, causal, scale)
        errs = [bf16_err(o, o_p, "bf16 o " + tag),
                max_err(lse, lse_p, FLASH_TOL, "bf16 lse " + tag)]
        del lse_p
        grads = ak.fused_flash_bwd(q, k, v, o, lse, do, causal, scale)
        want = att.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
            errs.append(bf16_err(g_, w_, "bf16 %s %s" % (name, tag)))
        if not (o.dtype == bf16 and lse.dtype == torch.float32
                and all(g_.dtype == bf16 for g_ in grads)):
            raise SmokeError("bf16 flash: o, dq, dk, dv must be bf16 and "
                             "lse fp32, got %s, %s, %s" % (
                                 o.dtype, lse.dtype,
                                 [g_.dtype for g_ in grads]))
        return o, lse, grads, (o_p, want), errs

    q, k, v, do = (randn(b, heads, t, d) for _ in range(4))
    o, lse, (dq, dk, dv), (o_p, want), errs = check(
        q, k, v, do, True, None, "B=%d T=%d" % (b, t))
    err_o, err_dq, err_dk, err_dv = max(errs[:2]), errs[2], errs[3], errs[4]
    # controls of the gates: the plain versions with the last tile of 64
    # keys dropped (forward, dQ: the last 64 queries lose their last key
    # tile) or of 64 queries dropped (dK, dV: do zeroed there) must fail
    # the data-scaled gate; the bf16 class's share is printed beside it
    cut = (k[:, :, :-64].contiguous(), v[:, :, :-64].contiguous())
    gate_control(att.flash_fwd_plain(q, *cut, True)[0], o_p,
                 "o, a key tile dropped")
    gate_control(att.flash_bwd_plain(q, *cut, o, lse, do, True)[0], want[0],
                 "dq, a key tile dropped")
    do_cut = do.clone()
    do_cut[:, :, -64:] = 0
    for name, g_, w_ in zip(("dk", "dv"), att.flash_bwd_plain(
            q, k, v, o, lse, do_cut, True)[1:], want[1:]):
        gate_control(g_, w_, "%s, a query tile dropped" % name)
    del cut, do_cut, o_p
    again = ak.fused_flash_bwd(q, k, v, o, lse, do, True)
    for name, first, second in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        if not torch.equal(first, second):
            raise SmokeError("bf16 flash backward: %s differs between two "
                             "calls on the same inputs" % name)
    print("  bf16 flash backward: two calls on the same inputs give "
          "bitwise-equal dq, dk, dv")
    del again
    # against float64 (the exact gradients of the bf16 inputs), a control
    # reading, not a gate: the kernels' and the bf16 plain version's largest
    # errors at T 512 and 2048 (they should not grow with T)
    for tl in (512, t):
        xs = (q, k, v, do) if tl == t else tuple(
            x[:, :, :tl].contiguous() for x in (q, k, v, do))
        if tl == t:
            got, plain = (dq, dk, dv), want
        else:
            ol, ll = ak.fused_flash_fwd(*xs[:3], True)
            got = ak.fused_flash_bwd(*xs[:3], ol, ll, xs[3], True)
            plain = att.flash_bwd_plain(*xs[:3], ol, ll, xs[3], True)
        float64_errors(xs, {"kernels": got, "plain bf16": plain},
                       "bf16 B=%d T=%d" % (b, tl))
        del got, plain, xs
    del want
    # ragged, not causal, a scale other than 1/sqrt(D), and Tk != T
    for bq, tq, tk, causal, scale in ((1, 333, 333, False, 0.3),
                                      (1, 333, 300, True, None),
                                      (TRAIN_BATCH, 333, 300, False, None)):
        check(randn(bq, heads, tq, d), randn(bq, heads, tk, d),
              randn(bq, heads, tk, d), randn(bq, heads, tq, d), causal, scale,
              "B=%d T=%d Tk=%d%s" % (bq, tq, tk, " causal" if causal else ""))
    # the other head dims, causal with Tk != T
    for dh in (32, 128):
        check(randn(2, 4, 150, dh), randn(2, 4, 130, dh),
              randn(2, 4, 130, dh), randn(2, 4, 150, dh), True, None,
              "D=%d" % dh)

    pairs = b * heads * t * (t + 1) // 2
    n, nrows = q.numel(), lse.numel()
    scale = 1.0 / d ** 0.5
    delta = (do.float() * o.float()).sum(-1)
    dims = (b, heads, t, t, d, 1, scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    # the forward in turns with the first bf16 forward (v1)
    fwd_v1, fwd_ms = in_turns(
        lambda i: bf16_fwd_v1(q, k, v, True),
        lambda i: ak.fused_flash_fwd(q, k, v, True), 10)
    # the backward pair in turns with the first bf16 pair (v1)
    kv_v1, kv_ms = in_turns(
        lambda i: ak.FLASH_BWD_DKDV_BF16_V1.launch(
            dev, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims),
        lambda i: ak.FLASH_BWD_DKDV_BF16.launch(
            dev, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims), 10)
    q_v1, q_ms = in_turns(
        lambda i: ak.FLASH_BWD_DQ_BF16_V1.launch(
            dev, *ptrs, dq.data_ptr(), *dims),
        lambda i: ak.FLASH_BWD_DQ_BF16.launch(
            dev, *ptrs, dq.data_ptr(), *dims), 10)
    plain_fwd = cuda_ms(lambda i: att.flash_fwd_plain(q, k, v, True), 2)
    plain_bwd = cuda_ms(lambda i: att.flash_bwd_plain(q, k, v, o, lse, do,
                                                      True), 2)
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    q_, k_, v_ = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def lib_grad():
        return torch.autograd.grad(lib_out, (q_, k_, v_), do,
                                   retain_graph=True)

    # SDPA's backward by CUDA events around the calls and by the device
    # time of its kernels (the kernels' own footing: graph replay leaves no
    # gaps between launches); the library column takes the device time
    lib_events = events_ms(lib_grad, 5)
    lib_device = profiled_ms(lib_grad, 5)
    lib_bwd = lib_events if lib_device is None else lib_device
    # bytes: each input read once, each output written once (bf16 tensors,
    # fp32 lse and delta); operations: 2 D per (query, key) pair at or
    # below the diagonal for each product (forward 2, dK/dV 4, dQ 3)
    nb, by = bound(4 * n * 2 + nrows * 4, 4 * d * pairs, PEAK_BF16_FLOPS)
    nb_kv, by_kv = bound(6 * n * 2 + 2 * nrows * 4, 8 * d * pairs,
                         PEAK_BF16_FLOPS)
    nb_q, by_q = bound(5 * n * 2 + 2 * nrows * 4, 6 * d * pairs,
                       PEAK_BF16_FLOPS)
    print("  [bf16 flash, training shape [%d, %d, %d, %d] causal] forward "
          "%.4f ms (v1 in turns %.4f; SDPA %.4f; bound %.4f: shares %.1f%%, "
          "v1 %.1f%%, SDPA %.1f%%)"
          % (b, heads, t, d, fwd_ms, fwd_v1, lib_fwd, nb, 100 * nb / fwd_ms,
             100 * nb / fwd_v1, 100 * nb / lib_fwd))
    print("  [bf16 flash backward, same shape] dK/dV %.4f ms + dQ %.4f ms = "
          "%.4f ms (v1 in turns: %.4f + %.4f = %.4f); bounds %.4f + %.4f "
          "(shares %.1f%% and %.1f%%); SDPA's autograd backward %s ms of "
          "device time (profiler), %.4f ms by CUDA events"
          % (kv_ms, q_ms, kv_ms + q_ms, kv_v1, q_v1, kv_v1 + q_v1, nb_kv,
             nb_q, 100 * nb_kv / kv_ms, 100 * nb_q / q_ms,
             "not measured" if lib_device is None else "%.4f" % lib_device,
             lib_events))
    src = "mxnet_tpu_torch/csrc/flash_fwd_bf16_sm90.cu"
    src_bwd = "mxnet_tpu_torch/csrc/flash_bwd_bf16_sm90.cu"
    rows = [
        {"name": "flash_fwd_bf16", "route": "cuda", "source": src,
         "replaces": "mxnet_tpu/ops/attention.py:281", "max_abs_err": err_o,
         "ms": fwd_ms, "plain_ms": plain_fwd, "bound_ms": nb,
         "bound_by": by, "library_ms": lib_fwd},
        {"name": "flash_bwd_dkdv_bf16", "route": "cuda", "source": src_bwd,
         "replaces": "mxnet_tpu/ops/attention.py:572",
         "max_abs_err": max(err_dk, err_dv), "ms": kv_ms,
         "plain_ms": plain_bwd, "bound_ms": nb_kv, "bound_by": by_kv,
         "library_ms": lib_bwd},
        {"name": "flash_bwd_dq_bf16", "route": "cuda", "source": src_bwd,
         "replaces": "mxnet_tpu/ops/attention.py:596",
         "max_abs_err": err_dq, "ms": q_ms, "plain_ms": plain_bwd,
         "bound_ms": nb_q, "bound_by": by_q, "library_ms": lib_bwd}]
    del q, k, v, do, o, lse, dq, dk, dv, delta, q_, k_, v_, lib_out
    return rows


# bf16 and fp16 outputs against the plain version's: both round one fp32
# value to the dtype, which may land an ulp apart (the JAX package's parity
# classes, ops/fused/parity.py).
LOW_TOL = {"bfloat16": 2e-2, "float16": 2e-3}


def check_layer_norm_op(dev, shape, randn):
    """Row 5 against its plain version at the LM step's ``shape`` in fp32,
    bf16 and fp16 (y, mean and rstd) and at a ragged C; its fp32 gradient
    through the autograd op; the kernel and the first design (v1) timed in
    turns, and ``F.layer_norm`` as the library call.  Returns the kernel's
    JSON row."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.fused import norm_kernels as nk

    c = shape[-1]
    rows = int(np.prod(shape[:-1]))
    x, g, bt, dy = randn(*shape), randn(c), randn(c), randn(*shape)
    y, mean, rstd = nk.fused_layer_norm_op(x, g, bt)
    y_p, mean_p, rstd_p = nk.layer_norm_op_plain(x, g, bt)
    err = max(max_err(y, y_p, TOL, "layer_norm_op"),
              max_err(mean, mean_p, TOL, "ln op mean"),
              max_err(rstd, rstd_p, TOL, "ln op rstd"))
    low = {}
    for name, tol in LOW_TOL.items():
        xlow = x.to(getattr(torch, name))
        got, want = nk.fused_layer_norm_op(xlow, g, bt), \
            nk.layer_norm_op_plain(xlow, g, bt)
        if got[0].dtype != xlow.dtype:
            raise SmokeError("layer_norm_op %s: y is %s" % (name,
                                                            got[0].dtype))
        max_err(got[0].float(), want[0].float(), tol, "ln op " + name)
        max_err(got[1], want[1], TOL, "ln op %s mean" % name)
        max_err(got[2], want[2], TOL, "ln op %s rstd" % name)
        low[name] = xlow
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16, LOW_TOL[
            "bfloat16"])):
        xr = randn(3, 7, 33).to(dt)
        gr, br = randn(33), randn(33)
        got, want = nk.fused_layer_norm_op(xr, gr, br), \
            nk.layer_norm_op_plain(xr, gr, br)
        max_err(got[0].float(), want[0].float(), tol,
                "ln op C=33 %s" % str(dt)[6:])
        max_err(got[2], want[2], TOL, "ln op C=33 %s rstd" % str(dt)[6:])
    xs = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
          bt.clone().requires_grad_(True)]
    got = torch.autograd.grad(nk.layer_norm_op(*xs), xs, dy)
    want = torch.autograd.grad(nk.layer_norm_op_plain(*xs)[0], xs, dy)
    for name, g_, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
        err = max(err, max_err(g_, w_, GRAD_TOL, "ln op " + name))
    del got, want

    y1 = torch.empty_like(x)
    m1, r1 = torch.empty_like(mean), torch.empty_like(rstd)

    def v1(i):
        nk.LAYER_NORM_OP_V1.launch(dev, x.data_ptr(), g.data_ptr(),
                                   bt.data_ptr(), y1.data_ptr(),
                                   m1.data_ptr(), r1.data_ptr(), rows, c,
                                   1e-5)

    v1(0)
    max_err(y1, y_p, TOL, "ln op v1")
    old_ms, new_ms = in_turns(v1, lambda i: nk.fused_layer_norm_op(
        x, g, bt), 50)
    lib_ms = cuda_ms(lambda i: F.layer_norm(x, (c,), g, bt, eps=1e-5), 50)
    # one more turn: the library call, then the kernel
    new2 = cuda_ms(lambda i: nk.fused_layer_norm_op(x, g, bt), 50)

    def bytes_of(elem):
        return (2 * x.numel() * elem + 2 * c * 4 + 2 * rows * 4,
                8 * x.numel())

    nb, by = bound(*bytes_of(4))
    print("  [layer_norm_op, x %s fp32] kernel %.4f ms (%.4f after "
          "F.layer_norm), v1 %.4f ms (in turns, %.2fx), F.layer_norm %.4f "
          "ms; bound %.4f ms (%.0f%% of it)"
          % (list(shape), new_ms, new2, old_ms, old_ms / new_ms, lib_ms, nb,
             100 * nb / new_ms))
    nb16, _ = bound(*bytes_of(2))
    for name, xlow in low.items():
        gl, bl = g.to(xlow.dtype), bt.to(xlow.dtype)
        k_ms = cuda_ms(lambda i: nk.fused_layer_norm_op(xlow, g, bt), 50)
        l_ms = cuda_ms(lambda i: F.layer_norm(xlow, (c,), gl, bl,
                                              eps=1e-5), 50)
        print("  [layer_norm_op, x %s %s] kernel %.4f ms, F.layer_norm "
              "(%s gamma, beta) %.4f ms; bound %.4f ms (%.0f%% of it)"
              % (list(shape), name, k_ms, name, l_ms, nb16,
                 100 * nb16 / k_ms))
    row = {
        "name": "layer_norm_op", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_kernels.cu",
        "replaces": "mxnet_tpu/ops/fused/norm_kernels.py:54",
        "max_abs_err": err, "ms": new_ms,
        "plain_ms": cuda_ms(lambda i: nk.layer_norm_op_plain(x, g, bt), 10),
        "bound_ms": nb, "bound_by": by, "library_ms": lib_ms}
    print("  [layer_norm_op backward, plain PyTorch from the row stats] "
          "%.4f ms" % events_ms(lambda: nk.layer_norm_op_backward(
              dy, x, g, mean, rstd), 10))
    xl = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
          bt.clone().requires_grad_(True)]
    print("  [forward + backward] layer_norm_op %.4f ms, F.layer_norm %.4f ms"
          % (events_ms(lambda: torch.autograd.grad(
              nk.layer_norm_op(*xs), xs, dy), 10),
             events_ms(lambda: torch.autograd.grad(F.layer_norm(
                 xl[0], (c,), xl[1], xl[2], eps=1e-5), xl, dy), 10)))
    return row


# The 1x1-conv dgrads of one bench ResNet-50 step (batch 128, 224 px, NHWC):
# (M = B*H*W, O, I) and launches a step.  conv1 and conv3 of every unit and
# stage 1's shortcut are 1x1 stride 1; conv1 of a stage's first unit runs at
# the stage's input resolution.
DGRAD_SHAPES = [((401408, 64, 64), 1), ((401408, 256, 64), 4),
                ((401408, 64, 256), 2), ((401408, 128, 256), 1),
                ((100352, 512, 128), 4), ((100352, 128, 512), 3),
                ((100352, 256, 512), 1), ((25088, 1024, 256), 6),
                ((25088, 256, 1024), 5), ((25088, 512, 1024), 1),
                ((6272, 2048, 512), 3), ((6272, 512, 2048), 2)]
# bf16 GEMMs against their plain versions: both sum in fp32 and round once
# to bf16, in other orders, so they may differ by an ulp of the output
# (2^-8 relative).
BF16_TOL = 1e-2
# fp32 GEMMs: sums of up to 2048 products in other orders.
GEMM_F32_TOL = 1e-4


def rel_err(got, want, tol, name):
    """Max |got - want| over max |want|, held to ``tol`` (for sums whose
    terms cancel, where an elementwise relative bound means nothing)."""
    err = ((got.double() - want.double()).abs().max()
           / want.double().abs().max().clamp_min(1e-30)).item()
    print("  %-14s max|err| / max|want| %.3e  (tolerance %.0e)"
          % (name, err, tol))
    if not np.isfinite(err) or err > tol:
        raise SmokeError("%s kernel disagrees with its plain version (%.3e "
                         "of the largest value)" % (name, err))
    return err


def check_gemm_kernels(dev):
    """Rows 9-11: the 1x1-conv dgrad at every dgrad shape of the bench
    ResNet-50 step (bf16), at an fp32 shape and at ragged ones; the
    probe's two epilogue kernels at its five shapes.  Returns the kernel
    rows of the JSON line: row 9's times are summed over one step's 33
    dgrads, rows 10-11's over one call at each probe shape."""
    import torch

    from mxnet_tpu_torch.ops.fused import conv_kernels as ck
    from mxnet_tpu_torch.tools import bottleneck_probe as bp

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    tot = {"ms": 0.0, "core_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    err9 = 0.0

    def dgrad_by(kernel, dy, w, dt):
        """The wrapper's dx, checking that ``kernel`` (and only it) ran."""
        before = (ck.CONV1X1_DGRAD.launches, ck.CONV1X1_DGRAD_CORE.launches)
        dx = ck.conv1x1_dgrad(dy, w, dt)
        after = (ck.CONV1X1_DGRAD.launches, ck.CONV1X1_DGRAD_CORE.launches)
        want = tuple(b + (k is kernel) for b, k in zip(
            before, (ck.CONV1X1_DGRAD, ck.CONV1X1_DGRAD_CORE)))
        if after != want:
            raise SmokeError("dgrad %s %s: launches went %s -> %s, not to %s"
                             % (tuple(dy.shape) + (w.shape[1],), dt, before,
                                after, kernel.name))
        return dx

    def core(dy, w):
        """The cp.async + wmma core on a bf16 dgrad the TMA kernel takes
        (for the in-turn comparison only)."""
        m, o = dy.shape
        dx = torch.empty((m, w.shape[1]), dtype=bf, device=dev)
        ck.CONV1X1_DGRAD_CORE.launch(dev, dy.data_ptr(), w.data_ptr(),
                                     dx.data_ptr(), m, o, w.shape[1], 1)
        return dx

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("  [conv1x1_dgrad, bf16: (M, O, I) x launches a step, tile N: TMA + "
          "wgmma kernel / the earlier wmma core (in turns) / plain / "
          "torch.matmul / bound ms]")
    for (m, o, i), n in DGRAD_SHAPES:
        dy, w = randn(m, o), randn(o, i, scale=0.07)
        err9 = max(err9, max_err(dgrad_by(ck.CONV1X1_DGRAD, dy, w, bf),
                                 ck.conv1x1_dgrad_plain(dy, w, bf),
                                 BF16_TOL, "dgrad %d" % m))
        tc, t = in_turns(lambda j: core(dy, w),
                         lambda j: ck.conv1x1_dgrad(dy, w, bf), 20)
        tp = cuda_ms(lambda j: ck.conv1x1_dgrad_plain(dy, w, bf), 3)
        tl = cuda_ms(lambda j: torch.matmul(dy, w), 20)
        nbytes, flops = (m * o + o * i + m * i) * 2, 2 * m * o * i
        nb, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        print("    (%d, %d, %d) x%d, N %d: %.4f / %.4f / %.4f / %.4f / %.4f "
              "(%s)" % (m, o, i, n, ck.tma_tile_n(m, o, i, sms), t, tc, tp,
                        tl, nb, by))
        for k, v in (("ms", t), ("core_ms", tc), ("plain_ms", tp),
                     ("library_ms", tl), ("bound_ms", nb)):
            tot[k] += n * v
        tot["bytes_ms" if by == "bytes" else "ops_ms"] += n * nb
        del dy, w
    print("    a step's 33 dgrads: TMA + wgmma %.4f ms, the earlier wmma core "
          "%.4f ms, torch.matmul %.4f ms, bound %.4f ms"
          % (tot["ms"], tot["core_ms"], tot["library_ms"], tot["bound_ms"]))
    # ragged shapes, each with the kernel its shape takes: fp32 (the core's
    # CUDA cores); M no multiple of 128, K no multiple of 64, N no multiple
    # of 64 and a tile with a chunk wholly past N (TMA); K and N no multiple
    # of 8 (the core's scalar path)
    for (m, o, i), dt, kern in (
            ((25088, 256, 1024), torch.float32, ck.CONV1X1_DGRAD_CORE),
            ((1000, 64, 256), bf, ck.CONV1X1_DGRAD),
            ((4097, 200, 72), bf, ck.CONV1X1_DGRAD),
            ((50000, 96, 192), bf, ck.CONV1X1_DGRAD),
            ((999, 60, 36), bf, ck.CONV1X1_DGRAD_CORE),
            ((777, 33, 65), torch.float32, ck.CONV1X1_DGRAD_CORE)):
        dy, w = randn(m, o, dtype=dt), randn(o, i, scale=0.07, dtype=dt)
        tol = BF16_TOL if dt == bf else GEMM_F32_TOL
        max_err(dgrad_by(kern, dy, w, dt), ck.conv1x1_dgrad_plain(dy, w, dt),
                tol, "dgrad %d %s" % (m, str(dt)[6:]))
        if (m, o, i) == (25088, 256, 1024):
            nb, by = bound((m * o + o * i + m * i) * 4, 2 * m * o * i)
            print("    fp32 (%d, %d, %d): kernel %.4f ms, plain %.4f ms, "
                  "torch.matmul %.4f ms, bound %.4f ms (%s)"
                  % (m, o, i, cuda_ms(lambda j: ck.conv1x1_dgrad(dy, w, dt),
                                      10),
                     cuda_ms(lambda j: ck.conv1x1_dgrad_plain(dy, w, dt), 3),
                     cuda_ms(lambda j: torch.matmul(dy, w), 10), nb, by))
    rows = [{
        "name": "conv1x1_dgrad", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/gemm_sm90.cu",
        "replaces": "mxnet_tpu/ops/nn.py:94", "max_abs_err": err9,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
        else "operations",
        "library_ms": tot["library_ms"]}]

    # rows 10-11 at the probe's shapes: A (res, ReLU), A without res, B
    # (dy @ w^T + dres, no ReLU), B without res; and the product + stats
    epi = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0}
    st = dict(epi)

    def add_bound(d, nbytes, flops):
        nb, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        d["bound_ms"] += nb
        d["bytes_ms" if by == "bytes" else "ops_ms"] += nb

    for name, m, k, n in bp.SHAPES:
        x, w = randn(m, k), randn(k, n, scale=0.05)
        scale = torch.rand(n, generator=gen, device=dev) + 0.5
        bias = torch.randn(n, generator=gen, device=dev)
        res = randn(m, n)
        for r_, relu in ((res, True), (None, True)):
            epi["err"] = max(epi["err"], max_err(
                bp.mm_epilogue(x, w, scale, bias, r_, relu),
                bp.mm_epilogue_plain(x, w, scale, bias, r_, relu), BF16_TOL,
                "A %s%s" % (name, "" if r_ is not None else " no res")))
        dy, dres, wt = randn(m, n), randn(m, k), w.t().contiguous()
        ones = torch.ones(k, device=dev)
        zeros = torch.zeros(k, device=dev)
        for r_ in (dres, None):
            epi["err"] = max(epi["err"], max_err(
                bp.mm_epilogue(dy, wt, ones, zeros, r_, False),
                bp.mm_epilogue_plain(dy, wt, ones, zeros, r_, False),
                BF16_TOL, "B %s%s" % (name, "" if r_ is not None
                                      else " no res")))
        y, s1, s2 = bp.mm_with_stats(x, w)
        y0, t1, t2 = bp.mm_with_stats_plain(x, w)
        st["err"] = max(st["err"], max_err(y, y0, BF16_TOL, "C y " + name),
                        rel_err(s1, t1, GRAD_TOL, "C sum " + name),
                        rel_err(s2, t2, GRAD_TOL, "C sum^2 " + name))
        epi["ms"] += cuda_ms(lambda j: bp.mm_epilogue(
            x, w, scale, bias, res, True), 20)
        epi["plain_ms"] += cuda_ms(lambda j: bp.mm_epilogue_plain(
            x, w, scale, bias, res, True), 3)
        add_bound(epi, (m * k + k * n + 2 * m * n) * 2 + 8 * n,
                  2 * m * k * n + 4 * m * n)
        st["ms"] += cuda_ms(lambda j: bp.mm_with_stats(x, w), 20)
        st["plain_ms"] += cuda_ms(lambda j: bp.mm_with_stats_plain(x, w), 3)
        add_bound(st, (m * k + k * n + m * n) * 2 + 8 * n,
                  2 * m * k * n + 3 * m * n)
        del x, w, res, dy, dres, wt, y, y0
    for nm, d, src in (("mm_epilogue", epi, ":112"),
                       ("mm_with_stats", st, ":153")):
        rows.append({
            "name": nm, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/gemm_kernels.cu",
            "replaces": "tools/bottleneck_probe.py" + src,
            "max_abs_err": d["err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": "bytes" if d["bytes_ms"] >= d["ops_ms"]
            else "operations",
            "library_ms": None})   # no one torch call fuses the epilogue
    return rows

# ----------------------------------------------------------------- phase 4


class LaneRecorder(object):
    """Wraps a backend's prefill/decode and its cache's allocate/free on
    the instance, to keep each step's logits and which sequence each row
    belonged to."""

    def __init__(self, backend):
        self.log = []
        self.prefill_ms = []
        cache = backend.cache
        prefill, decode = backend.prefill, backend.decode
        allocate, free = cache.allocate, cache.free

        def rec_prefill(tokens, length):
            t0 = time.perf_counter()
            out = prefill(tokens, length)   # logits come back: synced
            self.prefill_ms.append((length, (time.perf_counter() - t0) * 1e3))
            self.log.append(("prefill", out[0].copy()))
            return out

        def rec_decode(tokens, positions, tables, context):
            out = decode(tokens, positions, tables, context)
            self.log.append(("decode", np.array(tables), np.array(positions),
                             out[0].copy()))
            return out

        def rec_allocate(seq_id, num_tokens):
            allocate(seq_id, num_tokens)
            self.log.append(("alloc", seq_id,
                             cache.block_table(seq_id,
                                               backend.max_blocks_per_seq)))

        def rec_free(seq_id):
            self.log.append(("free", seq_id))
            return free(seq_id)

        backend.prefill, backend.decode = rec_prefill, rec_decode
        cache.allocate, cache.free = rec_allocate, rec_free

    def logits_of(self, seq_id):
        """``[(position of the input token, logits row)]`` of one sequence:
        its prefill's last row, then one row per decode step."""
        out, table, live = [], None, False
        for ev in self.log:
            if ev[0] == "alloc" and ev[1] == seq_id:
                table, live = ev[2], True
            elif ev[0] == "free" and ev[1] == seq_id:
                live = False
            elif live and ev[0] == "prefill" and not out:
                out.append((None, ev[1]))
            elif live and ev[0] == "decode":
                tables, positions, logits = ev[1:]
                # padded rows sit at position 0, live ones never do
                hit = np.where((tables == table).all(axis=1)
                               & (positions > 0))[0]
                if len(hit) != 1:
                    raise SmokeError("sequence %s in %d rows of a step"
                                     % (seq_id, len(hit)))
                out.append((int(positions[hit[0]]), logits[hit[0]]))
        return out


def run_slice(dev, cfg, prompts, new_tokens, num_blocks, prefill_buckets,
              decode_buckets, checked, card):
    import torch

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.serving import GenerationScheduler, LMBackend

    t0 = time.perf_counter()
    params = tfm.init_lm_params(cfg, seed=SEED)
    nparams = sum(a.size for a in params.values())
    print("  params: %d (%.2f GB fp32), drawn in %.1f s"
          % (nparams, nparams * 4 / 1e9, time.perf_counter() - t0))
    rng = np.random.RandomState(SEED + 2)
    prompt_ids = [rng.randint(0, cfg["num_classes"], size=n).astype(np.int32)
                  for n in prompts]

    reset_launch_counts()
    # -- the main path: entry points a user calls ------------------------
    backend = LMBackend(params, cfg, block_size=BLOCK_SIZE,
                        num_blocks=num_blocks, device=dev)
    sched = GenerationScheduler()
    sched.register("lm", backend, decode_buckets=decode_buckets,
                   prefill_buckets=prefill_buckets)
    t0 = time.perf_counter()
    sched.warmup("lm")
    print("  warmup: %.1f ms" % ((time.perf_counter() - t0) * 1e3))
    rec = LaneRecorder(backend)
    stamps = [[] for _ in prompts]

    def stream(i, req):
        for _ in req.tokens(timeout=300):
            stamps[i].append(time.perf_counter())

    t_submit = time.perf_counter()
    reqs = [sched.submit("lm", p, max_new_tokens=n)
            for p, n in zip(prompt_ids, new_tokens)]
    threads = [threading.Thread(target=stream, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    t_end = time.perf_counter()
    if any(th.is_alive() for th in threads):
        raise SmokeError("requests still streaming after 600 s")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    # -- end of the main path -------------------------------------------
    stats = sched.stats("lm")
    sched.close()
    for i, r in enumerate(reqs):
        if r.error is not None or r.finish_reason != "length" \
                or len(r.generated) != new_tokens[i]:
            raise SmokeError("request %d: finish %r, %d tokens, error %r"
                             % (i, r.finish_reason, len(r.generated),
                                r.error))
    if stats["dispatch_errors"]:
        raise SmokeError("lane counted %d dispatch errors"
                         % stats["dispatch_errors"])
    print("  lane: %d requests, %d decode steps, %d tokens, occupancy %.3f,"
          " dispatch errors %d" % (stats["requests"], stats["steps"],
                                   stats["tokens"], stats["occupancy"],
                                   stats["dispatch_errors"]))
    print("  launches in the run: %s" % json.dumps(counts))
    missing = [n for n in LANE_KERNELS if counts[n] == 0]
    if dev.type == "cuda" and missing:
        raise SmokeError("kernels never launched on the main path: %s"
                         % missing)

    total = sum(len(s) for s in stamps)
    gaps = np.concatenate([np.diff(s) for s in stamps if len(s) > 1]) * 1e3
    ttft = [(s[0] - t_submit) * 1e3 for s in stamps]
    pre = [ms for _, ms in rec.prefill_ms]
    print("  [%s] prefill ms per request: mean %.2f, max %.2f (%s)"
          % (card, np.mean(pre), np.max(pre),
             ", ".join("T=%d %.2f" % lm for lm in rec.prefill_ms)))
    print("  [%s] tokens/s %.1f (%d tokens of %d requests in %.3f s)"
          % (card, total / (t_end - t_submit), total, len(reqs),
             t_end - t_submit))
    print("  [%s] inter-token ms p50 %.3f p99 %.3f; first token ms max %.1f"
          % (card, np.percentile(gaps, 50), np.percentile(gaps, 99),
             max(ttft)))

    # decode logits against the full-sequence forward
    worst, diffs = 0.0, 0
    for i in checked:
        r = reqs[i]
        seq = rec.logits_of(r.seq_id)
        full = np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                    np.int32)])
        tokens = torch.from_numpy(full.astype(np.int64))[None].to(dev)
        ref = tfm.lm_prefill(backend.params, tokens, cfg)[0][0].cpu().numpy()
        if len(seq) != len(r.generated):
            raise SmokeError("request %d: %d logit rows for %d tokens"
                             % (i, len(seq), len(r.generated)))
        for j, (pos, row) in enumerate(seq):
            at = len(r.prompt) - 1 + j
            if pos is not None and pos != at:
                raise SmokeError("request %d step %d at position %d, not %d"
                                 % (i, j, pos, at))
            err = float(np.abs(row - ref[at]).max())
            worst = max(worst, err)
            if not np.isfinite(row).all() or err > LOGIT_TOL:
                raise SmokeError("request %d step %d: decode logits differ "
                                 "from the full forward by %.3e"
                                 % (i, j, err))
            best = int(np.argmax(ref[at]))
            if best != r.generated[j]:
                diffs += 1
                gap = float(ref[at][best] - ref[at][r.generated[j]])
                if gap > LOGIT_TOL:
                    raise SmokeError("request %d step %d: greedy token %d, "
                                     "full forward %d by a gap of %.3e"
                                     % (i, j, r.generated[j], best, gap))
    print("  decode vs full forward (requests %s): max |logit diff| %.3e "
          "(tolerance %.0e), greedy tokens differing: %d"
          % (list(checked), worst, LOGIT_TOL, diffs))
    if dev.type == "cuda":
        decode_breakdown(backend, reqs, card)
    return counts


def decode_breakdown(backend, reqs, card):
    """Where one full decode step (8 rows) goes: its host wall time
    against the card's time for the same step, taken by replaying the
    step's kernels as one CUDA graph (so no host gap is counted), and the
    step's kernels by device time from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.models import transformer as tfm

    bsz, cfg = len(reqs), backend.cfg
    seqs = ["__timing%d" % i for i in range(bsz)]
    tables, ctx = [], []
    for s, r in zip(seqs, reqs):
        n = len(r.prompt) + len(r.generated)
        backend.cache.allocate(s, n)
        tables.append(backend.cache.block_table(s, backend.max_blocks_per_seq))
        ctx.append(n)
    ctx = np.asarray(ctx, np.int32)
    args = (np.zeros(bsz, np.int32), ctx - 1, np.stack(tables), ctx)
    for _ in range(3):
        backend.decode(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        backend.decode(*args)          # returns host logits: synced
    wall = (time.perf_counter() - t0) * 1e3 / 10

    dev = backend.device
    tok = torch.zeros(bsz, dtype=torch.long, device=dev)
    pos = torch.from_numpy(ctx - 1).to(dev)
    cl = torch.from_numpy(ctx).to(dev)
    bt = torch.from_numpy(np.stack(tables)).to(dev)

    def step(i):
        tfm.lm_decode_step(backend.params, tok, pos, backend.cache.k_pages,
                           backend.cache.v_pages, bt, cl, cfg)

    device_ms = cuda_ms(step, 5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
    for s in seqs:
        backend.cache.free(s)
    print("  [%s] decode step (B=%d, %d layers): %.3f ms host wall, %.3f ms "
          "on the card (CUDA graph replay): the card idles %.1f%% of the "
          "step" % (card, bsz, cfg["num_layers"], wall, device_ms,
                    100.0 * max(0.0, 1 - device_ms / wall)))
    # kernel rows only: an op's row also carries its kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    if not kernels:
        print("    kernels by device time: not measured (no CUDA events)")
    for e in kernels[:8]:
        print("    %-58s %7.3f ms/step %4d launches/step"
              % (e.key[:58], e.self_device_time_total / 1e3 / 3,
                 e.count // 3))


# ------------------------------------------------------------ phases 5, 6

# The card-versus-CPU step: the bench LM at full width, cut to 2 layers,
# batch 1, T 512, so the CPU's plain versions take seconds.
STEP_CHECK = dict(CFG, num_layers=2, seq_len=512)
STEP_BATCH = 1
# Per tensor, max |card - CPU| over max |CPU|.  The two devices sum in other
# orders (matmuls over 1024-4096 terms, softmax over 32000); a naive fp32 sum
# of n terms can be off by n * 6e-8 relative, 2e-3 at n = 32000, and the
# typical error is far smaller.
STEP_TOL = 1e-3
# The same step in bf16 (the bench's dtype): the card rounds each bf16
# product once after an fp32 sum (cuBLAS, with reduced-precision reductions
# off, and the flash kernels), the CPU after its own sums, so an activation
# can land an ulp (2^-8) apart and the gradients carry it: the bf16 class of
# the JAX parity harness, of each tensor's largest value.
BF16_STEP_TOL = 2e-2
# Its outputs, the probabilities, come from bf16 logits (the graph casts
# pred's output to fp32 after the bf16 projection): p = exp(z - lse) moves
# by the factor exp(dz) when z lands an ulp apart, and with the trainer's
# Uniform(0.07) init the logits reach |z| 4-8, where a bf16 ulp is 2^-5.
# So the logs of the probabilities are held to four such ulps.
BF16_LOGP_TOL = 4 * 2.0 ** -5
DRIVE_STEPS = 5


def _trainer(cfg, batch, device):
    import torch

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import ShardedTrainer

    t = cfg["seq_len"]
    # the trainer, not this script, keeps cuBLAS's 16-bit GEMMs from
    # reducing split-K partials in 16 bits: the switch is put back to
    # torch's default before each trainer on the card is built, and must
    # be off after
    on_card = str(device) != "cpu"
    matmul = torch.backends.cuda.matmul
    if on_card:
        matmul.allow_bf16_reduced_precision_reduction = True
    tr = ShardedTrainer(
        tfm.get_symbol(**cfg), None, data_shapes={"data": (batch, t)},
        label_shapes={"softmax_label": (batch, t)},
        type_dict={"data": "int32"}, learning_rate=1e-3, momentum=0.9,
        rescale_grad=1.0 / (batch * t), device=device)
    if on_card and matmul.allow_bf16_reduced_precision_reduction:
        raise SmokeError("ShardedTrainer on the card left cuBLAS's bf16 "
                         "reduced-precision reductions on")
    return tr


def _host_batch(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    v, t = cfg["num_classes"], cfg["seq_len"]
    return {"data": rng.randint(0, v, (batch, t)).astype(np.int32),
            "softmax_label": rng.randint(0, v, (batch, t))
            .astype(np.float32)}


def _step_errors(got, want, dtype):
    """Card against CPU for one step's ``(outputs, weights, momenta)``:
    the worst reading of each kind ``(err, name)`` and the readings over
    their gates."""
    import torch

    tol = STEP_TOL if dtype == "float32" else BF16_STEP_TOL
    worst, bad = {}, []
    for kind, g_, w_ in zip(("output", "weight", "momentum"), got, want):
        for n in w_:
            if g_[n].dtype != w_[n].dtype or (
                    kind != "output" and w_[n].dtype != torch.float32):
                raise SmokeError("training step (%s): %s %s is %s on the "
                                 "card, %s on the CPU" % (
                                     dtype, kind, n, g_[n].dtype,
                                     w_[n].dtype))
            g, w = g_[n].cpu().double(), w_[n].double()
            if kind == "output" and dtype != "float32":
                # probabilities from bf16 logits: compare their logs
                err = (g.log() - w.log()).abs().max().item()
                gate = BF16_LOGP_TOL
            else:
                err = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)
                       ).item()
                gate = tol
            if not np.isfinite(err) or err > gate:
                bad.append("%s %s %.3e" % (kind, n, err))
            if err >= worst.get(kind, (-1.0, ""))[0]:
                worst[kind] = (err, n)
    return worst, bad


def _drop_last_key_tile(fwd):
    """``fused_flash_fwd`` with a planted fault: under ``causal`` the last
    64 keys are never read (the last 64 queries lose their last key
    tile)."""
    def faulty(q, k, v, causal=True, sm_scale=None):
        if causal:
            k, v = k[:, :, :-64].contiguous(), v[:, :, :-64].contiguous()
        return fwd(q, k, v, causal, sm_scale)
    return faulty


def check_training_step(dev, dtype="float32"):
    """One ShardedTrainer step on the card (kernels) and on the CPU (plain
    versions) from the same init(seed) and batch, the graph in ``dtype``:
    outputs, every updated weight and every momentum must agree.  In bf16
    a control follows: the card's step again with the flash forward's last
    key tile dropped must fail the same gates."""
    import torch

    from mxnet_tpu_torch.ops.fused import attention_kernels as ak

    cfg = dict(STEP_CHECK, dtype=dtype)
    tol = STEP_TOL if dtype == "float32" else BF16_STEP_TOL
    host = _host_batch(cfg, STEP_BATCH, SEED + 4)

    def step(device):
        t0 = time.perf_counter()
        tr = _trainer(cfg, STEP_BATCH, device)
        params, moms, aux = tr.init(seed=SEED)
        outs, params, moms, _ = tr.step_fn()(params, moms, aux,
                                             tr.place_batch(host))
        if device != "cpu":
            torch.cuda.synchronize()
        print("  step on %s: %.1f s (init included)"
              % (device, time.perf_counter() - t0))
        return {"softmax_output": outs[0]}, params, moms

    card, cpu = step(dev), step("cpu")
    worst, bad = _step_errors(card, cpu, dtype)
    del card
    print("  card vs CPU, one %s step of %d layers d%d T%d: outputs %.3e "
          "(%s), weights %.3e (%s), momenta %.3e (%s); tolerance %.0e of "
          "each tensor's largest value%s"
          % ((dtype, cfg["num_layers"], cfg["num_embed"], cfg["seq_len"])
             + worst["output"] + worst["weight"] + worst["momentum"]
             + (tol, "" if dtype == "float32" else
                ", outputs as max |log p card - log p CPU| <= %.4f"
                % BF16_LOGP_TOL)))
    if bad:
        raise SmokeError("training step (%s) differs between card and CPU: "
                         "%s" % (dtype, "; ".join(bad)))
    if dtype == "float32":
        return
    fwd = ak.fused_flash_fwd
    ak.fused_flash_fwd = _drop_last_key_tile(fwd)
    try:
        faulty = step(dev)
    finally:
        ak.fused_flash_fwd = fwd
    worst, bad = _step_errors(faulty, cpu, dtype)
    print("  control, the card's %s step with the last key tile dropped: "
          "outputs %.3e (%s), weights %.3e (%s), momenta %.3e (%s); %d "
          "tensors over their gates" % ((dtype,) + worst["output"]
                                        + worst["weight"]
                                        + worst["momentum"] + (len(bad),)))
    if not bad:
        raise SmokeError("the %s step's gates pass a flash forward that "
                         "drops its last key tile" % dtype)


_OWN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                "flash_bwd_dq_kernel", "flash_fwd_bf16_kernel",
                "flash_fwd_bf16_v1_kernel",
                "flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                "flash_bwd_dkdv_bf16_v1_kernel", "flash_bwd_dq_bf16_v1_kernel",
                "flash_bwd_dkdv_simt_kernel",
                "flash_bwd_dq_simt_kernel", "layer_norm_op_kernel",
                "sgd_mom_multi_kernel", "conv1x1_dgrad_sm90_kernel",
                "conv1x1_dgrad_kernel", "mm_epilogue_kernel",
                "mm_stats_kernel")


def _kernel_group(name):
    if any(k in name for k in _OWN_KERNELS):
        return "port kernels"
    if any(k in name for k in ("implicit_gemm", "_fprop", "_dgrad",
                               "_wgrad", "cudnn")):
        return "cuDNN"
    if ("gemm" in name or "cutlass" in name or "splitK" in name
            or "nvjet" in name):
        return "cuBLAS"
    return "other PyTorch"


# The flash kernels of each dtype: (forward, dK/dV, dQ).
FLASH_KERNELS = {
    "float32": ("flash_prefill", "flash_bwd_dkdv", "flash_bwd_dq"),
    "bfloat16": ("flash_fwd_bf16", "flash_bwd_dkdv_bf16",
                 "flash_bwd_dq_bf16")}


def run_training(dev, cfg, card):
    """The training drive: the bench configuration (``cfg``, its ``dtype``
    included), one warm-up step and DRIVE_STEPS timed steps on one seeded
    batch, through get_symbol -> ShardedTrainer -> init -> place_batch ->
    step_fn."""
    import torch

    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts

    tokens = TRAIN_BATCH * cfg["seq_len"]
    host = _host_batch(cfg, TRAIN_BATCH, SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # -- the main path: entry points a user calls ------------------------
    t0 = time.perf_counter()
    tr = _trainer(cfg, TRAIN_BATCH, dev)
    params, moms, aux = tr.init(seed=SEED)
    batch = tr.place_batch(host)
    step = tr.step_fn()
    print("  %d parameters, init %.1f s"
          % (sum(p.numel() for p in params.values()),
             time.perf_counter() - t0))
    lab = batch["softmax_label"].reshape(-1).long()
    losses, step_ms = [], []
    for i in range(1 + DRIVE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, params, moms, aux = step(params, moms, aux, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # cross-entropy of this step's forward, from the probabilities
        ce = -outs[0].gather(1, lab[:, None]).double().log().mean().item()
        print("  step %d%s: %.1f ms, cross-entropy %.6f"
              % (i, " (warm-up)" if i == 0 else "", ms, ce))
        if i:
            losses.append(ce)
            step_ms.append(ms)
    counts = launch_counts()
    # -- end of the main path -------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SmokeError("training losses %s: not finite and falling"
                         % losses)
    # the flash kernels of the graph's dtype run once a layer a step, those
    # of the other dtype, the CUDA-core pair and the first bf16 forward and
    # backward pair (D = 128 only) never; the LayerNorm op and the momentum
    # step run every step
    steps, layers = 1 + DRIVE_STEPS, cfg["num_layers"]
    dtype = cfg.get("dtype", "float32")
    for name in FLASH_KERNELS[dtype]:
        if counts.get(name, 0) != layers * steps:
            raise SmokeError("%s launched %d times in %d steps of %d layers"
                             % (name, counts.get(name, 0), steps, layers))
    other = [n for d_, names in FLASH_KERNELS.items() if d_ != dtype
             for n in names]
    for name in other + ["flash_bwd_dkdv_simt", "flash_bwd_dq_simt",
                         "flash_fwd_bf16_v1", "flash_bwd_dkdv_bf16_v1",
                         "flash_bwd_dq_bf16_v1"]:
        if counts.get(name, 0):
            raise SmokeError("%s launched on the %s training path"
                             % (name, dtype))
    for name in ("layer_norm_op", "sgd_mom_multi"):
        if counts.get(name, 0) < steps:
            raise SmokeError("%s launched %d times in %d steps"
                             % (name, counts.get(name, 0), steps))
    p50 = float(np.percentile(step_ms, 50))
    per_step = {n: c / steps for n, c in counts.items() if c}
    print("  [%s] step ms p50 %.1f (%s), tokens/s %.0f, peak memory %.2f "
          "GB" % (card, p50, ", ".join("%.1f" % m for m in step_ms),
                  tokens / p50 * 1e3, peak / 1e9))
    print("  launches per step: %s" % json.dumps(per_step))

    profile_step(lambda: step(params, moms, aux, batch), p50, card, 14)
    return counts


def profile_step(run, p50, card, top):
    """Profile one ``run()`` (a training step): the card's busy time against
    the p50 step (its idle share), device time by kernel group, the ``top``
    kernels, and the NCHW <-> NHWC conversions (cuDNN's own transposes, or
    a permute-then-copy), of which a channels-last step should have none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  device time by kernel: not measured (no CUDA events)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print("  [%s] one profiled step: %.1f ms of kernels on the card against "
          "the p50 step of %.1f ms: the card idles %.1f%% of the step"
          % (card, busy, p50, 100.0 * max(0.0, 1 - busy / p50)))
    groups = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print("  by group: %s" % ", ".join("%s %.1f ms" % kv for kv in
                                       sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print("    %-62s %8.2f ms %5d launches"
              % (e.key[:62], e.self_device_time_total / 1e3, e.count))
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    print("  by op (the host op that launched the work): %s"
          % ", ".join("%s %.1f ms (%d)" % (e.key, e.self_device_time_total
                                           / 1e3, e.count)
                      for e in ops[:8]))
    relayout = [e for e in kernels
                if re.search(r"nchwToNhwc|nhwcToNchw|[Tt]ranspose", e.key)]
    print("  layout-conversion kernels in the profiled step: %d launches, "
          "%.2f ms" % (sum(e.count for e in relayout),
                       sum(e.self_device_time_total for e in relayout) / 1e3))


# ------------------------------------------------------------ phases 7-9

# The bench ResNet-50 (bench.py's TPU branch) and the drive's batch.
RESNET = dict(num_classes=1000, num_layers=50, dtype="bfloat16",
              layout="NHWC", stem="s2d")
RESNET_IMAGE = 224
RESNET_BATCH = 128
# The card-versus-CPU ResNet step: full widths, 64 px, batch 2, fp32.
RESNET_CHECK_IMAGE = 64
RESNET_CHECK_BATCH = 2
# Launches of the 1x1 dgrad kernel in one bench step under pallas: conv1
# and conv3 of each of the 16 units, and stage 1's stride-1 shortcut.
DGRAD_PER_STEP = 33


def _resnet_trainer(image, batch, device, dtype):
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import ShardedTrainer

    sym = resnet.get_symbol(image_shape=(3, image, image),
                            **dict(RESNET, dtype=dtype))
    return ShardedTrainer(
        sym, None, data_shapes={"data": (batch, 3, image, image)},
        label_shapes={"softmax_label": (batch,)}, momentum=0.9,
        learning_rate=0.1, wd=1e-4, rescale_grad=1.0 / batch, device=device)


def _resnet_batch(image, batch, seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.uniform(-1, 1, (batch, 3, image, image))
            .astype(np.float32),
            "softmax_label": rng.randint(0, 1000, (batch,))
            .astype(np.float32)}


def _largest_rel(got, want, scale=None):
    """max |got - want| over max |scale| (default: ``want``)."""
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    s = w if scale is None else scale.detach().cpu().double()
    return ((g - w).abs().max() / s.abs().max().clamp_min(1e-30)).item()


# bn0's scale reaches the loss only through per-channel ReLU and max-pooling
# into stage 1's first BatchNorm, which normalises it away: its exact
# gradient is zero up to that BatchNorm's eps (300x smaller than bn0_beta's
# in the float64 step), so its momentum is mostly weight decay and its
# gradient part is rounding on any device.  Its momentum is measured against
# the largest momentum of its layer, bn0_beta's.
MOMENTUM_SCALE = {"bn0_gamma": "bn0_beta"}


def _relu_gates(sym, params, aux, batch):
    """``{relu node: its output > 0}`` of one training-mode forward."""
    import torch
    from mxnet_tpu_torch.executor import graph_fn

    internals = sym.get_internals()
    with torch.no_grad():
        outs, _ = graph_fn(internals)(dict(params, **batch), aux, None, True)
    got = dict(zip(internals.list_outputs(), outs))
    return {n.name: got[n.output_name(0)] > 0 for n in sym._topo()
            if not n.is_variable and n.op.name == "Activation"
            and n.attrs["act_type"] == "relu"}


def _upstream(sym, names):
    """The variables that any node of ``names`` is computed from."""
    deps = {}
    for node in sym._topo():
        deps[node.name] = {node.name} if node.is_variable else set()
        for src, _ in node.inputs:
            deps[node.name] |= deps[src.name]
    return set().union(*(deps[n] for n in names))


def check_resnet_step(dev):
    """One ResNet-50 step (full widths, 64 px, batch 2, fp32, TF32 off)
    from the same init(seed) and batch: on the card under MXTPU_CONV1X1 =
    pallas, dot and unset, and on the CPU (plain versions) in fp32 and in
    float64.

    A ReLU whose input lies within the forward's rounding of zero can fall
    on the other side of its gate on another device; the gradient element
    behind it then differs by its whole size, BatchNorm's backward spreads
    that over the channel, and every tensor the gate's input is computed
    from moves.  So:

    * outputs and moving statistics: card (pallas) against CPU fp32, within
      STEP_TOL of each tensor's largest value;
    * weights and momenta, every tensor: the card's three modes run one
      forward (cuDNN deterministic, checked bit for bit), so their gates
      agree, and pallas is held against dot and against unset (cuDNN's own
      backward) within STEP_TOL;
    * weights and momenta against the CPU: card against CPU fp32, and CPU
      fp32 against float64, within STEP_TOL on every tensor that no gate
      differing between the pair is computed from.  The gates that differ
      and the distances behind them are printed."""
    import torch

    host = _resnet_batch(RESNET_CHECK_IMAGE, RESNET_CHECK_BATCH, SEED + 6)
    res, gates = {}, {}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for device, dt, mode in ((dev, "float32", "pallas"),
                                 (dev, "float32", "dot"),
                                 (dev, "float32", ""),
                                 ("cpu", "float32", "pallas"),
                                 ("cpu", "float64", "pallas")):
            os.environ["MXTPU_CONV1X1"] = mode
            key = (str(device), dt, mode)
            t0 = time.perf_counter()
            tr = _resnet_trainer(RESNET_CHECK_IMAGE, RESNET_CHECK_BATCH,
                                 device, "float32")
            params, moms, aux = tr.init(seed=SEED)
            batch = tr.place_batch(host)
            if dt == "float64":
                params, moms, aux, batch = (
                    {n: t.double() for n, t in d.items()}
                    for d in (params, moms, aux, batch))
            if mode == "pallas":
                gates[key[:2]] = _relu_gates(tr.symbol, params, aux, batch)
            outs, params, moms, aux = tr.step_fn()(params, moms, aux, batch)
            if str(device) != "cpu":
                torch.cuda.synchronize()
            print("  ResNet-50 step on %s, %s, MXTPU_CONV1X1=%r: %.1f s "
                  "(init included)" % (device, dt, mode,
                                       time.perf_counter() - t0))
            res[key] = ({"softmax_output": outs[0]}, aux, params, moms)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        os.environ["MXTPU_CONV1X1"] = "pallas"
    sym = tr.symbol
    card, cpu, exact = (res[(str(dev), "float32", "pallas")],
                        res[("cpu", "float32", "pallas")],
                        res[("cpu", "float64", "pallas")])

    def rel_of(got, want, n, momentum):
        scale = MOMENTUM_SCALE.get(n) if momentum else None
        return _largest_rel(got[n], want[n], scale and want[scale])

    def hold(what, got, want, names=None):
        worst = (0.0, None)
        for n in (want if names is None else names):
            rel = rel_of(got, want, n, what.endswith("momenta"))
            if not np.isfinite(rel) or rel > STEP_TOL:
                raise SmokeError("ResNet step: %s %s: %.3e of its largest "
                                 "value" % (what, n, rel))
            worst = max(worst, (rel, n), key=lambda r: r[0])
        return worst

    report = []
    for i, kind in enumerate(("outputs", "moving stats")):
        report.append(("card vs CPU fp32, " + kind,
                       hold("card vs CPU, " + kind, card[i], cpu[i]), ""))
    for mode in ("dot", ""):
        other = res[(str(dev), "float32", mode)]
        for i in (0, 1):
            for n in card[i]:
                if not torch.equal(card[i][n], other[i][n]):
                    raise SmokeError(
                        "ResNet step: the card's forward under "
                        "MXTPU_CONV1X1=pallas and %r differs (%s): the "
                        "modes' gates may differ" % (mode, n))
        for i, kind in ((2, "weights"), (3, "momenta")):
            what = "card pallas vs %r, %s" % (mode, kind)
            report.append((what, hold(what, card[i], other[i]), ""))
    card_gates = gates[(str(dev), "float32")]
    for pair, a, b, ga, gb in (
            ("card vs CPU fp32", card, cpu, card_gates,
             gates[("cpu", "float32")]),
            ("CPU fp32 vs float64", cpu, exact, gates[("cpu", "float32")],
             gates[("cpu", "float64")])):
        flipped = {n: int((ga[n].cpu() != gb[n].cpu()).sum()) for n in gb}
        flipped = {n: c for n, c in flipped.items() if c}
        behind = _upstream(sym, flipped)
        for i, kind in ((2, "weights"), (3, "momenta")):
            names = [n for n in b[i] if n not in behind]
            far = max([(rel_of(a[i], b[i], n, i == 3), n)
                       for n in b[i] if n in behind] or [(0.0, "-")],
                      key=lambda r: r[0])
            what = "%s, %s" % (pair, kind)
            report.append((what, hold(what, a[i], b[i], names),
                           "%d held; %d behind a differing gate, farthest "
                           "%.3e (%s)" % (len(names), len(b[i]) - len(names),
                                          far[0], far[1])))
        print("  %s: %d ReLU gates of %d differ (%s)"
              % (pair, sum(flipped.values()),
                 sum(g.numel() for g in gb.values()),
                 ", ".join("%s %d" % kv for kv in flipped.items()) or "-"))
    print("  one ResNet-50 step at %d px, batch %d: max |err| / max |ref| "
          "of each tensor, tolerance %.0e:"
          % (RESNET_CHECK_IMAGE, RESNET_CHECK_BATCH, STEP_TOL))
    for what, (rel, n), note in report:
        print("    %-36s %.3e %-28s %s" % (what, rel, n or "-", note))


def run_resnet_training(dev, card, mode):
    """The bench ResNet-50 through get_symbol -> ShardedTrainer -> init ->
    place_batch -> step_fn under MXTPU_CONV1X1=mode: a warm-up and
    DRIVE_STEPS timed steps on one seeded batch.  Returns the launch
    counts of the run."""
    import torch

    from mxnet_tpu_torch.ops import launch_counts, nn, reset_launch_counts

    if mode:
        os.environ["MXTPU_CONV1X1"] = mode
    else:
        os.environ.pop("MXTPU_CONV1X1", None)
    label = mode or "unset"
    host = _resnet_batch(RESNET_IMAGE, RESNET_BATCH, SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nn.reset_relayout_copies()
    reset_launch_counts()
    # -- the main path: entry points a user calls ------------------------
    t0 = time.perf_counter()
    tr = _resnet_trainer(RESNET_IMAGE, RESNET_BATCH, dev, RESNET["dtype"])
    params, moms, aux = tr.init(seed=SEED)
    batch = tr.place_batch(host)
    step = tr.step_fn()
    print("  MXTPU_CONV1X1=%s: %d parameters, init %.1f s"
          % (label, sum(p.numel() for p in params.values()),
             time.perf_counter() - t0))
    lab = batch["softmax_label"].reshape(-1).long()
    losses, step_ms = [], []
    for i in range(1 + DRIVE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, params, moms, aux = step(params, moms, aux, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ce = -outs[0].gather(1, lab[:, None]).double().log().mean().item()
        print("  step %d%s: %.1f ms, cross-entropy %.6f"
              % (i, " (warm-up)" if i == 0 else "", ms, ce))
        losses.append(ce)
        if i:
            step_ms.append(ms)
    counts = launch_counts()
    # -- end of the main path -------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + DRIVE_STEPS
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SmokeError("ResNet losses %s (%s): not finite, or the last not "
                         "below the warm-up's" % (losses, label))
    want = DGRAD_PER_STEP * steps if mode == "pallas" else 0
    if (counts["conv1x1_dgrad"] != want or counts["conv1x1_dgrad_core"]
            or counts["sgd_mom_multi"] != steps):
        raise SmokeError("ResNet drive (%s): conv1x1_dgrad launched %d times, "
                         "the wmma core %d, sgd_mom_multi %d, in %d steps"
                         % (label, counts["conv1x1_dgrad"],
                            counts["conv1x1_dgrad_core"],
                            counts["sgd_mom_multi"], steps))
    if any(nn.relayout_copies.values()):
        raise SmokeError("ResNet drive (%s): NHWC tensors copied into row-"
                         "major order: %s" % (label, nn.relayout_copies))
    p50 = float(np.percentile(step_ms, 50))
    print("  [%s] MXTPU_CONV1X1=%s: step ms p50 %.1f (%s), images/s %.0f, "
          "peak memory %.2f GB" % (card, label, p50, ", ".join(
              "%.1f" % m for m in step_ms), RESNET_BATCH / p50 * 1e3,
              peak / 1e9))
    print("  launches per step: %s; relayout copies in the run: %s"
          % (json.dumps({n: c / steps for n, c in counts.items() if c}),
             json.dumps(nn.relayout_copies)))

    profile_step(lambda: step(params, moms, aux, batch), p50, card, 16)
    return counts


def run_probe(card):
    """The port's bottleneck probe; returns the launch counts of its run."""
    import torch

    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.tools import bottleneck_probe

    torch.cuda.empty_cache()
    reset_launch_counts()
    # -- the main path: the probe's entry point --------------------------
    rows = bottleneck_probe.main()
    counts = launch_counts()
    # -- end of the main path -------------------------------------------
    for name, r in rows.items():
        print("  [%s] %s: A %.2fx, B %.2fx, C %.2fx (torch ms over kernel "
              "ms)" % (card, name, r["A_torch"] / r["A_kernel"],
                       r["B_torch"] / r["B_kernel"],
                       r["C_torch"] / r["C_kernel"]))
    return counts

# -------------------------------------------------------------------- main


_TYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}


def kernel_entry(mangled):
    """``name<template args>`` of a kernel from its mangled name (ptxas's
    "Compiling entry function" line), or None.  A mangled identifier is its
    length, then its name; the anonymous namespace's hash before it may end
    in digits too, so the length must match."""
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        names = [mangled[run.end():run.end() + int(digits[i:])]
                 for i in range(len(digits))]
        name = next((n for n in names
                     if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", n)), None)
        if name is None:
            continue
        args = re.match(r"I((?:Li\d+E)+)E|I(13__nv_bfloat16|f)Lb(\d)E|"
                        r"I(f|13__nv_bfloat16|6__half)((?:Li\d+E)*)E|E",
                        mangled[run.end() + len(name):])
        if not args:
            continue
        if args.group(2):
            targs = "%s, %s" % (_TYPES[args.group(2)], "vector"
                                if args.group(3) == "1" else "scalar")
        else:
            targs = ", ".join(
                ([_TYPES[args.group(4)]] if args.group(4) else [])
                + re.findall(r"\d+", args.group(1) or args.group(5) or ""))
        return name + ("<%s>" % targs if targs else "")
    return None




def main():
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its log

    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    import mxnet_tpu_torch  # noqa: F401 - fails here when not beside it
    from mxnet_tpu_torch.ops import _build

    print("== phase 1: card")
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, python %s, device %s"
          % (torch.__version__, torch.version.cuda, sys.version.split()[0],
             torch.cuda.get_device_name(0)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("== phase 2: build the CUDA kernels")
    secs = _build.build_all()
    print("  built/loaded in %.2f s" % secs)
    for name in _build._sources():
        for line in _build.build_log(name).splitlines():
            mangled = re.search(r"Compiling entry function '(\w+)'", line)
            entry = mangled and kernel_entry(mangled.group(1))
            if entry:
                print("  %s: %s" % (name, entry))
            elif "registers" in line or "spill" in line:
                print("  %s:   %s" % (name, line.strip()))
            elif re.search(r"\(C75\d\d\)", line):
                # ptxas serialized a kernel's wgmma (C7510-C7520)
                print("  %s:   %s" % (name, line.strip()))

    print("== phase 3: kernels against their plain versions")
    lane_rows = check_kernels(dev, CFG)
    train_rows = check_training_kernels(dev, CFG)
    train_rows += check_bf16_flash(dev, CFG)
    gemm_rows = check_gemm_kernels(dev)
    for shape, rs in (("the lane's shape", lane_rows),
                      ("the LM training step's shape", train_rows),
                      ("one ResNet step's shapes (row 9) or the probe's",
                       gemm_rows)):
        for r in rs:
            print("  [%s] %-14s at %s: kernel %.4f ms  plain "
                  "%.4f ms  library %s  bound %.4f ms (%s)"
                  % (card, r["name"], shape, r["ms"], r["plain_ms"],
                     "%.4f ms" % r["library_ms"]
                     if r["library_ms"] is not None else "none",
                     r["bound_ms"], r["bound_by"]))
    # flash_prefill runs on both paths: its line is the training shape's
    rows = [r for r in lane_rows if r["name"] != "flash_prefill"] \
        + train_rows + gemm_rows
    torch.cuda.synchronize()

    print("== phase 4: generation lane, %d layers, d%d, vocab %d"
          % (CFG["num_layers"], CFG["num_embed"], CFG["num_classes"]))
    counts = run_slice(dev, CFG, PROMPTS, NEW_TOKENS, NUM_BLOCKS,
                       PREFILL_BUCKETS, DECODE_BUCKETS, CHECKED, card)

    print("== phase 5: one training step, card against CPU, fp32 and bf16")
    for dtype in ("float32", "bfloat16"):
        check_training_step(dev, dtype)

    path_counts = [counts]
    for dtype in ("bfloat16", "float32"):
        print("== phase 6: training, %d layers, d%d, batch %d, T %d, %s"
              % (CFG["num_layers"], CFG["num_embed"], TRAIN_BATCH,
                 CFG["seq_len"], dtype))
        path_counts.append(run_training(dev, dict(CFG, dtype=dtype), card))

    print("== phase 7: one ResNet-50 step, card against CPU")
    os.environ["MXTPU_CONV1X1"] = "pallas"
    check_resnet_step(dev)

    print("== phase 8: training ResNet-50, %d px, batch %d, %s, %s, stem %s"
          % (RESNET_IMAGE, RESNET_BATCH, RESNET["dtype"], RESNET["layout"],
             RESNET["stem"]))
    for mode in ("pallas", ""):
        path_counts.append(run_resnet_training(dev, card, mode))

    print("== phase 9: the bottleneck probe")
    path_counts.append(run_probe(card))

    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in path_counts)
    earlier = {n: sum(c[n] for c in path_counts) for n in EARLIER_KERNELS}
    print("  the earlier kernels kept for timing in turns, launches on the "
          "main paths: %s" % json.dumps(earlier))
    if any(earlier.values()):
        raise SmokeError("an earlier kernel launched on a main path: %s"
                         % earlier)
    missing = [r["name"] for r in rows if not r["launches"]]
    if missing:
        raise SmokeError("kernels never launched on a main path: %s"
                         % missing)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except (SmokeError, ImportError) as exc:
        print("chip_smoke FAILED: %s: %s" % (type(exc).__name__, exc),
              file=sys.stderr)
        sys.exit(1)
