"""Autoregressive generation lane: prefill/decode split + paged KV cache.

Counterpart of ``mxnet_tpu/serving/generation.py`` (the Orca/vLLM model:
Yu et al., OSDI '22; Kwon et al., SOSP '23):

- **Prefill/decode split.**  Each admitted request runs ONE prefill (the
  whole prompt, padded to a prompt-length bucket from
  ``MXNET_TPU_GEN_PREFILL_BUCKETS``), which fills its KV-cache pages and
  yields the first token.  After that it joins the shared decode batch:
  one token per sequence per step, padded to a batch bucket from
  ``MXNET_TPU_GEN_DECODE_BUCKETS``.
- **Iteration-level admission.**  The loop re-packs the decode batch
  every step: a request submitted mid-generation is prefilled and joins
  the next decode step as finished sequences retire.
- **Paged KV state on the device.**  K/V live in the backend's
  :class:`~mxnet_tpu_torch.ops.kv_cache.PagedKVCache`, whose pools are
  tensors on the backend's device.  A prefill's K/V stay on the device and
  go into the pool in one indexed copy; a decode step's K/V for the whole
  batch go in with one more, only AFTER the step succeeded, so a retried
  step can never corrupt another sequence's blocks.  Only the logits come
  back to the host, for the greedy argmax.  Exhaustion sheds the new
  request with the typed 429 ``CacheExhaustedError``.
- **Cache is backend state.**  ``ModelRegistry.swap`` replaces backend and
  cache together; the loop notices the swap under ``dispatch_lock`` and
  re-prefills live sequences on the new backend.

Streaming: :meth:`GenerationRequest.tokens` yields ids as the loop
produces them, and :meth:`GenerationRequest.cancel` retires the sequence
and frees its blocks at the next iteration.

This slice leaves out the JAX lane's metrics, tracing, chaos sites, event
log, memory ledger and int8 head; the lane's own counters are in
:meth:`GenerationScheduler.stats`.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..models import transformer as _tfm
from ..ops import _build
from ..ops.kv_cache import CacheExhaustedError, PagedKVCache
from . import admission as _admission
from . import tenancy as _tenancy
from .registry import Backend, ModelRegistry

__all__ = ["GenerationRequest", "GenerationScheduler", "LMBackend",
           "default_decode_buckets", "default_max_new_tokens",
           "default_prefill_buckets", "default_retries"]


def default_prefill_buckets():
    """``MXNET_TPU_GEN_PREFILL_BUCKETS``: prompt-length pad targets."""
    raw = os.environ.get("MXNET_TPU_GEN_PREFILL_BUCKETS", "8,16,32,64")
    try:
        buckets = sorted({int(b) for b in raw.split(",") if b.strip()})
    except ValueError:
        buckets = [8, 16, 32, 64]
    return [b for b in buckets if b > 0] or [8]


def default_decode_buckets():
    """``MXNET_TPU_GEN_DECODE_BUCKETS``: decode batch pad targets."""
    raw = os.environ.get("MXNET_TPU_GEN_DECODE_BUCKETS", "1,2,4,8")
    try:
        buckets = sorted({int(b) for b in raw.split(",") if b.strip()})
    except ValueError:
        buckets = [1, 2, 4, 8]
    return [b for b in buckets if b > 0] or [1]


def default_max_new_tokens():
    """``MXNET_TPU_GEN_MAX_TOKENS``: per-request generation cap."""
    try:
        return int(os.environ.get("MXNET_TPU_GEN_MAX_TOKENS", "32"))
    except ValueError:
        return 32


def default_retries():
    """``MXNET_TPU_SERVING_RETRIES``: same-replica dispatch retries before
    a fault is surfaced to the request futures."""
    try:
        return int(os.environ.get("MXNET_TPU_SERVING_RETRIES", "2"))
    except ValueError:
        return 2


_DONE = object()


class GenerationRequest(object):
    """One admitted generation request: a token stream plus a future."""

    __slots__ = ("model", "prompt", "max_new_tokens", "eos_id", "deadline",
                 "tenant", "t_admit", "generated", "error", "finish_reason",
                 "latency_s", "first_token_s", "seq_id", "_tokens", "_event",
                 "_cancelled")

    def __init__(self, model, prompt, max_new_tokens, eos_id, deadline,
                 tenant=_tenancy.DEFAULT_TENANT):
        self.model = model
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline = deadline
        self.tenant = tenant
        self.t_admit = time.monotonic()
        self.generated = []
        self.error = None
        self.finish_reason = None
        self.latency_s = None
        self.first_token_s = None
        self.seq_id = None
        self._tokens = _queue.Queue()
        self._event = threading.Event()
        self._cancelled = False

    @property
    def done(self):
        return self._event.is_set()

    @property
    def cancelled(self):
        return self._cancelled

    def cancel(self):
        """Client went away: the loop retires the sequence and frees its
        cache blocks at the next iteration.  Safe from any thread."""
        self._cancelled = True

    # -- loop side ---------------------------------------------------

    def _push(self, token):
        if self.first_token_s is None:
            self.first_token_s = time.monotonic() - self.t_admit
        self.generated.append(int(token))
        self._tokens.put(int(token))

    def _finish(self, reason):
        if self._event.is_set():   # idempotent: kill vs loop race
            return
        self.finish_reason = reason
        self.latency_s = time.monotonic() - self.t_admit
        self._tokens.put(_DONE)
        self._event.set()

    def _fail(self, error):
        if self._event.is_set():
            return
        self.error = error
        self.finish_reason = "error"
        self.latency_s = time.monotonic() - self.t_admit
        self._tokens.put(_DONE)
        self._event.set()

    # -- client side -------------------------------------------------

    def tokens(self, timeout=30.0):
        """Yield generated token ids as they arrive; raises the typed
        serving error if generation failed."""
        while True:
            tok = self._tokens.get(timeout=timeout)
            if tok is _DONE:
                if self.error is not None:
                    raise self.error
                return
            yield tok

    def result(self, timeout=30.0):
        """Block until generation finishes; returns the generated ids."""
        if not self._event.wait(timeout):
            raise MXNetError(
                "generation on model %r timed out after %.1fs"
                % (self.model, timeout))
        if self.error is not None:
            raise self.error
        return list(self.generated)


class LMBackend(Backend):
    """Generative serving backend: transformer params + paged KV cache on
    one device.

    ``params`` is a checkpoint dict (numpy arrays from
    :func:`~mxnet_tpu_torch.models.transformer.init_lm_params` or a
    trained checkpoint, or tensors).  ``device=None`` is the CUDA device;
    without CUDA that raises — the CPU runs only when asked for by name.
    On a CUDA device the kernels are built here, at construction, so the
    generation loop never compiles.
    """

    def __init__(self, params, cfg, block_size=None, num_blocks=None,
                 device=None, model="lm"):
        self.device = resolve_device(device)
        self.cfg = dict(cfg)
        if self.device.type == "cuda":
            # projections in full fp32, as the JAX lane's fp32 path
            torch.backends.cuda.matmul.allow_tf32 = False
            self.build_seconds = _build.build_all()
        self.params = _tfm.params_from_jax(params, self.device)
        self.input_shapes = {"data": (self.cfg["seq_len"],)}
        self.cache = PagedKVCache(
            num_layers=self.cfg["num_layers"],
            num_heads=self.cfg["num_heads"],
            head_dim=self.cfg["num_embed"] // self.cfg["num_heads"],
            block_size=block_size, num_blocks=num_blocks,
            device=self.device, model=model)
        # fixed-width block tables: a decode step's shapes depend only on
        # the batch bucket
        self.max_blocks_per_seq = -(-self.cfg["seq_len"]
                                    // self.cache.block_size)
        self._seen = set()
        self._seen_lock = threading.Lock()

    def _cold(self, key):
        """First visit of a dispatch shape (the JAX lane's compile
        accounting; here it marks the first, slower, launch of a shape)."""
        with self._seen_lock:
            cold = key not in self._seen
            self._seen.add(key)
        return cold

    def _tokens(self, tokens):
        tokens = _np.asarray(tokens, dtype=_np.int64)
        vocab = self.cfg["num_classes"]
        if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
            raise MXNetError("token ids outside [0, %d)" % vocab)
        return torch.from_numpy(tokens).to(self.device)

    # -- Backend protocol (full forward) -----------------------------

    def infer(self, batch):
        """Full-sequence forward (no cache): ``{"data": [B, T]}`` →
        ``([logits [B, T, V]], cold)``."""
        tokens = self._tokens(batch["data"])
        cold = self._cold(("infer",) + tuple(tokens.shape))
        logits, _, _ = _tfm.lm_prefill(self.params, tokens, self.cfg)
        return [logits.cpu().numpy()], cold

    # -- generation entry points -------------------------------------

    def prefill(self, tokens, length):
        """One prompt (``tokens`` int ``[T_bucket]`` padded, ``length``
        real) → ``(last_logits [V] numpy, k [L, length, H, D], v, cold)``;
        K/V stay on the device."""
        tokens = self._tokens(tokens)[None]
        cold = self._cold(("prefill",) + tuple(tokens.shape))
        logits, k, v = _tfm.lm_prefill(self.params, tokens, self.cfg)
        return (logits[0, length - 1].cpu().numpy(), k[:, 0, :length],
                v[:, 0, :length], cold)

    def decode(self, tokens, positions, block_tables, context_lens):
        """One decode step over a padded batch.  Returns ``(logits [B, V]
        numpy, k_step [L, B, H, D], v_step, cold)``, K/V on the device —
        the caller writes them into the cache after the step succeeds."""
        bsz = len(tokens)
        tables = _np.asarray(block_tables, dtype=_np.int32).reshape(bsz, -1)
        ctx = _np.asarray(context_lens, dtype=_np.int32).reshape(bsz)
        pos = _np.asarray(positions, dtype=_np.int32).reshape(bsz)
        kmax = tables.shape[1] * self.cache.block_size
        if (tables.min(initial=0) < 0
                or tables.max(initial=0) >= self.cache.num_blocks
                or ctx.min() < 1 or ctx.max() > kmax
                or pos.min() < 0 or pos.max() >= self.cfg["seq_len"]):
            raise MXNetError("decode: block ids, context lengths or "
                             "positions out of range")
        cold = self._cold(("decode", bsz))
        # one host-to-device copy for all the step's small int arrays
        packed = _np.concatenate([pos, ctx, tables.reshape(-1)])
        dev = torch.from_numpy(packed).to(self.device)
        tok = self._tokens(tokens)
        logits, k, v = _tfm.lm_decode_step(
            self.params, tok, dev[:bsz], self.cache.k_pages,
            self.cache.v_pages, dev[2 * bsz:].view(bsz, -1),
            dev[bsz:2 * bsz], self.cfg)
        return logits.cpu().numpy(), k, v, cold


class _Sequence(object):
    """One live generation: its request, cache identity, and progress."""

    __slots__ = ("req", "seq_id", "length", "last_token", "backend_ref",
                 "new_tokens")

    def __init__(self, req, seq_id, backend_ref):
        self.req = req
        self.seq_id = seq_id
        self.backend_ref = backend_ref
        self.length = 0          # tokens with K/V in the cache
        self.last_token = 0      # input to the next decode step
        self.new_tokens = 0


class _GenLane(object):
    """Per-model waiting queue + live sequences + the generation thread +
    the lane's counters."""

    __slots__ = ("entry", "queue", "active", "thread", "prefill_buckets",
                 "steps", "tokens", "rows", "slots", "max_step_rows",
                 "seq_counter", "requests", "compiles", "errors",
                 "reprefills")

    def __init__(self, entry, prefill_buckets, weight_fn=None):
        self.entry = entry
        self.queue = _tenancy.FairQueue(weight_fn)
        self.active = []
        self.thread = None
        self.prefill_buckets = prefill_buckets
        self.steps = 0
        self.tokens = 0
        self.rows = 0
        self.slots = 0
        self.max_step_rows = 0
        self.seq_counter = 0
        self.requests = 0        # finished successfully
        self.compiles = 0        # cold prefill/decode shapes
        self.errors = 0          # prefill/decode attempts that raised
        self.reprefills = 0      # live sequences re-prefilled after a swap


class GenerationScheduler(object):
    """Iteration-level generation scheduler for one serving replica:
    per-model lanes, each running the prefill/decode loop on a thread."""

    def __init__(self, registry=None, name="gen0", tenant_policy=None):
        self.name = name
        self.registry = registry if registry is not None else ModelRegistry()
        self.tenants = (tenant_policy if tenant_policy is not None
                        else _tenancy.TenantPolicy())
        self.admission = _admission.AdmissionController()
        self._cond = threading.Condition()
        self._lanes = {}
        self._stopping = False
        self._killed = False

    # -- registration -------------------------------------------------

    def _weight_fn(self, entry):
        overrides = entry.tenant_weights
        policy = self.tenants

        def weight(tenant):
            w = overrides.get(tenant)
            return policy.weight(tenant) if w is None else float(w)
        return weight

    def register(self, name, backend, decode_buckets=None,
                 prefill_buckets=None, max_queue=None, buckets=None,
                 tenant_weights=None):
        """Register an :class:`LMBackend` and start its generation loop.
        ``decode_buckets`` (alias ``buckets``) are batch pad targets,
        ``prefill_buckets`` prompt-length pad targets clipped to the
        model's ``seq_len``."""
        if not isinstance(backend, LMBackend):
            raise MXNetError(
                "generation lane serves LMBackend models, got %r"
                % (type(backend).__name__,))
        entry = self.registry.register(
            name, backend,
            buckets=(decode_buckets or buckets or
                     default_decode_buckets()),
            max_queue=max_queue, tenant_weights=tenant_weights)
        seq_len = backend.cfg["seq_len"]
        lane_prefill = sorted({min(b, seq_len) for b in
                               (prefill_buckets or
                                default_prefill_buckets())})
        lane = _GenLane(entry, lane_prefill,
                        weight_fn=self._weight_fn(entry))
        with self._cond:
            self._lanes[name] = lane
        lane.thread = threading.Thread(
            target=self._loop, args=(name, lane),
            name="%s-generate-%s" % (self.name, name), daemon=True)
        lane.thread.start()
        return entry

    def swap(self, name, backend):
        """Hot reload (new weights + fresh cache as one unit)."""
        return self.registry.swap(name, backend)

    def warmup(self, name):
        """Run every prefill bucket (B=1) and decode bucket once, so the
        first request pays no first-launch cost.  Returns the cold count."""
        lane = self._lane(name)
        entry = lane.entry
        cold_n = 0
        with entry.dispatch_lock:
            backend = entry.backend
            for t in lane.prefill_buckets:
                _, _, _, cold = backend.prefill(
                    _np.zeros(t, dtype=_np.int32), 1)
                cold_n += bool(cold)
            for b in entry.buckets:
                sid = "__warm%d" % b
                backend.cache.allocate(sid, 1)
                tables = _np.stack(
                    [backend.cache.block_table(
                        sid, backend.max_blocks_per_seq)] * b)
                _, _, _, cold = backend.decode(
                    _np.zeros(b, _np.int32), _np.zeros(b, _np.int32),
                    tables, _np.ones(b, _np.int32))
                backend.cache.free(sid)
                cold_n += bool(cold)
        lane.compiles += cold_n
        return cold_n

    # -- admission ----------------------------------------------------

    def _lane(self, name):
        with self._cond:
            lane = self._lanes.get(name)
        if lane is None:
            self.registry.get(name)
            raise _admission.UnknownModelError(
                "model %r has no generation lane" % (name,))
        return lane

    def submit(self, name, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, tenant=None, force=False):
        """Admit one generation request; returns its
        :class:`GenerationRequest` (stream + future).  ``tenant`` labels it
        for WFQ and quotas (``max_new_tokens`` is charged up front).
        ``force=True`` re-admits accepted work past overload, drain and
        quota; a killed replica still refuses."""
        tenant = _tenancy.clean_tenant(tenant)
        if self._killed:
            raise _admission.ReplicaDeadError("replica %r is dead"
                                              % (self.name,))
        lane = self._lane(name)
        backend = lane.entry.backend
        prompt = _np.asarray(prompt, dtype=_np.int32).reshape(-1)
        if prompt.size < 1:
            raise MXNetError("empty prompt")
        if max_new_tokens is None:
            max_new_tokens = default_max_new_tokens()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        seq_len = backend.cfg["seq_len"]
        if prompt.size + max_new_tokens > seq_len:
            raise MXNetError(
                "prompt (%d) + max_new_tokens (%d) exceeds the model's "
                "seq_len %d" % (prompt.size, max_new_tokens, seq_len))
        vocab = backend.cfg["num_classes"]
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise MXNetError("prompt token ids outside [0, %d)" % vocab)
        deadline = _admission.deadline_from_ms(deadline_ms)
        req = GenerationRequest(name, prompt, max_new_tokens, eos_id,
                                deadline, tenant)
        with self._cond:
            if self._stopping and not force:
                self.admission.reject(name, "draining", tenant=tenant)
            if not force:
                self.admission.admit(name, len(lane.queue),
                                     lane.entry.max_queue, deadline,
                                     tenant=tenant)
                over = self.tenants.charge(tenant, tokens=max_new_tokens)
                if over is not None:
                    self.admission.quota_reject(name, tenant, *over)
            lane.queue.push(tenant, req)
            self._cond.notify_all()
        return req

    def generate(self, name, prompt, max_new_tokens=None, eos_id=None,
                 deadline_ms=None, timeout=60.0, tenant=None):
        """Synchronous convenience: :meth:`submit` + ``result()``."""
        return self.submit(name, prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id, deadline_ms=deadline_ms,
                           tenant=tenant).result(timeout=timeout)

    # -- the generation loop ------------------------------------------

    def _loop(self, name, lane):
        while True:
            with self._cond:
                while (not lane.queue and not lane.active
                       and not self._killed and not self._stopping):
                    self._cond.wait(0.05)
                if self._killed:
                    return
                if self._stopping and not lane.queue and not lane.active:
                    return
            self._iterate(name, lane)
            # let a waiting hot swap take dispatch_lock before the next
            # iteration re-takes it (a busy loop would starve it)
            lane.entry.wait_for_swaps()

    def _iterate(self, name, lane):
        """ONE iteration: retire finished/cancelled sequences, admit
        waiting requests up to the decode capacity, then run one decode
        step — the Orca schedule."""
        entry = lane.entry
        with entry.dispatch_lock:
            backend = entry.backend
            self._retire_stale_backend(name, lane, backend)
            self._retire(lane, backend)
            capacity = entry.buckets[-1] - len(lane.active)
            with self._cond:
                admitted = lane.queue.take(capacity)
            for req in admitted:
                self._prefill_one(name, lane, backend, req)
            self._retire(lane, backend)
            if lane.active:
                self._decode_step(name, lane, backend)
            self._retire(lane, backend)

    def _retire_stale_backend(self, name, lane, backend):
        """Hot swap landed: re-prefill live sequences (prompt + tokens so
        far) on the new backend.  Caller holds dispatch_lock."""
        stale = [s for s in lane.active if s.backend_ref is not backend]
        for seq in stale:
            lane.active.remove(seq)
            seq.backend_ref.cache.free(seq.seq_id)
            if seq.req.cancelled or seq.req.done:
                continue
            try:
                self._start_sequence(name, lane, backend, seq.req,
                                     resume=seq)
                lane.reprefills += 1
            except Exception as exc:  # noqa: BLE001 - fault path
                seq.req._fail(exc if isinstance(exc, MXNetError) else
                              MXNetError("re-prefill after hot swap "
                                         "failed: %s" % exc))

    def _retire(self, lane, backend):
        """Free cache blocks of finished/cancelled sequences."""
        for seq in list(lane.active):
            req = seq.req
            finished = (seq.new_tokens >= req.max_new_tokens
                        or (req.eos_id is not None and seq.new_tokens
                            and req.generated
                            and req.generated[-1] == req.eos_id))
            if req.cancelled and not req.done:
                req._finish("cancelled")
            elif finished and not req.done:
                req._finish("length" if seq.new_tokens
                            >= req.max_new_tokens else "stop")
                lane.requests += 1
            if req.done:
                backend.cache.free(seq.seq_id)
                lane.active.remove(seq)

    def _pick_prefill_bucket(self, lane, t):
        for b in lane.prefill_buckets:
            if b >= t:
                return b
        return lane.prefill_buckets[-1]

    def _prefill_one(self, name, lane, backend, req, resume=None):
        """Admit one request into the decode batch: deadline re-check,
        cache allocation (typed 429 on exhaustion), ONE prefill, first
        token out.  Caller holds dispatch_lock."""
        now = time.monotonic()
        if req.cancelled:
            req._finish("cancelled")
            return
        if _admission.AdmissionController.expired(req.deadline, now):
            self.admission.account(name, "deadline", req.tenant)
            req._fail(_admission.DeadlineExceededError(
                "model %r: deadline expired while queued (waited %.3fs)"
                % (name, now - req.t_admit)))
            return
        try:
            self._start_sequence(name, lane, backend, req, resume=resume)
        except CacheExhaustedError as exc:
            self.admission.account(name, "cache_exhausted", req.tenant)
            req._fail(exc)
        except Exception as exc:  # noqa: BLE001 - fault path
            lane.errors += 1
            req._fail(exc if isinstance(exc, MXNetError) else
                      MXNetError("prefill failed: %s" % exc))

    def _start_sequence(self, name, lane, backend, req, resume=None):
        """Allocate pages, run the prefill, join the decode batch.
        ``resume`` re-prefills an existing sequence (hot swap) over
        prompt + already-generated tokens."""
        # on resume the LAST generated token stays out of the prefill: the
        # next decode step writes its K/V, as in the uninterrupted schedule
        tokens = req.prompt if resume is None else _np.concatenate(
            [req.prompt,
             _np.asarray(req.generated[:-1], dtype=_np.int32)])
        t = int(tokens.size)
        lane.seq_counter += 1
        seq_id = "%s/%d" % (name, lane.seq_counter)
        # reserve the whole horizon up front: mid-generation allocation
        # cannot fail, so accepted sequences always run to completion
        budget = int(req.prompt.size) + req.max_new_tokens
        backend.cache.allocate(seq_id, min(budget, backend.cfg["seq_len"]))
        bucket = self._pick_prefill_bucket(lane, t)
        padded = _np.zeros(bucket, dtype=_np.int32)
        padded[:t] = tokens
        last_exc = None
        out = None
        for _ in range(default_retries() + 1):
            if self._killed:
                break
            try:
                out = backend.prefill(padded, t)
                break
            except Exception as exc:  # noqa: BLE001 - fault path
                lane.errors += 1
                last_exc = exc
        if out is None:
            backend.cache.free(seq_id)
            raise MXNetError(
                "model %r: prefill failed after %d attempts: %s"
                % (name, default_retries() + 1, last_exc))
        logits, k, v, cold = out
        lane.compiles += bool(cold)
        # cache writes only after the prefill succeeded
        backend.cache.write_prefill(seq_id, k, v)
        seq = _Sequence(req, seq_id, backend)
        seq.length = t
        if resume is None:
            first = int(_np.argmax(logits))
            req._push(first)
            seq.last_token = first
            seq.new_tokens = 1
        else:
            seq.last_token = int(req.generated[-1])
            seq.new_tokens = resume.new_tokens
        req.seq_id = seq_id
        lane.active.append(seq)

    def _decode_step(self, name, lane, backend):
        """ONE decode step over every live sequence, padded to the decode
        bucket.  Caller holds dispatch_lock."""
        live = lane.active
        n = len(live)
        bucket = lane.entry.pick_bucket(n)
        tokens = _np.zeros(bucket, dtype=_np.int32)
        positions = _np.zeros(bucket, dtype=_np.int32)
        context = _np.ones(bucket, dtype=_np.int32)
        tables = _np.zeros((bucket, backend.max_blocks_per_seq),
                           dtype=_np.int32)
        for i, seq in enumerate(live):
            tokens[i] = seq.last_token
            positions[i] = seq.length
            context[i] = seq.length + 1
            tables[i] = backend.cache.block_table(
                seq.seq_id, backend.max_blocks_per_seq)
        out = None
        last_exc = None
        for _ in range(default_retries() + 1):
            if self._killed:
                break
            try:
                out = backend.decode(tokens, positions, tables, context)
                break
            except Exception as exc:   # noqa: BLE001 - fault path
                lane.errors += 1
                last_exc = exc
        if self._killed:
            for seq in live:
                seq.req._fail(_admission.ReplicaDeadError(
                    "replica %r died mid-generation" % self.name))
            return
        if out is None:
            err = MXNetError(
                "model %r: decode step failed after %d attempts: %s"
                % (name, default_retries() + 1, last_exc))
            for seq in live:
                seq.req._fail(err)
            return
        logits, k_step, v_step, cold = out
        lane.steps += 1
        lane.rows += n
        lane.slots += bucket
        lane.max_step_rows = max(lane.max_step_rows, n)
        lane.compiles += bool(cold)
        # the step succeeded for the whole batch: NOW write its K/V, in
        # one indexed copy per pool
        backend.cache.write_tokens([s.seq_id for s in live],
                                   positions[:n], k_step[:, :n],
                                   v_step[:, :n])
        for i, seq in enumerate(live):
            seq.length += 1
            tok = int(_np.argmax(logits[i]))
            seq.req._push(tok)
            seq.last_token = tok
            seq.new_tokens += 1
            lane.tokens += 1

    # -- lifecycle ----------------------------------------------------

    def stats(self, name):
        """The lane's counters: decode steps, tokens, per-step occupancy,
        the largest step batch (the iteration-level admission witness),
        finished requests, cold shapes, dispatch errors, re-prefills and
        the cache's stats."""
        lane = self._lane(name)
        occ = lane.rows / float(lane.slots) if lane.slots else 0.0
        return {"steps": lane.steps, "tokens": lane.tokens,
                "rows": lane.rows, "slots": lane.slots,
                "occupancy": occ, "max_step_rows": lane.max_step_rows,
                "active": len(lane.active), "requests": lane.requests,
                "compiles": lane.compiles,
                "dispatch_errors": lane.errors,
                "reprefills": lane.reprefills,
                "kv_cache": lane.entry.backend.cache.stats()}

    def drain(self):
        self.admission.start_drain()

    def close(self, timeout=10.0):
        """Drain, let live sequences finish, stop generation threads."""
        self.drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                idle = not any(l.queue or l.active
                               for l in self._lanes.values())
            if idle:
                break
            time.sleep(0.005)
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for lane in list(self._lanes.values()):
            if lane.thread is not None:
                lane.thread.join(timeout=timeout)

    def kill(self):
        """Crash simulation: fail queued and live generations with the
        typed replica-dead error.  Idempotent."""
        with self._cond:
            if self._killed:
                return
            self._killed = True
            orphans = []
            for lane in self._lanes.values():
                orphans.extend(lane.queue.drain())
                orphans.extend(s.req for s in lane.active
                               if not s.req.done)
            self._cond.notify_all()
        err = _admission.ReplicaDeadError(
            "replica %r was killed with the request queued" % self.name)
        for req in orphans:
            req._fail(err)
