"""Multi-tenant fairness primitives: weights, token buckets, DRR queues.

Counterpart of ``mxnet_tpu/serving/tenancy.py``, copied so the port needs
nothing of the JAX package.

- :class:`FairQueue` — **deficit round-robin** (Shreedhar & Varghese,
  SIGCOMM '95) over per-tenant FIFO queues.  Each service rotation
  credits every backlogged tenant's deficit with its weight and pops
  one request per whole credit, so throughput under contention
  converges to the weight ratio while each tenant stays FIFO
  internally.  A tenant with **zero weight** is a background class:
  served only when every weighted tenant is idle.  A single backlogged
  tenant short-circuits to a plain FIFO pop.
- :class:`TokenBucket` — the classic refill-at-rate bucket with an
  **injectable clock** (tests drive refill without sleeping).  A
  failed take consumes nothing and returns the seconds until the
  debit would succeed — the ``Retry-After`` hint.
- :class:`TenantPolicy` — per-tenant weights and quota buckets
  (requests/s and generated-tokens/s), env-tunable defaults plus
  per-tenant overrides, buckets minted lazily so a tenant appearing
  mid-run is admitted without pre-registration.

Env knobs (the JAX package's names): ``MXNET_TPU_TENANT_WEIGHTS``
(``tenant=weight,...``), ``MXNET_TPU_TENANT_RPS`` /
``MXNET_TPU_TENANT_TPS`` (default per-tenant budgets; 0 = unlimited),
``MXNET_TPU_TENANT_BURST_S`` (bucket depth in seconds of budget), and
``MXNET_TPU_TENANT_QUOTAS`` (``tenant:rps=N:tps=N,...`` overrides).

Queues are *not* internally locked: the schedulers mutate them only
under their own condition-variable lock.  :class:`TenantPolicy` carries
its own lock because quota charges happen on submitter threads.
"""

from __future__ import annotations

import collections
import os
import threading
import time

__all__ = ["DEFAULT_TENANT", "TokenBucket", "TenantPolicy", "FairQueue",
           "clean_tenant", "default_weights", "default_rps",
           "default_tps", "default_burst_s", "quota_overrides"]

#: The tenant every unlabeled request belongs to — the back-compat
#: single-tenant world is "everyone is ``default``".
DEFAULT_TENANT = "default"

_TENANT_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def clean_tenant(raw):
    """Normalize a wire-supplied tenant label: strip, cap at 64 chars,
    map characters outside ``[A-Za-z0-9._-]`` to ``_`` (tenant is a
    metric label — a hostile header must not corrupt the exposition),
    empty/None → :data:`DEFAULT_TENANT`."""
    if raw is None:
        return DEFAULT_TENANT
    raw = str(raw).strip()[:64]
    if not raw:
        return DEFAULT_TENANT
    return "".join(c if c in _TENANT_OK else "_" for c in raw)


def _parse_map(raw):
    """``a=1.5,b=2`` → ``{"a": 1.5, "b": 2.0}`` (bad entries dropped)."""
    out = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            out[clean_tenant(name)] = float(val)
        except ValueError:
            continue
    return out


def default_weights():
    """``MXNET_TPU_TENANT_WEIGHTS``: ``tenant=weight,...`` — DRR share
    under contention (0 = background class).  Unlisted tenants weigh 1."""
    return _parse_map(os.environ.get("MXNET_TPU_TENANT_WEIGHTS"))


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return float(default)


def default_rps():
    """``MXNET_TPU_TENANT_RPS``: default per-tenant requests/second
    budget (0 = unlimited, the back-compat default)."""
    return _env_float("MXNET_TPU_TENANT_RPS", 0.0)


def default_tps():
    """``MXNET_TPU_TENANT_TPS``: default per-tenant generated-tokens/
    second budget, reserved at admission via ``max_new_tokens``
    (0 = unlimited)."""
    return _env_float("MXNET_TPU_TENANT_TPS", 0.0)


def default_burst_s():
    """``MXNET_TPU_TENANT_BURST_S``: bucket depth, in seconds of
    budget — a tenant may burst ``rate * burst_s`` before the rate
    limit bites."""
    return _env_float("MXNET_TPU_TENANT_BURST_S", 2.0)


def quota_overrides():
    """``MXNET_TPU_TENANT_QUOTAS``: per-tenant overrides,
    ``tenant:rps=N:tps=N`` comma-separated (either key may be
    omitted).  Returns ``{tenant: {"rps": N, "tps": N}}``."""
    out = {}
    for part in (os.environ.get("MXNET_TPU_TENANT_QUOTAS") or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        tenant = clean_tenant(fields[0])
        spec = {}
        for f in fields[1:]:
            key, _, val = f.partition("=")
            if key not in ("rps", "tps"):
                continue
            try:
                spec[key] = float(val)
            except ValueError:
                continue
        if spec:
            out[tenant] = spec
    return out


class TokenBucket(object):
    """Refill-at-``rate`` token bucket with injectable time.

    ``rate <= 0`` disables the bucket (every take succeeds).  A failed
    :meth:`take` consumes **nothing** and returns the seconds until the
    debit would succeed — the caller's ``Retry-After`` hint.
    """

    __slots__ = ("rate", "burst", "level", "_t")

    def __init__(self, rate, burst=None, now=None):
        self.rate = float(rate)
        if burst is None:
            burst = max(self.rate * default_burst_s(), 1.0)
        self.burst = max(float(burst), 1.0)
        self.level = self.burst
        self._t = time.monotonic() if now is None else float(now)

    def _refill(self, now):
        if now > self._t:
            self.level = min(self.burst,
                             self.level + (now - self._t) * self.rate)
        self._t = max(self._t, now)

    def take(self, n=1.0, now=None):
        """Debit ``n`` tokens.  Returns ``0.0`` on success, else the
        seconds until ``n`` tokens will be available (nothing
        consumed)."""
        if self.rate <= 0:
            return 0.0
        now = time.monotonic() if now is None else float(now)
        self._refill(now)
        n = float(n)
        if self.level >= n:
            self.level -= n
            return 0.0
        return (n - self.level) / self.rate

    def put(self, n=1.0):
        """Refund ``n`` tokens (a compound charge whose second leg
        failed)."""
        self.level = min(self.burst, self.level + float(n))


class TenantPolicy(object):
    """Per-tenant weights + quota buckets for one replica group.

    Buckets are minted lazily on first sight, so a tenant appearing
    mid-run needs no registration step.  Thread-safe: quota charges
    happen on submitter threads."""

    def __init__(self, weights=None, rps=None, tps=None, burst_s=None,
                 overrides=None):
        self._lock = threading.Lock()
        self.weights = dict(default_weights())
        if weights:
            self.weights.update({clean_tenant(t): float(w)
                                 for t, w in weights.items()})
        self._rps = default_rps() if rps is None else float(rps)
        self._tps = default_tps() if tps is None else float(tps)
        self._burst_s = (default_burst_s() if burst_s is None
                         else float(burst_s))
        self._overrides = dict(quota_overrides())
        if overrides:
            for t, spec in overrides.items():
                self._overrides.setdefault(clean_tenant(t), {}).update(spec)
        self._buckets = {}   # tenant -> (request_bucket, token_bucket)

    def weight(self, tenant):
        """DRR weight for ``tenant`` (1.0 unless configured; 0 =
        background class)."""
        return float(self.weights.get(tenant, 1.0))

    def set_weight(self, tenant, weight):
        self.weights[clean_tenant(tenant)] = float(weight)

    def set_quota(self, tenant, rps=None, tps=None):
        """Programmatic per-tenant override; drops any existing buckets
        so new rates take effect immediately."""
        tenant = clean_tenant(tenant)
        with self._lock:
            spec = self._overrides.setdefault(tenant, {})
            if rps is not None:
                spec["rps"] = float(rps)
            if tps is not None:
                spec["tps"] = float(tps)
            self._buckets.pop(tenant, None)

    def _pair(self, tenant, now):
        pair = self._buckets.get(tenant)
        if pair is None:
            spec = self._overrides.get(tenant, {})
            rps = float(spec.get("rps", self._rps))
            tps = float(spec.get("tps", self._tps))
            pair = (TokenBucket(rps, burst=max(rps * self._burst_s, 1.0),
                                now=now),
                    TokenBucket(tps, burst=max(tps * self._burst_s, 1.0),
                                now=now))
            self._buckets[tenant] = pair
        return pair

    def limited(self, tenant):
        """True when ``tenant`` has any finite budget configured (the
        unlimited case must stay a constant-time no-op)."""
        if self._rps > 0 or self._tps > 0:
            return True
        spec = self._overrides.get(tenant)
        return bool(spec and (spec.get("rps", 0) > 0
                              or spec.get("tps", 0) > 0))

    def charge(self, tenant, tokens=0, now=None):
        """Charge one request (plus ``tokens`` reserved generation
        tokens) against ``tenant``'s budgets.  Returns ``None`` on
        success or ``(budget_name, retry_after_s)`` naming the
        exhausted budget — nothing is consumed on failure."""
        if not self.limited(tenant):
            return None
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            req_bucket, tok_bucket = self._pair(tenant, now)
            wait = req_bucket.take(1.0, now)
            if wait > 0:
                return ("requests", wait)
            if tokens and tokens > 0:
                wait = tok_bucket.take(float(tokens), now)
                if wait > 0:
                    req_bucket.put(1.0)   # compound charge: refund leg 1
                    return ("tokens", wait)
        return None


class FairQueue(object):
    """Deficit round-robin over per-tenant FIFO queues.

    Drop-in for the scheduler lane deques: ``push`` / ``take(n)`` /
    ``drain`` / ``len``.  NOT internally locked — callers hold their
    scheduler's condition lock, exactly as with the deque."""

    __slots__ = ("_weight", "_queues", "_deficit", "_len")

    def __init__(self, weight_fn=None):
        self._weight = weight_fn or (lambda tenant: 1.0)
        self._queues = collections.OrderedDict()  # arrival-ordered
        self._deficit = {}
        self._len = 0

    def __len__(self):
        return self._len

    def push(self, tenant, item):
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
        q.append(item)
        self._len += 1

    def depth(self, tenant):
        q = self._queues.get(tenant)
        return len(q) if q is not None else 0

    def tenants(self):
        """Tenants with queued work, in arrival order."""
        return [t for t, q in self._queues.items() if q]

    def drain(self):
        """Pop everything (kill path); returns the requests in tenant
        arrival order."""
        out = []
        for q in self._queues.values():
            while q:
                out.append(q.popleft())
        self._deficit.clear()
        self._len = 0
        return out

    def _pop(self, tenant, q, out):
        out.append(q.popleft())
        self._len -= 1

    def take(self, n):
        """Pop up to ``n`` requests by DRR share.  Weighted tenants are
        credited ``weight`` per rotation and served one request per
        whole credit; zero-weight tenants are the background class,
        round-robined only once every weighted queue is empty."""
        out = []
        if n <= 0 or self._len == 0:
            return out
        active = [t for t, q in self._queues.items() if q]
        if len(active) == 1:
            # fast path: one backlogged tenant (incl. the default-only
            # world) is plain FIFO — no deficit bookkeeping
            t = active[0]
            q = self._queues[t]
            while q and len(out) < n:
                self._pop(t, q, out)
            self._deficit.pop(t, None)
            return out
        weighted = [t for t in active if self._weight(t) > 0]
        while weighted and len(out) < n:
            for t in list(weighted):
                if len(out) >= n:
                    break
                q = self._queues[t]
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + self._weight(t))
                while q and self._deficit[t] >= 1.0 and len(out) < n:
                    self._pop(t, q, out)
                    self._deficit[t] -= 1.0
                if not q:
                    # empty queue forfeits its deficit (standard DRR:
                    # credit never accrues while idle)
                    self._deficit.pop(t, None)
                    weighted.remove(t)
        background = [t for t in active
                      if self._weight(t) <= 0 and self._queues[t]]
        while background and len(out) < n:
            for t in list(background):
                if len(out) >= n:
                    break
                q = self._queues[t]
                if q:
                    self._pop(t, q, out)
                if not q:
                    background.remove(t)
        return out
