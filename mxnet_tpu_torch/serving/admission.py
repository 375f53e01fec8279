"""Admission control and SLO-aware deadlines for the serving tier.

Counterpart of ``mxnet_tpu/serving/admission.py``: the typed, HTTP-mappable
:class:`ServingError` hierarchy and :class:`AdmissionController` (bounded
queues, deadlines checked at admission and again at dispatch, drain mode,
per-tenant quota sheds).  Every shed is counted in
``AdmissionController.rejected``, a plain count keyed by
``(model, reason, tenant)``.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time

from ..base import MXNetError
from ..ops.kv_cache import CacheExhaustedError
from .tenancy import DEFAULT_TENANT

__all__ = ["ServingError", "ServerOverloadedError", "ServerDrainingError",
           "DeadlineExceededError", "UnknownModelError", "ReplicaDeadError",
           "QuotaExceededError", "InvalidDeadlineError",
           "CacheExhaustedError", "AdmissionController", "deadline_from_ms",
           "default_deadline_ms", "max_queue_default", "reject_reason"]


class ServingError(MXNetError):
    """Base class for typed serving rejections; ``http_status`` maps the
    error onto the wire."""

    http_status = 500


class ServerOverloadedError(ServingError):
    """The model's queue is at ``max_queue`` — shed, don't buffer."""

    http_status = 429


class ServerDrainingError(ServingError):
    """The replica is draining: accepted work finishes, new work is
    refused."""

    http_status = 503


class DeadlineExceededError(ServingError):
    """The request's deadline passed — at admission or while queued.
    Expired requests never cost device time."""

    http_status = 504


class UnknownModelError(ServingError):
    """No model registered under that name."""

    http_status = 404


class ReplicaDeadError(ServingError):
    """The replica was killed (or fenced) with this request unanswered."""

    http_status = 503


class QuotaExceededError(ServingError):
    """The tenant's token-bucket budget is exhausted.  ``budget`` names
    which bucket ran dry (``requests`` or ``tokens``) and
    ``retry_after_s`` is the refill time."""

    http_status = 429

    def __init__(self, msg, budget="requests", retry_after_s=None):
        super().__init__(msg)
        self.budget = budget
        self.retry_after_s = retry_after_s


class InvalidDeadlineError(ServingError):
    """``deadline_ms`` was negative or non-finite (0 stays the "no
    deadline" sentinel)."""

    http_status = 400


#: Canonical shed-reason tag per typed rejection.
_REASONS = {
    ServerOverloadedError: "overload",
    DeadlineExceededError: "deadline",
    ServerDrainingError: "draining",
    ReplicaDeadError: "replica_dead",
    UnknownModelError: "unknown_model",
    CacheExhaustedError: "cache_exhausted",
    QuotaExceededError: "quota",
}


def reject_reason(exc):
    """The canonical shed-reason tag for a typed serving error (or for its
    type), ``None`` for anything that is not a typed rejection."""
    return _REASONS.get(exc if isinstance(exc, type) else type(exc))


def default_deadline_ms():
    """``MXNET_TPU_SERVING_DEADLINE_MS`` (0 = no default deadline)."""
    try:
        return float(os.environ.get("MXNET_TPU_SERVING_DEADLINE_MS", "0"))
    except ValueError:
        return 0.0


def max_queue_default():
    """``MXNET_TPU_SERVING_MAX_QUEUE`` (per-model lane bound)."""
    try:
        return int(os.environ.get("MXNET_TPU_SERVING_MAX_QUEUE", "256"))
    except ValueError:
        return 256


def deadline_from_ms(deadline_ms=None, now=None):
    """Relative ``deadline_ms`` → absolute monotonic deadline (seconds),
    or None for no deadline (``0``, or the env default when ``None``).
    Negative, non-finite or non-numeric values raise
    :class:`InvalidDeadlineError`."""
    if deadline_ms is None:
        deadline_ms = default_deadline_ms()
    try:
        deadline_ms = float(deadline_ms)
    except (TypeError, ValueError):
        raise InvalidDeadlineError(
            "deadline_ms must be a number, got %r" % (deadline_ms,))
    if not math.isfinite(deadline_ms):
        raise InvalidDeadlineError(
            "deadline_ms must be finite, got %r" % (deadline_ms,))
    if deadline_ms < 0:
        raise InvalidDeadlineError(
            "deadline_ms must be >= 0 (0 = no deadline), got %r"
            % (deadline_ms,))
    if deadline_ms == 0:
        return None
    return (time.monotonic() if now is None else now) + deadline_ms / 1e3


class AdmissionController(object):
    """Admission policy for one replica: queue bounds, deadline checks,
    drain mode.  ``rejected`` counts every shed by
    ``(model, reason, tenant)``."""

    def __init__(self):
        self.rejected = collections.Counter()
        self._lock = threading.Lock()
        self._draining = False

    @property
    def draining(self):
        return self._draining

    def start_drain(self):
        """Stop admitting; everything already queued still completes."""
        self._draining = True

    def account(self, model, reason, tenant=DEFAULT_TENANT):
        """Count one shed request without raising."""
        with self._lock:
            self.rejected[(model, reason, tenant)] += 1

    def reject(self, model, reason, detail="", tenant=DEFAULT_TENANT):
        """Count a shed request and raise its typed error."""
        self.account(model, reason, tenant)
        if reason == "draining":
            raise ServerDrainingError(
                "model %r: replica is draining%s" % (model, detail))
        if reason == "deadline":
            raise DeadlineExceededError(
                "model %r: deadline exceeded%s" % (model, detail))
        raise ServerOverloadedError(
            "model %r: queue full%s" % (model, detail))

    def quota_reject(self, model, tenant, budget, wait_s):
        """Count a quota shed and raise the typed 429 naming the budget."""
        self.account(model, "quota", tenant)
        raise QuotaExceededError(
            "model %r: tenant %r exhausted its %s budget (retry in "
            "%.2fs)" % (model, tenant, budget, wait_s),
            budget=budget, retry_after_s=wait_s)

    def admit(self, model, depth, max_queue, deadline, now=None,
              tenant=DEFAULT_TENANT):
        """Gate one request at the door: raise the typed rejection or
        return silently."""
        if self._draining:
            self.reject(model, "draining", tenant=tenant)
        now = time.monotonic() if now is None else now
        if deadline is not None and now >= deadline:
            self.reject(model, "deadline", " (expired at admission)",
                        tenant=tenant)
        if depth >= max_queue:
            self.reject(model, "overload",
                        " (depth %d >= max_queue %d)" % (depth, max_queue),
                        tenant=tenant)

    @staticmethod
    def expired(deadline, now=None):
        """Second check, at dispatch time."""
        if deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= deadline
