"""Model registry + the serving-backend protocol.

Counterpart of ``mxnet_tpu/serving/registry.py``: :class:`Backend` and
:class:`ModelRegistry` with atomic hot reload.  :meth:`ModelRegistry.swap`
replaces a model's backend under the entry's ``dispatch_lock``, which the
generation loop holds for every dispatch, so a step is computed entirely by
the old backend or entirely by the new.  The JAX package's Predictor and
exported-artifact backends are not part of this slice.
"""

from __future__ import annotations

import os
import threading

from ..base import MXNetError
from . import admission as _admission

__all__ = ["Backend", "ModelRegistry", "as_backend", "default_buckets"]


def default_buckets():
    """``MXNET_TPU_SERVING_BUCKETS`` (comma-separated batch sizes)."""
    raw = os.environ.get("MXNET_TPU_SERVING_BUCKETS", "1,2,4,8")
    try:
        buckets = sorted({int(b) for b in raw.split(",") if b.strip()})
    except ValueError:
        buckets = [1, 2, 4, 8]
    return [b for b in buckets if b > 0] or [1]


class Backend(object):
    """Serving-backend protocol.

    ``input_shapes``  dict name -> **per-sample** shape (no batch dim).
    ``buckets``       fixed bucket list, or None to accept the
                      registry's configured buckets.
    ``infer(batch)``  run one padded ``{name: [B, ...]}`` batch; returns
                      ``(outputs, cold)``: a list of ``[B, ...]`` numpy
                      arrays, and True on the first visit of this shape.
    """

    input_shapes = None
    buckets = None

    def infer(self, batch):
        raise NotImplementedError


def as_backend(obj):
    """Check that ``obj`` serves the :class:`Backend` protocol."""
    if isinstance(obj, Backend):
        return obj
    raise MXNetError("cannot serve %r (want a Backend)"
                     % (type(obj).__name__,))


class _Entry(object):
    """One registered model: the (swappable) backend + batching policy.
    ``dispatch_lock`` serializes device dispatch with backend swaps."""

    __slots__ = ("name", "backend", "buckets", "max_queue",
                 "tenant_weights", "dispatch_lock", "swaps_waiting",
                 "swap_cond")

    def __init__(self, name, backend, buckets, max_queue,
                 tenant_weights=None):
        self.name = name
        self.backend = backend
        self.buckets = buckets
        self.max_queue = max_queue
        self.tenant_weights = dict(tenant_weights) if tenant_weights \
            else {}
        self.dispatch_lock = threading.Lock()
        # hot swaps blocked on dispatch_lock: the lock is not fair, so a
        # dispatch loop calls wait_for_swaps() between dispatches, which
        # blocks on swap_cond until they have landed
        self.swaps_waiting = 0
        self.swap_cond = threading.Condition()

    def wait_for_swaps(self):
        """Block while a hot swap waits for ``dispatch_lock``.  Call it
        without holding ``dispatch_lock``."""
        with self.swap_cond:
            self.swap_cond.wait_for(lambda: not self.swaps_waiting)

    def pick_bucket(self, n):
        """Smallest bucket >= n; the largest bucket caps a window."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]


class ModelRegistry(object):
    """Name → entry map shared by the schedulers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}

    def register(self, name, backend, buckets=None, max_queue=None,
                 tenant_weights=None):
        """Register ``backend`` under ``name``.  ``buckets`` defaults to
        the backend's own list or ``MXNET_TPU_SERVING_BUCKETS``;
        ``max_queue`` to ``MXNET_TPU_SERVING_MAX_QUEUE``."""
        backend = as_backend(backend)
        if buckets is None:
            buckets = backend.buckets or default_buckets()
        buckets = sorted({int(b) for b in buckets})
        if backend.buckets is not None and buckets != backend.buckets:
            raise MXNetError(
                "model %r: backend serves fixed buckets %r, got %r"
                % (name, backend.buckets, buckets))
        if max_queue is None:
            max_queue = _admission.max_queue_default()
        with self._lock:
            if name in self._entries:
                raise MXNetError("model %r already registered (use swap "
                                 "for hot reload)" % name)
            entry = _Entry(name, backend, buckets, int(max_queue),
                           tenant_weights=tenant_weights)
            self._entries[name] = entry
        return entry

    def swap(self, name, backend):
        """Atomically replace ``name``'s backend between dispatches; the
        new backend must serve the same input signature.  Returns the old
        backend."""
        backend = as_backend(backend)
        entry = self.get(name)
        if backend.input_shapes != entry.backend.input_shapes:
            raise MXNetError(
                "model %r: hot reload changed input shapes %r -> %r"
                % (name, entry.backend.input_shapes, backend.input_shapes))
        if backend.buckets is not None and backend.buckets != entry.buckets:
            raise MXNetError(
                "model %r: hot reload changed buckets %r -> %r"
                % (name, entry.buckets, backend.buckets))
        with entry.swap_cond:
            entry.swaps_waiting += 1
        try:
            with entry.dispatch_lock:
                old, entry.backend = entry.backend, backend
        finally:
            with entry.swap_cond:
                entry.swaps_waiting -= 1
                entry.swap_cond.notify_all()
        return old

    def get(self, name):
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise _admission.UnknownModelError(
                "no model registered as %r" % (name,))
        return entry
