"""Device context (the JAX package's ``context.py``) and device resolution.

A :class:`Context` names a device: ``cpu()`` the host, ``gpu(i)`` the CUDA
card ``i``.  ``tpu(i)`` names the same card, so scripts written against the
JAX package (where ``gpu`` is an alias of ``tpu``) run unchanged.  A
context stack (``with mx.cpu():``) supplies the default; with nothing
pushed the default is the current CUDA card, and when CUDA is not
available that is an error naming ``cpu()``, never a quiet move to the CPU.

The entry points below the Module API take a ``device``:
:func:`resolve_device` turns ``None`` or a device string into a
``torch.device``; ``"cpu"`` must be asked for by name (the tests do, to
compare the port's plain versions with the JAX package).
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "current_context", "gpu", "resolve_device",
           "tpu"]

_NO_CUDA = ("no CUDA device is available; pass device='cpu' (or use "
            "mx.cpu()) to run the plain PyTorch versions on the CPU")


def resolve_device(device=None):
    """``None`` or ``"cuda"`` → the current CUDA device; ``"cpu"`` → the
    CPU.  Raises :class:`MXNetError` when CUDA is asked for (or defaulted
    to) and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("mxnet_tpu_torch runs on 'cuda' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise MXNetError(_NO_CUDA)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Context:
    """Device context: ``device_type`` ``"cpu"`` or ``"gpu"`` (``"tpu"``
    is accepted and names the card), and ``device_id``.  The numeric codes
    are the JAX package's."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 2}
    devid2type = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}

    _state = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devtype2id[device_type]
            self.device_id = device_id

    @property
    def device_type(self):
        return Context.devid2type[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        _ctx_stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        _ctx_stack().pop()

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes (raises for the card
        when CUDA is not available)."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(_NO_CUDA)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s out of range: %d CUDA device(s) "
                             "visible" % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_device(device):
        """The context of a ``torch.device``."""
        device = torch.device(device)
        if device.type == "cpu":
            return cpu()
        if device.type == "cuda":
            return gpu(device.index if device.index is not None
                       else torch.cuda.current_device())
        raise MXNetError("no context for device %s" % device)


def _ctx_stack():
    st = getattr(Context._state, "stack", None)
    if st is None:
        st = Context._state.stack = []
    return st


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The same card as :func:`gpu`: scripts written for the JAX package's
    native context run on the card unchanged."""
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` context; with none pushed, the current
    CUDA card (an error without CUDA, naming ``cpu()``)."""
    stack = _ctx_stack()
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError(_NO_CUDA)
    return gpu(torch.cuda.current_device())
