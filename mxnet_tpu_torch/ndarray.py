"""NDArray: the imperative array type (the JAX package's ``ndarray.py``).

An :class:`NDArray` wraps one ``torch.Tensor`` on an explicit device.
Writes go into the tensor's own storage, under ``torch.no_grad()``:
``a[:] = x``, ``a += x``, ``copyto`` and every op called with ``out=``
(``nd.sgd_mom_update(w, g, m, out=[w, m])``).  An :class:`~.executor.
Executor` that holds the array therefore sees the write without a rebind,
as the reference's in-place engine writes do.

Every registered op of the port is a function of this module
(``nd.FullyConnected``, ``nd.sgd_mom_update``, ...), generated from the
registry at import time, as the JAX package generates ``mx.nd.*``; an op
the registry lacks raises, naming it.  ``save``/``load`` keep the JAX
package's file format (an npz with a ``__mx_format__`` entry), so
parameter files and checkpoints move between the two packages both ways.

Arrays are made on the current context (:func:`~.context.current_context`:
the card unless ``with mx.cpu():`` or ``ctx=`` says otherwise).
"""

from __future__ import annotations

import io as _io
import os
import sys
import tempfile

import numpy as _np
import torch

from .base import MXNetError, np_dtype, numeric_types, torch_dtype
from .context import Context, current_context
from .ops.registry import get_op, list_ops

__all__ = ["NDArray", "UnknownOpError", "arange", "array", "concatenate",
           "empty", "full", "invoke", "load", "load_frombuffer", "ones",
           "save", "waitall", "zeros"]


class NDArray:
    """Multi-dimensional array on one device (a ``torch.Tensor``)."""

    __slots__ = ("_data",)

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        if not torch.is_tensor(data):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(data))
        self._data = data

    # -- basic properties ---------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` for bf16, which numpy
        lacks)."""
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.from_device(self._data.device)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self.context)

    def asnumpy(self):
        """A numpy copy (bf16 values as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    # -- conversion / movement ----------------------------------------
    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype)))

    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Into ``other``'s storage (an NDArray of the same shape), or a
        new array on ``other`` (a Context)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError("copyto shape mismatch: %s vs %s"
                                 % (self.shape, other.shape))
            other._write(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    # -- mutation ------------------------------------------------------
    def _write(self, value, key=None):
        """Write ``value`` (a tensor, array-like or number) into this
        array's storage, all of it or ``[key]``."""
        if not torch.is_tensor(value):
            value = torch.as_tensor(_np.asarray(value, dtype=self.dtype)
                                    if self._data.dtype != torch.bfloat16
                                    else _np.asarray(value, _np.float32))
        with torch.no_grad():
            if key is None:
                self._data.copy_(value.broadcast_to(self.shape))
            else:
                self._data[key] = value.to(self._data.device,
                                           self._data.dtype)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(key, slice) and key == slice(None) or key is Ellipsis:
            key = None
        self._write(value, key)

    def __getitem__(self, key):
        return NDArray(self._data[key])

    def reshape(self, shape):
        return NDArray(self._data.reshape(shape))

    # -- arithmetic, through the registered ops ------------------------
    def _binary(self, other, op_name, scalar_op, swap=False):
        if isinstance(other, numeric_types):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        if not isinstance(other, NDArray):
            other = NDArray(torch.as_tensor(_np.asarray(other)).to(
                self._data.device, self._data.dtype))
        return invoke(op_name, [other, self] if swap else [self, other])

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar",
                            swap=True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar",
                            swap=True)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __neg__(self):
        return invoke("negative", [self])

    def _inplace(self, other, op_name, scalar_op):
        self._write(self._binary(other, op_name, scalar_op)._data)
        return self

    def __iadd__(self, other):
        return self._inplace(other, "broadcast_add", "_plus_scalar")

    def __isub__(self, other):
        return self._inplace(other, "broadcast_sub", "_minus_scalar")

    def __imul__(self, other):
        return self._inplace(other, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, other):
        return self._inplace(other, "broadcast_div", "_div_scalar")

    def _compare(self, other, fn):
        o = other._data if isinstance(other, NDArray) else other
        return NDArray(fn(self._data, o).to(self._data.dtype))

    def __eq__(self, other):
        if isinstance(other, (NDArray,) + numeric_types):
            return self._compare(other, torch.eq)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray,) + numeric_types):
            return self._compare(other, torch.ne)
        return NotImplemented

    def __gt__(self, other):
        return self._compare(other, torch.gt)

    def __ge__(self, other):
        return self._compare(other, torch.ge)

    def __lt__(self, other):
        return self._compare(other, torch.lt)

    def __le__(self, other):
        return self._compare(other, torch.le)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")


# ----------------------------------------------------------------------
# creation
# ----------------------------------------------------------------------


def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like.  numpy arrays keep their dtype,
    except float64 → float32 and int64 → int32 (the JAX package's rule);
    anything else is float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    if torch.is_tensor(source_array):
        source_array = source_array.detach().cpu().numpy()
    if dtype is None:
        dtype = _np.float32
        if isinstance(source_array, _np.ndarray):
            dtype = {_np.dtype(_np.float64): _np.float32,
                     _np.dtype(_np.int64): _np.int32}.get(
                         source_array.dtype, source_array.dtype)
    tdtype = torch_dtype(dtype)
    host = torch.from_numpy(_np.array(
        source_array, dtype=_np.float32 if tdtype == torch.bfloat16
        else dtype))
    return NDArray(host.to(_device(ctx), tdtype))


def empty(shape, ctx=None, dtype=None):
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    out = _np.arange(start, stop, step)
    if repeat > 1:
        out = _np.repeat(out, repeat)
    return array(out, ctx, dtype=dtype or _np.float32)


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def waitall():
    """Wait for all work queued on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ----------------------------------------------------------------------
# serialization: the JAX package's npz container with a manifest
# ----------------------------------------------------------------------


def _save_npz(fname, arrays, fmt):
    """Write atomically (temporary file, then rename), so a crash never
    leaves a truncated file at ``fname``."""
    d = os.path.dirname(os.path.abspath(fname)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".mxtpu_save_", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            _np.savez(f, __mx_format__=fmt, **arrays)
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(fname, data):
    """Save an NDArray, a list of them or a ``{str: NDArray}`` dict."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: v.asnumpy() for k, v in data.items()}
        fmt = "dict"
    else:
        arrays = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
        fmt = "list"
    _save_npz(fname, arrays, fmt)


def load(fname, ctx=None):
    """Load what :func:`save` (of either package) wrote, onto ``ctx``."""
    with _np.load(fname, allow_pickle=False) as f:
        fmt = str(f["__mx_format__"]) if "__mx_format__" in f else "dict"
        keys = [k for k in f.files if k != "__mx_format__"]
        if fmt == "list":
            keys = sorted(keys, key=lambda k: int(k.split("_")[1]))
            return [array(f[k], ctx) for k in keys]
        return {k: array(f[k], ctx) for k in keys}


def load_frombuffer(buf, ctx=None):
    """:func:`load` from the file's bytes."""
    return load(_io.BytesIO(buf), ctx)


# ----------------------------------------------------------------------
# imperative op calls and the nd.<op> namespace
# ----------------------------------------------------------------------


def invoke(op_name, args, kwargs=None, out=None, is_train=False):
    """Run registered op ``op_name`` on NDArrays (or numbers), under
    ``torch.no_grad()``, on the arrays' device.  Trailing arguments past
    the op's inputs are its auxiliary states, updated in place.  With
    ``out`` (an NDArray or a list) the outputs are written into those
    arrays' storage and ``out`` is returned; an op that declares
    ``writes_out`` writes them there itself."""
    op = get_op(op_name)
    kwargs = dict(kwargs or {})
    kwargs.pop("name", None)
    ctx = kwargs.pop("ctx", None)
    attrs = op.parse_attrs(kwargs)
    arrays = [a for a in args if isinstance(a, NDArray)]
    device = arrays[0]._data.device if arrays else _device(
        ctx if isinstance(ctx, Context) else None)
    tensors = [a._data if isinstance(a, NDArray)
               else torch.as_tensor(a, device=device) for a in args]
    n_args = len(op.input_names(attrs))
    ins, auxs = tensors[:n_args], tensors[n_args:]
    if auxs and len(auxs) != len(op.aux_names):
        raise MXNetError("%s takes %d inputs and %d auxiliary states, got "
                         "%d arrays" % (op_name, n_args, len(op.aux_names),
                                        len(tensors)))
    outs = None if out is None else (
        list(out) if isinstance(out, (list, tuple)) else [out])
    with torch.no_grad():
        if outs is not None and op.writes_out:
            results, new_aux = op.apply(attrs, ins, auxs, is_train,
                                        out=[o._data for o in outs])
        else:
            results, new_aux = op.apply(attrs, ins, auxs, is_train)
        for aux, new in zip(args[n_args:], new_aux):
            if isinstance(aux, NDArray):
                aux._write(new)
        if outs is None:
            results = [NDArray(r) for r in results]
            return results[0] if len(results) == 1 else results
        for o, r in zip(outs, results):
            if r is not o._data:
                o._write(r)
    return out


def _make_nd_fn(op_name):
    op = get_op(op_name)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        pos = list(args)
        for nm in op.arg_names:   # tensor inputs may come by keyword
            if nm in kwargs:
                pos.append(kwargs.pop(nm))
        return invoke(op_name, pos, kwargs, out=out)

    fn.__name__ = op_name
    fn.__doc__ = "Imperative op %r of the port's registry." % op_name
    return fn


class UnknownOpError(MXNetError, AttributeError):
    """``nd.<name>`` of an op the port's registry lacks (an
    ``AttributeError`` too, so ``hasattr`` reads False)."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise UnknownOpError("operator %r is not registered in mxnet_tpu_torch"
                         % name)


def _init_module():
    mod = sys.modules[__name__]
    for name in list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_nd_fn(name))
        public = name[1:] if name.startswith("_") else name
        if public and not hasattr(mod, public):
            setattr(mod, public, _make_nd_fn(name))


_init_module()
