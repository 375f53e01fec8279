"""Operator registry of the port (the JAX package's ``ops/registry.py``).

One registry; each op's compute rule is a function on torch tensors, and
:mod:`~mxnet_tpu_torch.symbol` composes graphs of them that
:mod:`~mxnet_tpu_torch.executor` runs.  An op declares:

* ``arg_names`` -- positional tensor inputs; missing ones auto-materialize
  as variables when a Symbol is composed (``{name}_weight`` ...).
* ``aux_names`` -- auxiliary states; the rule returns their new values
  after the outputs.
* ``params`` -- the attribute spec (name -> :class:`ParamSpec`): typed,
  defaulted and parseable from strings.
* ``fn(attrs, *tensors)`` -- the compute rule; with ``needs_mode`` it also
  takes ``is_train=`` (``BatchNorm`` uses batch statistics and updates its
  moving ones only when training).

The JAX registry also carries a variant seam that runs a fused variant and,
when the variant raises, books a fallback and runs the stock rule instead
(``registry.py:201-208``, ``:455-468``).  The port has no such seam: an
op's rule calls its kernel wrapper, which launches the kernel for a CUDA
tensor or raises.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Sequence

from ..base import MXNetError

__all__ = ["OP_REGISTRY", "Op", "P", "ParamSpec", "get_op", "list_ops",
           "register"]

OP_REGISTRY: Dict[str, "Op"] = {}
_ALIAS: Dict[str, str] = {}


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    if isinstance(s, (int, float)):
        return bool(s)
    s = s.strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise ValueError("cannot parse bool from %r" % s)


def parse_shape(s):
    """A shape attribute (tuple, int or its string form) → tuple of ints."""
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    if isinstance(s, int):
        return (s,)
    s = s.strip()
    if s in ("None", ""):
        return None
    val = ast.literal_eval(s)
    if isinstance(val, (int, float)):
        return (int(val),)
    return tuple(int(x) for x in val)


class ParamSpec:
    """One attribute of an op (the ``DMLC_DECLARE_FIELD`` equivalent)."""

    __slots__ = ("type", "default", "required", "enum")

    def __init__(self, type="str", default=None, required=False, enum=None):
        self.type = type
        self.default = default
        self.required = required
        self.enum = enum

    def parse(self, value):
        if value is None:
            return None
        t = self.type
        if t == "int":
            return int(value)
        if t == "float":
            return float(value)
        if t == "bool":
            return _parse_bool(value)
        if t == "shape":
            return parse_shape(value)
        if t == "str":
            v = str(value)
            if self.enum is not None and v not in self.enum:
                raise MXNetError("invalid value %r; expected one of %s"
                                 % (v, self.enum))
            return v
        raise MXNetError("unknown param type %r" % (t,))


P = ParamSpec


class Op:
    """A registered operator."""

    def __init__(self, name: str, fn: Callable,
                 arg_names: Sequence[str] = ("data",),
                 aux_names: Sequence[str] = (), num_outputs=1,
                 params: Optional[Dict[str, ParamSpec]] = None,
                 input_names_fn: Optional[Callable] = None,
                 needs_mode: bool = False):
        self.name = name
        self.fn = fn
        self.arg_names = list(arg_names)
        self.aux_names = list(aux_names)
        self.num_outputs = num_outputs
        self.params = params or {}
        self.input_names_fn = input_names_fn
        self.needs_mode = needs_mode

    def parse_attrs(self, kwargs: Dict) -> Dict:
        """Validate and parse keyword attributes into an attrs dict."""
        attrs = {}
        for k, v in kwargs.items():
            if k not in self.params:
                raise MXNetError("%s got unknown attribute %r (known: %s)"
                                 % (self.name, k, sorted(self.params)))
            attrs[k] = self.params[k].parse(v)
        for k, spec in self.params.items():
            if k not in attrs:
                if spec.required:
                    raise MXNetError("%s missing required attribute %r"
                                     % (self.name, k))
                attrs[k] = spec.default
        return attrs

    def n_outputs(self, attrs) -> int:
        return self.num_outputs

    def input_names(self, attrs) -> List[str]:
        if self.input_names_fn is not None:
            return list(self.input_names_fn(attrs))
        return self.arg_names

    def apply(self, attrs, args, auxs=(), is_train=False):
        """Run the compute rule; returns ``(outputs, new_aux)`` lists.
        ``is_train`` reaches only the ops that declare ``needs_mode``."""
        kw = {"is_train": is_train} if self.needs_mode else {}
        out = self.fn(attrs, *args, *auxs, **kw)
        if not isinstance(out, tuple):
            out = (out,)
        n_out = self.n_outputs(attrs)
        outputs, new_aux = list(out[:n_out]), list(out[n_out:])
        if len(outputs) != n_out or len(new_aux) != len(self.aux_names):
            raise MXNetError("%s returned %d tensors; expected %d outputs + "
                             "%d aux" % (self.name, len(out), n_out,
                                         len(self.aux_names)))
        return outputs, new_aux

    def __repr__(self):
        return "Op(%s)" % self.name


def register(name, aliases=(), **kwargs):
    """Decorator: register ``fn`` as op ``name`` (and its aliases)."""

    def deco(fn):
        OP_REGISTRY[name] = Op(name, fn, **kwargs)
        for a in aliases:
            _ALIAS[a] = name
        return fn

    return deco


def get_op(name: str) -> Op:
    if name in OP_REGISTRY:
        return OP_REGISTRY[name]
    if name in _ALIAS:
        return OP_REGISTRY[_ALIAS[name]]
    raise MXNetError("operator %r is not registered in mxnet_tpu_torch"
                     % name)


def list_ops() -> List[str]:
    return sorted(set(OP_REGISTRY) | set(_ALIAS))
