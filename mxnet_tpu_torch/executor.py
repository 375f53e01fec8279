"""Executor: running a Symbol graph (the JAX package's ``executor.py``).

:func:`graph_fn` turns a Symbol into ``run(args, aux, rng, is_train) ->
(outputs, new_aux)`` over ``{name: tensor}`` dicts: each node's compute
rule runs eagerly in topological order, and autograd records the graph, so
the caller differentiates the outputs with ``torch.autograd`` where the
JAX package takes ``jax.vjp`` of the traced function.

:class:`Executor` binds a graph to NDArrays (``Symbol.simple_bind`` /
``Symbol.bind``).  ``forward(is_train=True)`` runs the graph once under
autograd, with each argument that takes a gradient as a leaf that shares
its NDArray's storage; ``backward()`` runs ``torch.autograd.backward``
from those outputs.  The JAX executor instead defers a training forward
and runs one fused forward + vjp in ``backward()``; the port never runs
the forward twice either.  ``grad_req`` ``write`` / ``add`` / ``null``
copy the gradient into the bound array, add it to the array, or take none;
the array keeps its storage, so whoever holds its tensor sees the new
gradient (a copy moves half the bytes of zeroing the array and letting
autograd accumulate into it).

Placement across devices (``ctx_group`` / ``group2ctx``), per-block
rematerialization (``__remat__``), memory shared between executors
(``shared_exec``) and monitor callbacks are later slices:
a graph or a call that asks for them raises rather than running without
them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .symbol import Symbol, infer

__all__ = ["Executor", "graph_fn"]

_DEFERRED_ATTRS = ("__remat__", "ctx_group")


def graph_fn(symbol: Symbol):
    """``run(arg_values, aux_values, rng, is_train) -> (outputs, new_aux)``.

    ``is_train`` reaches the ops that declare ``needs_mode`` (``BatchNorm``);
    ``rng`` is accepted for the JAX package's signature: no op of the port
    draws random numbers yet."""
    nodes = symbol._topo()
    for node in nodes:
        held = [a for a in _DEFERRED_ATTRS if a in node.extra_attrs]
        if held:
            raise MXNetError("node %r carries %s: placement and "
                             "rematerialization are not ported yet"
                             % (node.name, held))
    out_entries = list(symbol._outputs)

    def run(arg_values, aux_values, rng=None, is_train=True):
        env, new_aux = {}, {}
        for node in nodes:
            if node.is_variable:
                src = aux_values if node.is_aux else arg_values
                if node.name not in src:
                    raise MXNetError("unbound variable %r" % node.name)
                env[node._id] = [src[node.name]]
                continue
            ins = [env[s._id][i] for s, i in node.inputs]
            n_args = len(node.op.input_names(node.attrs))
            outs, aux_updates = node.op.apply(node.attrs, ins[:n_args],
                                              ins[n_args:], is_train)
            env[node._id] = outs
            for (aux_node, _), val in zip(node.inputs[n_args:], aux_updates):
                new_aux[aux_node.name] = val
        outputs = [env[n._id][i] for n, i in out_entries]
        for name in aux_values:
            new_aux.setdefault(name, aux_values[name])
        return outputs, new_aux

    return run


def _grad_reqs(grad_req, names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(names, grad_req))
    return dict(grad_req)


class Executor:
    """A graph bound to NDArrays on one context."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict,
                 group2ctx=None, shared_exec=None):
        from .context import current_context

        if group2ctx:
            raise MXNetError("group2ctx placement is not ported yet (a "
                             "later slice)")
        if shared_exec is not None:
            raise MXNetError("shared_exec (memory shared between executors) "
                             "is not ported yet (with BucketingModule)")
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_dict: Dict[str, object] = arg_dict
        self.grad_dict: Dict[str, Optional[object]] = grad_dict
        self.aux_dict: Dict[str, object] = aux_dict
        req = _grad_reqs(grad_req, self._arg_names)
        self._grad_req = {k: (req.get(k, "null") if grad_dict.get(k)
                              is not None else "null")
                          for k in self._arg_names}
        for k, r in self._grad_req.items():
            if r not in ("write", "add", "null"):
                raise MXNetError("grad_req %r of %r: write, add or null"
                                 % (r, k))
        self._run = graph_fn(symbol)
        self._outputs: Optional[List[object]] = None
        self._pending = None       # (outputs with their graph, leaves)
        self.group2ctx = group2ctx

    # ------------------------------------------------------------------
    # binding constructors
    # ------------------------------------------------------------------
    @staticmethod
    def _bind(symbol, ctx, args, args_grad=None, grad_req="write",
              aux_states=None, group2ctx=None, shared_exec=None):
        arg_names = symbol.list_arguments()
        arg_dict = _to_dict("args", args, arg_names)
        grad_dict = ({} if args_grad is None else
                     _to_dict("args_grad", args_grad, arg_names,
                              allow_missing=True))
        aux_dict = _to_dict("aux_states", aux_states or [],
                            symbol.list_auxiliary_states(),
                            allow_missing=True)
        return Executor(symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                     group2ctx=None, shared_exec=None, shapes=None):
        from . import ndarray as nd

        type_dict = dict(type_dict or {})
        arg_shapes, _, aux_shapes, arg_types, aux_types = infer(
            symbol, dict(shapes or {}), type_dict)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        req = _grad_reqs(grad_req, arg_names)
        arg_dict = {n: nd.zeros(s, ctx, dtype=t)
                    for n, s, t in zip(arg_names, arg_shapes, arg_types)}
        aux_dict = {n: nd.zeros(s, ctx, dtype=t)
                    for n, s, t in zip(aux_names, aux_shapes, aux_types)}
        grad_dict = {n: nd.zeros(s, ctx, dtype=t)
                     for n, s, t in zip(arg_names, arg_shapes, arg_types)
                     if req.get(n, "null") != "null"}
        return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _diff_names(self):
        return [k for k in self._arg_names if self._grad_req[k] != "null"
                and self.arg_dict[k]._data.is_floating_point()]

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the outputs (NDArrays).  Keyword
        arguments are written into the bound arrays first.  With
        ``is_train`` the run is recorded for :meth:`backward`."""
        from .ndarray import NDArray

        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v
        args = {k: v._data for k, v in self.arg_dict.items()}
        auxs = {k: v._data for k, v in self.aux_dict.items()}
        self._pending = None
        if is_train:
            leaves = {k: args[k].detach().requires_grad_(True)
                      for k in self._diff_names()}
            args.update(leaves)
            with torch.enable_grad():
                outs, new_aux = self._run(args, auxs, None, True)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._run(args, auxs, None, False)
        with torch.no_grad():
            for k, v in new_aux.items():
                if k in self.aux_dict and v is not self.aux_dict[k]._data:
                    self.aux_dict[k]._data.copy_(v)
        self._outputs = [NDArray(o.detach()) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into ``grad_dict``.
        ``out_grads`` are the outputs' head gradients (ones where
        omitted; a loss head such as ``SoftmaxOutput`` ignores them)."""
        from .ndarray import NDArray

        if self._pending is None:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "first")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            out_grads = [None] * len(outs)
        elif isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        heads = [torch.ones((), dtype=o.dtype, device=o.device).expand(
                     o.shape) if g is None else
                 (g._data if isinstance(g, NDArray) else torch.as_tensor(g))
                 for o, g in zip(outs, out_grads)]
        live = [(o, g) for o, g in zip(outs, heads) if o.requires_grad]
        if live:
            torch.autograd.backward([o for o, _ in live],
                                    [g for _, g in live])
        # into the bound arrays' own storage, which callers may hold
        with torch.no_grad():
            for k, leaf in leaves.items():
                tgt = self.grad_dict[k]._data
                if leaf.grad is None:     # no output depends on it
                    if self._grad_req[k] == "write":
                        tgt.zero_()
                elif self._grad_req[k] == "add":
                    tgt.add_(leaf.grad)
                else:
                    tgt.copy_(leaf.grad)

    # ------------------------------------------------------------------
    # conveniences
    # ------------------------------------------------------------------
    @property
    def outputs(self):
        return [] if self._outputs is None else self._outputs

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    @property
    def arg_arrays(self):
        return [self.arg_dict[k] for k in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(k) for k in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[k] for k in self._aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy NDArrays into the bound arrays' storage, by name."""
        for what, src, tgt_dict in (("arg_param", arg_params, self.arg_dict),
                                    ("aux_param", aux_params or {},
                                     self.aux_dict)):
            for k, v in (src or {}).items():
                if k not in tgt_dict:
                    if allow_extra_params:
                        continue
                    raise MXNetError("Found name %r not in executor %s"
                                     % (k, "arguments" if what == "arg_param"
                                        else "aux states"))
                tgt = tgt_dict[k]
                if tuple(v.shape) != tgt.shape:
                    raise MXNetError("%s %r has shape %s; executor expects %s"
                                     % (what, k, tuple(v.shape), tgt.shape))
                if v is not tgt:
                    tgt[:] = v

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at new input shapes; arrays whose shape does not
        change are shared."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes, _, _ = infer(self._symbol, dict(kwargs))
        new_args = {}
        for n, s in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[n]
            new_args[n] = cur if s == cur.shape else nd.zeros(
                s, self._ctx, dtype=cur._data.dtype)
        new_grads = {k: nd.zeros(new_args[k].shape, self._ctx,
                                 dtype=v._data.dtype)
                     for k, v in self.grad_dict.items() if v is not None}
        new_aux = {}
        for n, s in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict[n]
            new_aux[n] = cur if s == cur.shape else nd.zeros(
                s, self._ctx, dtype=cur._data.dtype)
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, group2ctx=self.group2ctx)

    def set_monitor_callback(self, callback):
        raise MXNetError("monitor callbacks are not ported yet (a later "
                         "slice)")


def _to_dict(what, values, names, allow_missing=False):
    if isinstance(values, dict):
        out = {}
        for n in names:
            if n in values:
                out[n] = values[n]
            elif not allow_missing:
                raise MXNetError("%s is missing entry for %r" % (what, n))
        return out
    values = list(values)
    if not allow_missing and len(values) != len(names):
        raise MXNetError("%s length %d does not match number of names %d "
                         "(%s)" % (what, len(values), len(names), names))
    return {n: v for n, v in zip(names, values) if v is not None}
