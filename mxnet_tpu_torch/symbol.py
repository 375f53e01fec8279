"""Symbol: symbolic graph construction (the JAX package's ``symbol.py``).

A Symbol is a list of output entries ``(Node, out_index)`` over an
immutable DAG of ``Node``s, composed functionally as in MXNet.  Missing
tensor inputs auto-materialize as variables (``{name}_weight`` ...), so a
model's parameters are the graph's free variables; ``list_arguments`` walks
them in the same depth-first order as the JAX package, so both give the
same names in the same order.

Shape inference (:func:`infer`) runs each op's compute rule on ``meta``
tensors (shape and dtype, no data), where the JAX package uses
``jax.eval_shape``, and back-solves parameter shapes from the data shape
for ``FullyConnected``, ``Convolution``, ``BatchNorm``, ``LayerNorm``,
``Embedding`` and ``MultiHeadAttention`` (``_try_param_solve``).  Every
op runs in inference mode there, as in the JAX package.

``tojson``/``save`` and :func:`load_json`/:func:`load` write and read the
JAX package's graph JSON (the reference's schema), so a ``-symbol.json``
of either package loads in the other.  ``simple_bind``/``bind`` make an
:class:`~.executor.Executor`.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .attribute import AttrScope
from .base import MXNetError, torch_dtype
from .ops import registry as _registry
from .ops.registry import Op, get_op, parse_shape

__all__ = ["Group", "Symbol", "Variable", "infer", "load", "load_json",
           "torch_dtype"]


class Node:
    """One graph node: an op application, or a variable (``op`` None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "extra_attrs", "is_aux",
                 "_id")

    _counter = [0]

    def __init__(self, op, name, attrs=None, inputs=None, extra_attrs=None,
                 is_aux=False):
        self.op: Optional[Op] = op
        self.name = name
        self.attrs = attrs or {}
        self.inputs: List[Tuple["Node", int]] = inputs or []
        self.extra_attrs = extra_attrs or {}
        self.is_aux = is_aux
        Node._counter[0] += 1
        self._id = Node._counter[0]

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_variable else self.op.n_outputs(self.attrs)

    def output_name(self, idx):
        if self.is_variable:
            return self.name
        if self.num_outputs() == 1:
            return "%s_output" % self.name
        return "%s_output%d" % (self.name, idx)


def _topo_order(out_entries) -> List[Node]:
    seen = set()
    order: List[Node] = []

    def visit(node):
        if node._id in seen:
            return
        seen.add(node._id)
        for inode, _ in node.inputs:
            visit(inode)
        order.append(node)

    for node, _ in out_entries:
        visit(node)
    return order


class Symbol:
    """Symbolic graph handle (a set of output entries)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs: List[Tuple[Node, int]] = list(outputs)

    @property
    def name(self):
        return self._outputs[0][0].name if len(self._outputs) == 1 else None

    def list_outputs(self):
        return [n.output_name(i) for n, i in self._outputs]

    def _topo(self):
        return _topo_order(self._outputs)

    def list_arguments(self):
        return [n.name for n in self._topo() if n.is_variable and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.is_variable and n.is_aux]

    def get_internals(self):
        """A symbol of every node's outputs, in topological order."""
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs())])

    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise TypeError("mxnet_tpu_torch symbols add only symbols, got "
                            "%s" % type(other))
        return _create("elemwise_add", [self, other], {})

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "Grouped")

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the given input
        shapes (by name)."""
        shapes, out_shapes, aux_shapes, _, _ = infer(
            self, {k: v for k, v in kwargs.items() if v is not None})
        return shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, **kwargs):
        """:meth:`infer_shape`, with ``None`` where a shape is unknown."""
        shapes, out_shapes, aux_shapes, _, _ = infer(
            self, {k: v for k, v in kwargs.items() if v is not None},
            partial=True)
        return shapes, out_shapes, aux_shapes

    # -- attributes -----------------------------------------------------
    def attr_dict(self):
        """``{node name: {attribute: string}}`` of every node that has
        one: its string attributes and its op's parsed parameters."""
        ret = {}
        for node in self._topo():
            d = dict(node.extra_attrs)
            d.update({k: _attr_str(v) for k, v in node.attrs.items()
                      if v is not None})
            if d:
                ret[node.name] = d
        return ret

    # -- serialization ---------------------------------------------------
    def tojson(self):
        """The graph in the JAX package's JSON (the reference's schema)."""
        nodes = self._topo()
        nid = {n._id: i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            entry = {"op": "null" if n.is_variable else n.op.name,
                     "name": n.name,
                     "inputs": [[nid[src._id], idx, 0]
                                for src, idx in n.inputs]}
            attr = {k: _attr_str(v) for k, v in n.attrs.items()
                    if v is not None}
            attr.update(n.extra_attrs)
            if n.is_aux:
                attr["__is_aux__"] = "1"
            if attr:
                entry["attr"] = attr
            jnodes.append(entry)
        graph = {"nodes": jnodes,
                 "arg_nodes": [i for i, n in enumerate(nodes)
                               if n.is_variable],
                 "node_row_ptr": list(range(len(nodes) + 1)),
                 "heads": [[nid[n._id], i, 0] for n, i in self._outputs],
                 "attrs": {"mxnet_version": ["int", 905]}}
        return json.dumps(graph, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """An Executor with every array allocated (zeros) on ``ctx`` at the
        shapes inferred from ``kwargs`` (input name → shape)."""
        from .executor import Executor

        return Executor._simple_bind(self, ctx, grad_req=grad_req,
                                     type_dict=type_dict, group2ctx=group2ctx,
                                     shared_exec=shared_exec, shapes=kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over the given NDArrays (lists in
        ``list_arguments`` order, or dicts by name)."""
        from .executor import Executor

        return Executor._bind(self, ctx, args, args_grad=args_grad,
                              grad_req=grad_req, aux_states=aux_states,
                              group2ctx=group2ctx, shared_exec=shared_exec)


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def load_json(json_str):
    """A Symbol from graph JSON (either package's ``tojson``, or the
    reference's, whose older files name the attributes ``param``).
    Attributes that the op does not declare stay string attributes."""
    graph = json.loads(json_str)
    nodes: List[Node] = []
    for jn in graph["nodes"]:
        raw = dict(jn.get("attr", jn.get("param", {})) or {})
        if isinstance(jn.get("attrs"), dict):
            raw.update(jn["attrs"])
        is_aux = raw.pop("__is_aux__", None) == "1"
        if jn["op"] == "null":
            nodes.append(Node(None, jn["name"], extra_attrs=raw,
                              is_aux=is_aux))
            continue
        op = get_op(jn["op"])
        known = {k: v for k, v in raw.items() if k in op.params}
        extra = {k: v for k, v in raw.items() if k not in op.params}
        attrs = op.parse_attrs(known)
        inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
        # inputs past the op's declared ones are its auxiliary states
        for inode, _ in inputs[len(op.input_names(attrs)):]:
            if inode.is_variable:
                inode.is_aux = True
        nodes.append(Node(op, jn["name"], attrs=attrs, inputs=inputs,
                          extra_attrs=extra))
    return Symbol([(nodes[h[0]], h[1]) for h in graph["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def Variable(name, attr=None, shape=None, dtype=None, **kwargs):
    """A variable symbol; ``shape`` and ``dtype`` become hints for
    inference (``__shape__``, ``__dtype__``)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    extra = AttrScope.current.get(attr)
    if shape is not None:
        extra["__shape__"] = _attr_str(tuple(shape))
    if dtype is not None:
        extra["__dtype__"] = str(np.dtype(dtype))
    for k, v in kwargs.items():
        if not (k.startswith("__") and k.endswith("__")):
            raise MXNetError("Variable %r: unknown argument %r" % (name, k))
        extra[k] = str(v)
    return Symbol([(Node(None, name, extra_attrs=extra), 0)])


def Group(symbols):
    """One symbol with the outputs of all of ``symbols``."""
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def _create(op_name, sym_inputs, kwargs, name=None, attr=None):
    """A node applying ``op_name`` to ``sym_inputs`` (the Compose step)."""
    from .name import NameManager

    op = get_op(op_name)
    attrs = op.parse_attrs(kwargs)
    name = NameManager.current.get(name, op.name.lower().lstrip("_"))
    extra = AttrScope.current.get(attr)
    inputs: List[Tuple[Node, int]] = []
    for i, iname in enumerate(op.input_names(attrs)):
        if i < len(sym_inputs) and sym_inputs[i] is not None:
            s = sym_inputs[i]
            if len(s._outputs) != 1:
                raise MXNetError("cannot compose with grouped symbol input")
            inputs.append(s._outputs[0])
        else:
            inputs.append((Node(None, "%s_%s" % (name, iname)), 0))
    for aname in op.aux_names:
        inputs.append((Node(None, "%s_%s" % (name, aname), is_aux=True), 0))
    node = Node(op, name, attrs=attrs, inputs=inputs, extra_attrs=extra)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_sym_fn(op_name):
    op = get_op(op_name)

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_inputs = list(args)
        # tensor inputs by keyword, aligned to their slots; an omitted
        # middle input is materialized as a variable by _create
        names = op.input_names({k: v for k, v in kwargs.items()
                                if not isinstance(v, Symbol)}) \
            if op.input_names_fn is not None else op.arg_names
        tail = list(names)[len(sym_inputs):]
        if any(isinstance(kwargs.get(n), Symbol) for n in tail):
            for aname in tail:
                sym_inputs.append(kwargs.pop(aname)
                                  if isinstance(kwargs.get(aname), Symbol)
                                  else None)
            while sym_inputs and sym_inputs[-1] is None:
                sym_inputs.pop()
        return _create(op_name, sym_inputs, kwargs, name=name, attr=attr)

    fn.__name__ = op_name
    fn.__doc__ = "Symbolic op %r." % op_name
    return fn


def _init_module():
    mod = sys.modules[__name__]
    for name in _registry.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_sym_fn(name))


_init_module()


# ----------------------------------------------------------------------
# shape inference
# ----------------------------------------------------------------------

def infer(symbol: Symbol, shape_dict: Dict[str, tuple], type_dict=None,
          partial=False):
    """Shapes and dtypes of every argument, output and auxiliary state.

    Returns ``(arg_shapes, out_shapes, aux_shapes, arg_types, aux_types)``
    (types as numpy dtypes), like the JAX package's ``_infer``.  Variables
    take their shape from ``shape_dict``, a ``__shape__`` hint or a
    back-solve from the op they feed; each op runs on ``meta`` tensors."""
    type_dict = dict(type_dict or {})
    nodes = symbol._topo()
    variables = [n for n in nodes if n.is_variable]
    resolved = dict(shape_dict)
    for n in variables:
        if n.name not in resolved and "__shape__" in n.extra_attrs:
            resolved[n.name] = parse_shape(n.extra_attrs["__shape__"])

    def var_dtype(n):
        return np.dtype(type_dict.get(
            n.name, n.extra_attrs.get("__dtype__", np.float32)))

    metas: Dict[int, List[torch.Tensor]] = {}
    pending = list(nodes)
    progress = True
    with torch.no_grad():
        while pending and progress:
            progress = False
            remaining = []
            for node in pending:
                if node.is_variable:
                    if node.name in resolved:
                        metas[node._id] = [torch.empty(
                            tuple(resolved[node.name]), device="meta",
                            dtype=torch_dtype(var_dtype(node)))]
                        progress = True
                    else:
                        remaining.append(node)
                    continue
                if not all(i._id in metas for i, _ in node.inputs):
                    if _try_param_solve(node, metas, resolved):
                        progress = True
                    remaining.append(node)
                    continue
                ins = [metas[s._id][i] for s, i in node.inputs]
                n_args = len(node.op.input_names(node.attrs))
                try:
                    outs, new_aux = node.op.apply(node.attrs, ins[:n_args],
                                                  ins[n_args:])
                except MXNetError:
                    raise
                except Exception as exc:
                    raise MXNetError("shape inference failed at node %r "
                                     "(%s): %s" % (node.name, node.op.name,
                                                   exc)) from exc
                metas[node._id] = list(outs) + list(new_aux)
                progress = True
            pending = remaining
    if pending and not partial:
        missing = sorted({n.name for n in pending if n.is_variable})
        raise MXNetError("cannot infer shapes; unresolved variables: %s "
                         "(provide their shapes)" % (missing,))

    def shape_type(n):
        if n._id not in metas:
            return None, None
        t = metas[n._id][0]
        return tuple(t.shape), np.dtype(str(t.dtype).replace("torch.", ""))

    args = [shape_type(n) for n in variables if not n.is_aux]
    auxs = [shape_type(n) for n in variables if n.is_aux]
    outs = [tuple(metas[n._id][i].shape) if n._id in metas else None
            for n, i in symbol._outputs]
    return ([s for s, _ in args], outs, [s for s, _ in auxs],
            [t for _, t in args], [t for _, t in auxs])


def _try_param_solve(node, metas, resolved):
    """Back-solve parameter shapes of common layers once the data input's
    shape is known (the JAX package's ``_try_param_solve``, for the ops
    of this slice's graphs)."""
    names = node.op.input_names(node.attrs) + node.op.aux_names
    name_of = {iname: inode for (inode, _), iname in zip(node.inputs, names)}
    data = name_of.get("data")
    if data is None or data._id not in metas:
        return False
    dshape = tuple(metas[data._id][0].shape)
    a = node.attrs
    op = node.op.name
    if op == "FullyConnected":
        in_dim = (int(np.prod(dshape[1:])) if a.get("flatten", True)
                  else dshape[-1])
        solved = {"weight": (a["num_hidden"], in_dim),
                  "bias": (a["num_hidden"],)}
    elif op == "Convolution":
        k, ng = tuple(a["kernel"]), a.get("num_group", 1)
        if a.get("layout") == "NHWC" and len(k) == 2:
            wshape = (a["num_filter"],) + k + (dshape[-1] // ng,)   # OHWI
        else:
            wshape = (a["num_filter"], dshape[1] // ng) + k
        solved = {"weight": wshape, "bias": (a["num_filter"],)}
    elif op == "BatchNorm":
        c = dshape[a.get("axis", 1) % len(dshape)] if len(dshape) > 1 \
            else dshape[0]
        solved = {p: (c,) for p in ("gamma", "beta", "moving_mean",
                                    "moving_var")}
    elif op == "Embedding":
        solved = {"weight": (a["input_dim"], a["output_dim"])}
    elif op == "LayerNorm":
        c = dshape[a.get("axis", -1)]
        solved = {"gamma": (c,), "beta": (c,)}
    elif op == "MultiHeadAttention":
        c = dshape[-1]
        solved = {"qkv_weight": (3 * c, c), "out_weight": (c, c),
                  "qkv_bias": (3 * c,), "out_bias": (c,)}
    elif op == "SoftmaxOutput":
        solved = {"label": (dshape[0],)}
    else:
        return False
    progress = False
    for pname, pshape in solved.items():
        vnode = name_of.get(pname)
        if vnode is not None and vnode.is_variable \
                and vnode._id not in metas:
            metas[vnode._id] = [torch.empty(pshape, device="meta")]
            resolved[vnode.name] = tuple(pshape)
            progress = True
    return progress
