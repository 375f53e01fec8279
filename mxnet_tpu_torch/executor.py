"""Executor: running a Symbol graph (the JAX package's ``executor.py``,
its single-device graph function ``_graph_fn``).

:func:`graph_fn` turns a Symbol into ``run(args, aux, rng, is_train) ->
(outputs, new_aux)`` over ``{name: tensor}`` dicts: each node's compute
rule runs eagerly in topological order, and autograd records the graph, so
the caller differentiates ``sum(outputs)`` with ``torch.autograd`` where the
JAX package takes ``jax.value_and_grad`` of the traced function.

Placement across devices (``ctx_group`` / ``group2ctx``) and per-block
rematerialization (``__remat__``) are later slices: a graph that carries
either raises rather than running without them.
"""

from __future__ import annotations

from .base import MXNetError
from .symbol import Symbol

__all__ = ["graph_fn"]

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
