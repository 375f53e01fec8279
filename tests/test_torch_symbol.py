"""mxnet_tpu_torch's Symbol graph, shape inference, executor and training
ops against the JAX package.

``get_symbol`` at 2 layers, d32: the same argument names in the same
order, the same inferred shapes, and the same forward output at every
node of the graph (``get_internals``) from the same numpy weights, within
2e-5 absolute and relative (fp32; the frameworks sum in different orders);
the same outputs and gradients through each package's Executor
(``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()``), and
the same graph JSON, each package loading the other's.
``SoftmaxOutput``'s gradient ignores the head gradient exactly as the JAX
custom VJP does; held to 1e-6 (one softmax, no long sums).  The bf16
graph (``dtype="bfloat16"``, the bench's): the same argument types (fp32
parameters), the same dtype at every node, the graph's output within the
bf16 class of the JAX parity harness and every node within that class
scaled to its tensor.
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import context as jctx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.executor import _graph_fn
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops import tensor as jtensor
from mxnet_tpu.ops.fused.parity import _TOL
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.symbol import _infer
from mxnet_tpu_torch import symbol as psym
from mxnet_tpu_torch.attribute import AttrScope
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.executor import graph_fn
from mxnet_tpu_torch.models import transformer as ptfm
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.ops import tensor as ptensor
from mxnet_tpu_torch.ops.registry import get_op

TOL = 2e-5
CFG = dict(num_classes=64, seq_len=16, num_embed=32, num_heads=4,
           num_layers=2)
SHAPES = {"data": (2, 16), "softmax_label": (2, 16)}
TYPES = {"data": "int32"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def graphs():
    return jtfm.get_symbol(**CFG), ptfm.get_symbol(**CFG)


def test_arguments_and_inferred_shapes_match_jax(graphs):
    jsy, psy = graphs
    assert psy.list_arguments() == jsy.list_arguments()
    assert psy.list_outputs() == jsy.list_outputs()
    assert psy.list_auxiliary_states() == jsy.list_auxiliary_states() == []
    jres = _infer(jsy, SHAPES, TYPES)
    pres = psym.infer(psy, SHAPES, TYPES)
    names = jsy.list_arguments()
    assert dict(zip(names, pres[0])) == dict(zip(names, jres[0]))
    assert pres[1] == jres[1] == [(32, 64)]
    assert [str(t) for t in pres[3]] == [str(t) for t in jres[3]]
    assert psy.infer_shape(**SHAPES)[0] == pres[0]
    both = psym.Group([psy, psym.Variable("extra")])
    assert both.list_outputs() == ["softmax_output", "extra"]
    assert both.list_arguments() == names + ["extra"]


def _anon(name):
    return re.sub(r"^(elemwise_add|broadcast_add|reshape|cast)\d+", r"\1",
                  name)


def _node_args(jsy):
    names = jsy.list_arguments()
    shapes = dict(zip(names, _infer(jsy, SHAPES, TYPES)[0]))
    rng = np.random.RandomState(0)
    args = {}
    for n in names:
        if n == "data":
            args[n] = rng.randint(0, 64, shapes[n]).astype(np.int32)
        elif n == "softmax_label":
            args[n] = rng.randint(0, 64, shapes[n]).astype(np.float32)
        else:
            args[n] = (rng.randn(*shapes[n]) * 0.3).astype(np.float32)
    return args


def _node_outputs(jsy, psy, args):
    jint, pint = jsy.get_internals(), psy.get_internals()
    # anonymous nodes are numbered by a per-process counter (elemwise_add3
    # ...), which other tests advance: compare the names without it
    assert [_anon(n) for n in pint.list_outputs()] == \
        [_anon(n) for n in jint.list_outputs()]
    jouts, _ = _graph_fn(jint)({n: jnp.asarray(a) for n, a in args.items()},
                               {}, jax.random.PRNGKey(0), False)
    pouts, _ = graph_fn(pint)({n: torch.from_numpy(a)
                               for n, a in args.items()}, {})
    return zip(jint.list_outputs(), jouts, pouts)


def _anon_graph(text):
    graph = json.loads(text)
    for node in graph["nodes"]:
        node["name"] = _anon(node["name"])
    return graph


def _anon_attrs(sy):
    return {_anon(n): a for n, a in sy.attr_dict().items()}


def _bound_step(sy, ctx, args):
    """``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()``:
    the output and every gradient as numpy arrays."""
    ex = sy.simple_bind(ctx, type_dict=TYPES, **SHAPES)
    for n, a in args.items():
        ex.arg_dict[n][:] = a
    ex.forward(is_train=True)
    ex.backward()
    return (ex.outputs[0].asnumpy(),
            {n: g.asnumpy() for n, g in ex.grad_dict.items()})


def test_every_node_output_matches_jax(graphs):
    jsy, psy = graphs
    args = _node_args(jsy)
    for name, j, p in _node_outputs(jsy, psy, args):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=TOL, atol=TOL, err_msg=name)
    # the Executors: one training forward, then backward
    jout, jgrads = _bound_step(jsy, jctx.cpu(), args)
    with cpu():
        pout, pgrads = _bound_step(psy, cpu(), args)
    np.testing.assert_allclose(pout, jout, rtol=TOL, atol=TOL)
    assert sorted(pgrads) == sorted(jgrads) == sorted(args)
    for n in jgrads:
        np.testing.assert_allclose(pgrads[n], jgrads[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    # the graph JSON: the same graph, and each package loads the other's
    jjson = _anon_graph(jsy.tojson())
    assert _anon_graph(psy.tojson()) == jjson
    back_p = psym.load_json(jsy.tojson())
    back_j = jsym.load_json(psy.tojson())
    assert _anon_graph(back_p.tojson()) == _anon_graph(back_j.tojson()) \
        == jjson
    assert back_p.list_arguments() == psy.list_arguments()
    assert _anon_attrs(back_p) == _anon_attrs(back_j) == _anon_attrs(jsy)
    pt = {n: torch.from_numpy(a) for n, a in args.items()}
    (want,), _ = graph_fn(psy)(pt, {})
    (got,), _ = graph_fn(back_p)(pt, {})
    assert torch.equal(got, want)
    # grad_req "add" accumulates: two training steps hold twice the gradient
    with cpu():
        ex = psy.simple_bind(cpu(), grad_req="add", type_dict=TYPES,
                             **SHAPES)
        for n, a in args.items():
            ex.arg_dict[n][:] = a
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
    for n in pgrads:
        assert np.array_equal(ex.grad_dict[n].asnumpy(), 2 * pgrads[n]), n
    # grad_req "write" keeps each gradient array's storage: a tensor held
    # from before the steps reads the last step's gradient
    with cpu():
        ex = psy.simple_bind(cpu(), type_dict=TYPES, **SHAPES)
        held = {n: g._data for n, g in ex.grad_dict.items()}
        for n, a in args.items():
            ex.arg_dict[n][:] = a
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
    for n in pgrads:
        assert ex.grad_dict[n]._data is held[n], n
        assert np.array_equal(held[n].numpy(), pgrads[n]), n


def test_bf16_graph_types_and_nodes_match_jax():
    """``get_symbol(dtype="bfloat16")``: fp32 parameters (the JAX
    ``_infer``'s argument types, which the trainers' ``arg_dtypes`` read),
    bf16 activations between the two Casts and fp32 logits into the head,
    node for node.  The frameworks round bf16 at other places (XLA fuses
    elementwise chains, torch rounds after each op), so a node may differ
    by an ulp of its largest values: each node is held to the bf16 class
    with its absolute part scaled by the node's largest value, the graph's
    output to the class itself."""
    rtol, atol = _TOL["bfloat16"]
    cfg = dict(CFG, dtype="bfloat16")
    jsy, psy = jtfm.get_symbol(**cfg), ptfm.get_symbol(**cfg)
    assert psy.list_arguments() == jsy.list_arguments()
    jres = _infer(jsy, SHAPES, TYPES)
    pres = psym.infer(psy, SHAPES, TYPES)
    assert pres[0] == jres[0] and pres[1] == jres[1]
    assert [str(t) for t in pres[3]] == [str(t) for t in jres[3]]
    assert {str(t) for t in pres[3]} == {"int32", "float32"}
    seen = set()
    for name, j, p in _node_outputs(jsy, psy, _node_args(jsy)):
        want = np.asarray(j)
        assert str(p.dtype)[6:] == str(want.dtype), name
        seen.add(str(want.dtype))
        want = want.astype(np.float32)
        np.testing.assert_allclose(p.detach().float().numpy(), want,
                                   rtol=rtol, atol=atol * np.abs(want).max(),
                                   err_msg=name)
    assert seen == {"int32", "float32", "bfloat16"}
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kwargs", [
    {},
    {"use_ignore": True, "ignore_label": 2, "normalization": "valid",
     "grad_scale": 2.0},
    {"normalization": "batch", "out_grad": True},
])
def test_softmax_output_gradient_matches_jax(kwargs):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 5).astype(np.float32)
    lab = np.array([0, 2, 4, 1, 2, 3], np.float32)
    head = rng.randn(6, 5).astype(np.float32)
    jop = jget_op("SoftmaxOutput")
    jattrs = jop.parse_attrs(dict(kwargs))

    def loss(d):
        (out,), _ = jop.apply(jattrs, [d, jnp.asarray(lab)])
        return jnp.sum(out * jnp.asarray(head))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    op = get_op("SoftmaxOutput")
    xt = torch.from_numpy(x).requires_grad_(True)
    (out,), _ = op.apply(op.parse_attrs(dict(kwargs)),
                         [xt, torch.from_numpy(lab)])
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(head))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if not kwargs.get("out_grad"):   # the head gradient is ignored
        (again,) = torch.autograd.grad(
            op.apply(op.parse_attrs(dict(kwargs)),
                     [xt, torch.from_numpy(lab)])[0][0], xt,
            torch.full_like(xt, 7.0))
        assert torch.equal(again, got)


@pytest.mark.parametrize("shape,target", [
    ((2, 3, 4), (-1, 4)), ((2, 3, 4), (0, -1)), ((2, 3, 4), (-3, 0)),
    ((2, 3, 4), (0, -4, 1, 3, 0)), ((2, 3, 4), (-2,)), ((6, 4), (-4, 2, -1, 4)),
])
def test_reshape_codes_match_jax(shape, target):
    assert ptensor.infer_reshape(shape, target) == \
        jtensor._infer_reshape(shape, target)


def test_deferred_graph_features_raise():
    data = psym.Variable("data")
    with AttrScope(__remat__="l0"):
        h = psym.FullyConnected(data, num_hidden=4, name="fc")
    with pytest.raises(MXNetError, match="__remat__"):
        graph_fn(h)
    with pytest.raises(MXNetError, match="__remat__"):
        h.simple_bind(cpu(), data=(2, 3))
    fc = psym.FullyConnected(data, num_hidden=4, name="fc")
    with pytest.raises(MXNetError, match="group2ctx"):
        fc.simple_bind(cpu(), group2ctx={"a": cpu()}, data=(2, 3))
    with pytest.raises(MXNetError, match="monitor"):
        fc.simple_bind(cpu(), data=(2, 3)).set_monitor_callback(print)
    with pytest.raises(MXNetError, match="shared_exec"):
        fc.simple_bind(cpu(), shared_exec=fc.simple_bind(cpu(), data=(2, 3)),
                       data=(2, 3))
    with pytest.raises(MXNetError, match="work_load_list"):
        Module(fc, data_names=["data"], label_names=None, context=cpu(),
               work_load_list=[1])
    mod = Module(fc, data_names=["data"], label_names=None, context=cpu())
    with pytest.raises(MXNetError, match="shared_module"):
        mod.bind([("data", (2, 3))], shared_module=mod)
    with pytest.raises(MXNetError, match="head"):
        ptfm.get_symbol(head="fused_ce")
    with pytest.raises(MXNetError, match="context_parallel_axis"):
        op = get_op("MultiHeadAttention")
        op.apply(op.parse_attrs({"num_heads": 2,
                                 "context_parallel_axis": "seq"}),
                 [torch.zeros(1, 4, 8), torch.zeros(24, 8),
                  torch.zeros(8, 8)])
    with pytest.raises(MXNetError, match="Cast to uint8 is not ported"):
        psym.infer(psym.Cast(psym.Variable("x"), dtype="uint8"),
                   {"x": (2, 3)})
