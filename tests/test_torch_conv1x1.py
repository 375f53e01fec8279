"""mxnet_tpu_torch's ``Convolution`` op and 1x1-conv dgrad against the JAX
package's.

The same numpy inputs go through the JAX registry's ``Convolution`` (its
Pallas dgrad in interpret mode, as ``tests/test_operator.py`` runs it) and
the port's on the CPU (the dgrad kernel's plain version), under the same
``MXTPU_CONV1X1``: forward and vjp, fp32 and bf16, an M that a row block
divides and one that none does, a stride-2 conv the 1x1 path does not take,
and a mode that is none of the valid ones.  fp32 is held to the
``float32`` class of ``ops/fused/parity.py`` (2e-5), bf16 to its
``bfloat16`` class (2e-2): the two frameworks round bf16 at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops.fused import conv_kernels as ck
from mxnet_tpu_torch.ops.registry import get_op as pget_op

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    on one CPU, and each torch op would otherwise start a thread per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _conv_pair(attrs, x, w, dy, dtype):
    """Forward and vjp of both packages' ``Convolution`` on the same
    inputs; returns ``((y, dx, dw) of JAX, (y, dx, dw) of the port)``."""
    jop, pop = jget_op("Convolution"), pget_op("Convolution")
    ja = jop.parse_attrs(attrs)
    jx, jw, jdy = (jnp.asarray(a, JDT[dtype]) for a in (x, w, dy))
    y, vjp = jax.vjp(lambda a, b: jop.apply(ja, [a, b])[0][0], jx, jw)
    jdx, jdw = vjp(jdy)
    pa = pop.parse_attrs(attrs)
    px, pw = (torch.from_numpy(a).to(PDT[dtype]).requires_grad_(True)
              for a in (x, w))
    py = pop.apply(pa, [px, pw])[0][0]
    pdx, pdw = torch.autograd.grad(
        py, (px, pw), torch.from_numpy(dy).to(PDT[dtype]))
    return (y, jdx, jdw), (py, pdx, pdw)


def _inputs(shape, filters, stride=1, seed=3):
    rs = np.random.RandomState(seed)
    b, h, w_, c = shape
    x = rs.randn(b, h, w_, c).astype(np.float32)
    w = (rs.randn(filters, 1, 1, c) * 0.1).astype(np.float32)
    ho, wo = -(-h // stride), -(-w_ // stride)
    dy = rs.randn(b, ho, wo, filters).astype(np.float32)
    return x, w, dy


# (shape NHWC, what): M = 128 (a row block of 128 divides it) and M = 15
# (no block of 4096..128 divides it: the dgrad is the plain product in
# 'pallas' mode too, in both packages)
SHAPES = [((2, 8, 8, 32), "M=128"), ((1, 3, 5, 32), "M=15")]
MODES = ["", "default", "dot", "pallas"]


def test_conv1x1_matches_jax(monkeypatch):
    """Every mode, both dtypes, both Ms (a loop, not parameters: see the
    note at the end of this file)."""
    attrs = {"kernel": (1, 1), "num_filter": 48, "no_bias": True,
             "layout": "NHWC"}
    for mode in MODES:
        monkeypatch.setenv("MXTPU_CONV1X1", mode)
        for dtype in ("float32", "bfloat16"):
            for shape, what in SHAPES:
                x, w, dy = _inputs(shape, 48)
                want, got = _conv_pair(attrs, x, w, dy, dtype)
                for name, g, j in zip(("y", "dx", "dw"), got, want):
                    case = "%s %s %s mode=%r" % (name, dtype, what, mode)
                    assert g.dtype == PDT[dtype], case
                    np.testing.assert_allclose(_f32(g), _f32(j),
                                               err_msg=case, **TOL[dtype])


def test_conv1x1_backward_selection(monkeypatch):
    """Under ``dot`` and ``pallas`` an eligible conv runs the JAX
    package's 1x1 backward in the port (its ``_Conv1x1NHWC``), and an
    ineligible one (stride 2) runs the stock conv backward in both
    packages, with the same results; an unknown mode raises.  The
    backward takes the mode its forward call read, whatever the variable
    says by then."""
    pop = pget_op("Convolution")
    one_by_one = {"kernel": (1, 1), "num_filter": 48, "no_bias": True,
                  "layout": "NHWC"}
    eligible = pop.parse_attrs(one_by_one)
    attrs = {"kernel": (1, 1), "num_filter": 48, "stride": (2, 2),
             "no_bias": True, "layout": "NHWC"}
    for mode in ("dot", "pallas"):
        monkeypatch.setenv("MXTPU_CONV1X1", mode)
        x, w, dy = _inputs((2, 8, 8, 32), 48)
        px = torch.from_numpy(x).requires_grad_(True)
        y = pop.apply(eligible, [px, torch.from_numpy(w)])[0][0]
        assert type(y.grad_fn).__name__ == "_Conv1x1NHWCBackward", mode
        x, w, dy = _inputs((2, 8, 8, 32), 48, stride=2)
        want, got = _conv_pair(attrs, x, w, dy, "float32")
        assert tuple(got[0].shape) == (2, 4, 4, 48)
        assert type(got[0].grad_fn).__name__ != "_Conv1x1NHWCBackward"
        for name, g, j in zip(("y", "dx", "dw"), got, want):
            np.testing.assert_allclose(_f32(g), _f32(j),
                                       err_msg="%s %s" % (name, mode),
                                       **TOL["float32"])
    # a mode that is none of unset/default/dot/pallas raises in the
    # backward, in both packages, rather than guess
    monkeypatch.setenv("MXTPU_CONV1X1", "fast")
    x, w, dy = _inputs((2, 8, 8, 32), 48)
    with pytest.raises(JaxMXNetError, match="is not a backward mode"):
        _conv_pair(one_by_one, x, w, dy, "float32")
    px = torch.from_numpy(x).requires_grad_(True)
    y = pop.apply(eligible, [px, torch.from_numpy(w)])[0][0]
    monkeypatch.setenv("MXTPU_CONV1X1", "dot")
    with pytest.raises(MXNetError, match="is not a backward mode"):
        torch.autograd.grad(y, px, torch.from_numpy(dy))


def test_dgrad_plain_matches_pallas_kernel():
    """``conv1x1_dgrad_plain`` (and the wrapper on CPU tensors) against
    ``_conv1x1_dgrad_pallas`` in interpret mode, and the row-block rule
    that decides whether ``pallas`` mode takes the kernel."""
    for dtype in ("float32", "bfloat16"):
        for m, o, i in ((256, 64, 32), (512, 48, 80)):
            rs = np.random.RandomState(m + o)
            dy = rs.randn(m, o).astype(np.float32)
            w = (rs.randn(o, i) * 0.1).astype(np.float32)
            want = jnn._conv1x1_dgrad_pallas(
                jnp.asarray(dy, JDT[dtype]), jnp.asarray(w, JDT[dtype]),
                JDT[dtype], jnn._conv1x1_pick_bm(m))
            pdy, pw = (torch.from_numpy(a).to(PDT[dtype]) for a in (dy, w))
            for got in (ck.conv1x1_dgrad_plain(pdy, pw, PDT[dtype]),
                        ck.conv1x1_dgrad(pdy, pw, PDT[dtype])):
                assert got.dtype == PDT[dtype]
                assert tuple(got.shape) == (m, i)
                np.testing.assert_allclose(
                    _f32(got), _f32(want), err_msg="%s %d" % (dtype, m),
                    **TOL[dtype])
    for m in (128, 384, 401408, 100352, 25088, 6272, 6400, 15, 32, 96):
        assert pnn._conv1x1_pick_bm(m) == jnn._conv1x1_pick_bm(m), m


# The cases of this file (and of the other slice-3 test files) run as
# loops inside few test functions.  Under pytest-xdist's load scheduler
# (``-n 6 --dist load``) each worker's first chunk is a run of consecutive
# tests sized by the total count; from about 960 tests to about 1150 that
# chunk puts every long example of tests/test_examples_round3.py on one
# worker, and the whole suite then takes as long as that worker.
