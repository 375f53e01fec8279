"""The port's ResNet layer ops against the JAX package's: ``Pooling``,
``BatchNorm``, ``Pad``, ``Flatten``, ``transpose`` and ``Cast``.

The same numpy inputs go through both registries' compute rules on the
CPU; outputs, auxiliary updates and the gradients of every float input
(vjp against the same numpy cotangent) agree at the ``float32`` class of
``ops/fused/parity.py`` (2e-5).  Inputs are normal draws, so a max-pool
window has no tied maximum and both frameworks route its gradient to the
same element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.registry import get_op as pget_op

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    on one CPU, and each torch op would otherwise start a thread per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _run_both(op_name, attrs, args, auxs=(), is_train=False, seed=0):
    """Outputs, aux updates and input gradients of both packages.

    Every output gets a numpy normal cotangent; aux updates get none.
    Returns ``(jax, port)``, each ``(outputs, new_aux, grads of args)``."""
    jop, pop = jget_op(op_name), pget_op(op_name)
    ja, pa = jop.parse_attrs(attrs), pop.parse_attrs(attrs)

    def jf(*a):
        outs, new_aux = jop.apply(ja, list(a), [jnp.asarray(x) for x in auxs],
                                  is_train=is_train)
        return outs, new_aux

    (jouts, jaux), vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(([jnp.asarray(c) for c in cots],
                  [jnp.zeros_like(x) for x in jaux]))
    pargs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    pouts, paux = pop.apply(pa, pargs, [torch.from_numpy(x) for x in auxs],
                            is_train=is_train)
    pgrads = torch.autograd.grad(pouts, pargs,
                                 [torch.from_numpy(c) for c in cots],
                                 allow_unused=True)
    pgrads = [torch.zeros_like(a) if g is None else g
              for a, g in zip(pargs, pgrads)]
    return (jouts, jaux, jgrads), (pouts, paux, pgrads)


def _assert_same(jres, pres, case):
    for kind, js, ps in zip(("output", "aux", "grad"), jres, pres):
        assert len(js) == len(ps), (case, kind)
        for i, (j, p) in enumerate(zip(js, ps)):
            j = np.asarray(j)
            assert tuple(p.shape) == j.shape, (case, kind, i)
            np.testing.assert_allclose(p.detach().numpy(), j,
                                       err_msg="%s %s %d" % (case, kind, i),
                                       **TOL)


# (input H, W; kernel, stride, pad): a 3x3/2 window with pad 1 (ResNet's
# stem pool), a 2x3 window with unequal strides, and a 10-wide input whose
# 'full' convention pads (1, 2): an asymmetric pad
WINDOWS = [((9, 9), (3, 3), (2, 2), (1, 1)),
           ((7, 8), (2, 3), (1, 2), (0, 1)),
           ((10, 10), (3, 3), (2, 2), (1, 1))]


def test_pooling_matches_jax():
    """max/avg/sum, both conventions, both layouts, the windows above;
    global pooling of each type and layout; a 1-D pool.  The cases are a
    loop, not parameters (see the note at the end of
    test_torch_conv1x1.py)."""
    for win, (hw, kernel, stride, pad) in enumerate(WINDOWS):
        rs = np.random.RandomState(win)
        for layout in ("NCHW", "NHWC"):
            shape = (2, 3) + hw if layout == "NCHW" else (2,) + hw + (3,)
            x = rs.randn(*shape).astype(np.float32)
            for pool_type in ("max", "avg", "sum"):
                for convention in ("valid", "full"):
                    attrs = {"kernel": kernel, "stride": stride, "pad": pad,
                             "pool_type": pool_type,
                             "pooling_convention": convention,
                             "layout": layout}
                    _assert_same(*_run_both("Pooling", attrs, [x]),
                                 case=attrs)
    x = np.random.RandomState(1).randn(2, 4, 5, 6).astype(np.float32)
    for layout in ("NCHW", "NHWC"):
        for pool_type in ("max", "avg", "sum"):
            attrs = {"kernel": (7, 7), "global_pool": True,
                     "pool_type": pool_type, "layout": layout}
            _assert_same(*_run_both("Pooling", attrs, [x]), case=attrs)
    x = np.random.RandomState(2).randn(2, 3, 11).astype(np.float32)
    for pool_type in ("max", "avg"):
        attrs = {"kernel": (3,), "stride": (2,), "pad": (1,),
                 "pool_type": pool_type, "pooling_convention": "full"}
        _assert_same(*_run_both("Pooling", attrs, [x]), case=attrs)


def test_batch_norm_matches_jax():
    """Outputs, the moving-statistics updates and the gradients of data,
    gamma and beta, training and inference, with and without
    ``fix_gamma``, channel axis 1 and 3.  The moving mean is far from the
    batch mean, so the shift of the single-pass statistics matters; with
    ``fix_gamma`` gamma's gradient is zero in both."""
    for axis in (1, 3):
        for fix_gamma in (False, True):
            for is_train in (True, False):
                rs = np.random.RandomState(axis + 2 * fix_gamma)
                shape = (4, 3, 5, 6) if axis == 1 else (4, 5, 6, 3)
                x = (rs.randn(*shape) * 2.0 + 3.0).astype(np.float32)
                c = shape[axis]
                gamma = (rs.rand(c) + 0.5).astype(np.float32)
                beta = rs.randn(c).astype(np.float32)
                mm = rs.randn(c).astype(np.float32)
                mv = (rs.rand(c) + 0.5).astype(np.float32)
                attrs = {"axis": axis, "fix_gamma": fix_gamma, "eps": 2e-5,
                         "momentum": 0.9}
                jres, pres = _run_both("BatchNorm", attrs, [x, gamma, beta],
                                       [mm, mv], is_train=is_train)
                _assert_same(jres, pres, case=dict(attrs, train=is_train))
                if fix_gamma:
                    assert not pres[2][1].any()
                if not is_train:   # inference keeps the moving statistics
                    np.testing.assert_array_equal(pres[1][0].numpy(), mm)


def test_pad_and_shape_ops_match_jax():
    """``Pad`` (constant, edge, reflect; the s2d stem's NHWC pad),
    ``Flatten``, ``transpose`` (given axes and reversed) and ``Cast`` (to
    fp32 and to bf16)."""
    x = np.random.RandomState(4).randn(2, 3, 5, 6).astype(np.float32)
    for mode, pad_width in (("constant", (0, 0, 0, 0, 2, 1, 1, 3)),
                            ("constant", (0, 0, 2, 1, 2, 1, 0, 0)),
                            ("edge", (0, 0, 0, 0, 2, 1, 1, 3)),
                            ("reflect", (0, 0, 0, 0, 2, 1, 1, 3))):
        attrs = {"mode": mode, "pad_width": pad_width,
                 "constant_value": 0.5}
        _assert_same(*_run_both("Pad", attrs, [x]), case=attrs)
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    for op_name, attrs in (("Flatten", {}),
                           ("transpose", {"axes": (0, 2, 3, 1)}),
                           ("transpose", {}),
                           ("Cast", {"dtype": "float32"})):
        _assert_same(*_run_both(op_name, attrs, [x]),
                     case=(op_name, attrs))
    # Cast to bf16 rounds as JAX does (to nearest even)
    x = np.random.RandomState(6).randn(4, 33).astype(np.float32)
    pop, jop = pget_op("Cast"), jget_op("Cast")
    attrs = {"dtype": "bfloat16"}
    got = pop.apply(pop.parse_attrs(attrs), [torch.from_numpy(x)])[0][0]
    want = jop.apply(jop.parse_attrs(attrs), [jnp.asarray(x)])[0][0]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
