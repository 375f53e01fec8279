"""mxnet_tpu_torch's optimizer updates against the JAX package.

The port's per-op step (``fused_sgd_mom_update``, its plain version on CPU
tensors) against the JAX stock op ``_sgd_mom_update`` and the Pallas
kernel ``fused_sgd_mom_update`` (interpret mode), and the port's whole-tree
step (``fused_sgd_mom_tree``, in place) and ``sgd_mom_tree_stock`` against
the JAX trainer's ``fused_sgd_mom_tree`` and ``sgd_mom_tree_stock``, each
over the JAX package's own parity grid (``ops/fused/optimizer_kernels.py``).

The port spells the update as the JAX stock op does, every operation
rounded on its own, and is held to bitwise equality with the stock op and
both tree steps.  The Pallas kernel in interpret mode (jax 0.9 on the CPU)
rounds differently from the JAX stock op itself, by up to 512 ulps where
momentum and gradient nearly cancel, so against it the port is held to the
fp32 class of the JAX parity harness, 2e-5 absolute and relative.

The per-op cases also run the optimizer's imperative call,
``nd.sgd_mom_update(w, g, m, out=[w, m])``, in both packages: the port's
writes into the NDArrays' own storage and is bitwise the stock op; the
JAX package's runs its stock op under ``jax.jit``, which XLA rounds as the
interpret-mode kernel does, so it is held to the same fp32 class.

The same cases run the other three update ops, ``adam_update``,
``rmsprop_update`` and ``rmspropalex_update`` (plain PyTorch in both
packages), at ``t`` 1 and 10: registry op and ``nd.<op>(..., out=[...])``
bitwise equal, both within the fp32 class of the JAX stock ops.  Every
optimizer class runs three updates on CPU NDArrays against the JAX
package's, within the fp32 class; SGLD's noise is held to its moments
(the two packages draw from other generators).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import context as jctx
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.ops import tensor as jtensor
from mxnet_tpu.ops.fused import optimizer_kernels as jok
from mxnet_tpu.ops.fused.parity import _PARITY
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch import ndarray as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import optimizer_kernels as pok
from mxnet_tpu_torch.ops.registry import get_op

# The three other update ops: the JAX stock rule, and the op's states made
# from the case's momentum array ``m`` and weight ``w`` (second moments
# non-negative, rmspropalex's n at least g^2, so its root stays real).
_OTHER_OPS = {
    "adam_update": (jtensor._adam_update, lambda w, m: (m, m * m)),
    "rmsprop_update": (jtensor._rmsprop_update, lambda w, m: (m * m,)),
    "rmspropalex_update": (jtensor._rmspropalex_update,
                           lambda w, m: (m * m + w * w, m, w)),
}
_PER_OP = _PARITY[("sgd_mom_update", "fused")]
_TREE = _PARITY[("sgd_mom_tree_update", "fused")]


def _t(a):
    return torch.from_numpy(np.array(a))


TOL = 2e-5


@pytest.mark.parametrize("case", _PER_OP.grid)
def test_per_op_step_matches_stock_and_pallas_kernel(case):
    stock, fused, args = jok._sgd_mom_case(case)
    shape, lr, wd, momentum, rescale, clip = case
    attrs = {"lr": lr, "wd": wd, "momentum": momentum,
             "rescale_grad": rescale, "clip_gradient": clip}
    w, m = pok.fused_sgd_mom_update(attrs, *map(_t, args))
    for got, want in zip((w, m), stock(*args)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip((w, m), fused(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    # the registry op is the same step
    op = get_op("sgd_mom_update")
    (w2, m2), _ = op.apply(op.parse_attrs(attrs), list(map(_t, args)))
    assert torch.equal(w2, w) and torch.equal(m2, m)
    # and so is the optimizer's imperative call, into the arrays' storage
    jw, jg, jm = (jnd.array(np.asarray(a), ctx=jctx.cpu()) for a in args)
    jnd.sgd_mom_update(jw, jg, jm, out=[jw, jm], **attrs)
    with cpu():
        nw, ng, nm = (pnd.array(np.asarray(a)) for a in args)
    where = (nw._data.data_ptr(), nm._data.data_ptr())
    got = pnd.sgd_mom_update(nw, ng, nm, out=[nw, nm], **attrs)
    assert got[0] is nw and got[1] is nm
    assert (nw._data.data_ptr(), nm._data.data_ptr()) == where
    assert torch.equal(nw._data, w) and torch.equal(nm._data, m)
    for got, want in ((nw, jw), (nm, jm)):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                                   atol=TOL)
    # the other update ops at the case's inputs, t 1 and 10
    w_np, g_np, m_np = (np.asarray(a) for a in args)
    for name, (stock_rule, make_states) in _OTHER_OPS.items():
        op = get_op(name)
        ins = (w_np, g_np) + make_states(w_np, m_np)
        for t in (1, 10):
            kw = {"lr": lr, "wd": wd, "rescale_grad": rescale,
                  "clip_gradient": clip}
            if "t" in op.params:
                kw["t"] = t
            want = stock_rule(jget_op(name).parse_attrs(kw),
                              *map(jnp.asarray, ins))
            got, _ = op.apply(op.parse_attrs(kw), list(map(_t, ins)))
            assert len(got) == len(want) == len(ins) - 1
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=TOL, atol=TOL,
                                           err_msg="%s t=%d %d" % (name, t, i))
            with cpu():
                arrs = [pnd.array(a) for a in ins]
            outs = [arrs[0]] + arrs[2:]
            where = [a._data.data_ptr() for a in outs]
            getattr(pnd, name)(*arrs, out=outs, **kw)
            assert [a._data.data_ptr() for a in outs] == where
            for a, b in zip(outs, got):
                assert torch.equal(a._data, b), (name, t)


@pytest.mark.parametrize("case", _TREE.grid)
def test_tree_step_is_bitwise_the_jax_tree_step(case):
    stock, fused, (params, grads, moms, ok) = jok._sgd_mom_tree_case(case)
    want_p, want_m = fused(params, grads, moms, ok)
    stock_p, stock_m = stock(params, grads, moms, ok)
    attrs = {"lr": 0.05, "wd": 1e-4, "momentum": 0.9, "rescale_grad": 1.0,
             "clip_gradient": case[1]}
    tp = {n: _t(a) for n, a in params.items()}
    tg = {n: _t(a) for n, a in grads.items()}
    tm = {n: _t(a) for n, a in moms.items()}
    tok = None if ok is None else torch.tensor(bool(ok))
    got_sp, got_sm = pok.sgd_mom_tree_stock(attrs, tp, tg, tm, tok)
    got_p, got_m = pok.fused_sgd_mom_tree(attrs, tp, tg, tm, tok)
    assert got_p is tp and got_m is tm      # in place
    for n in params:
        for got, want in ((got_p[n], want_p[n]), (got_m[n], want_m[n]),
                          (got_sp[n], stock_p[n]), (got_sm[n], stock_m[n])):
            assert np.array_equal(got.numpy(), np.asarray(want)), n


def test_nan_gradient_stays_nan_through_the_clip():
    attrs = {"lr": 0.1, "wd": 0.0, "momentum": 0.9, "rescale_grad": 1.0,
             "clip_gradient": 0.5}
    w = torch.ones(3)
    g = torch.tensor([float("nan"), 2.0, -2.0])
    nw, nm = pok.sgd_mom_update_plain(attrs, w, g, torch.zeros(3))
    assert torch.isnan(nw[0]) and torch.isnan(nm[0])
    assert torch.allclose(nm[1:], torch.tensor([-0.05, 0.05]))
    # and through the other update ops: only the NaN's element goes NaN
    for name, (_, make_states) in _OTHER_OPS.items():
        op = get_op(name)
        outs, _ = op.apply(op.parse_attrs({"lr": 0.1, "clip_gradient": 0.5}),
                           [w, g, *make_states(w, torch.ones(3))])
        for out in outs:
            assert torch.isnan(out[0]) and torch.isfinite(out[1:]).all(), \
                name


# Every optimizer of both packages' registries (RMSProp in both settings):
# name and constructor arguments besides the shared ones of _OPT_SHARED.
_OPTIMIZERS = (("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
               ("ccsgd", {"momentum": 0.9}), ("adam", {}),
               ("adagrad", {}), ("rmsprop", {}),
               ("rmsprop", {"centered": True}), ("adadelta", {}),
               ("ftrl", {}), ("dcasgd", {"momentum": 0.9}), ("test", {}))
_OPT_SHARED = {"learning_rate": 0.05, "wd": 1e-3, "clip_gradient": 0.8,
               "rescale_grad": 0.5, "param_idx2name": {0: "fc_weight"}}


def _three_updates(mx, name, kw, w, grads):
    """Three updates of optimizer ``name`` on CPU NDArrays from ``w``
    (``fc_weight`` at lr_mult 0.5): the weight and the states as numpy."""
    opt = mx.optimizer.create(name, **dict(_OPT_SHARED, **kw))
    opt.set_lr_mult({"fc_weight": 0.5})
    updater = mx.optimizer.get_updater(opt)
    with mx.cpu():
        weight = mx.nd.array(w)
        for g in grads:
            updater(0, mx.nd.array(g), weight)
    state = updater.states[0]
    state = state if isinstance(state, tuple) else (state,)
    return weight.asnumpy(), [s.asnumpy() for s in state if s is not None]


def _sgld_noise(mx, w, g):
    """One SGLD update of ``w`` less its deterministic part: the noise."""
    lr = _OPT_SHARED["learning_rate"] * 0.5
    out, _ = _three_updates(mx, "sgld", {}, w, [g])
    g = np.clip(g * _OPT_SHARED["rescale_grad"], -0.8, 0.8)
    return out - (w - lr / 2 * (g + _OPT_SHARED["wd"] * w)), lr


def test_cpu_steps_launch_no_kernel_and_other_devices_raise():
    """Every optimizer's three CPU updates (wd, a clip, rescale_grad and an
    lr_mult) within the fp32 class of the JAX package's, launching no
    kernel; SGLD's noise by its moments over 65,536 elements, repeated by a
    seed; the per-op momentum kernel's grid; a device that is neither CPU
    nor CUDA raises."""
    reset_launch_counts()
    rng = np.random.default_rng(7)
    w = rng.standard_normal((17, 33)).astype(np.float32)
    grads = [rng.standard_normal((17, 33)).astype(np.float32)
             for _ in range(3)]
    names = {name for name, _ in _OPTIMIZERS} | {"sgld"}
    assert names == set(pmx.optimizer.Optimizer.opt_registry) \
        == set(jmx.optimizer.Optimizer.opt_registry)
    for name, kw in _OPTIMIZERS:
        pw, ps = _three_updates(pmx, name, kw, w, grads)
        jw, js = _three_updates(jmx, name, kw, w, grads)
        assert len(ps) == len(js) and not np.array_equal(pw, w), name
        for got, want in zip([pw] + ps, [jw] + js):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg="%s %s" % (name, kw))
    big = rng.standard_normal((256, 256)).astype(np.float32)
    pmx.random.seed(11)
    noise, lr = _sgld_noise(pmx, big, big)
    # mean 0 and variance lr, each within five standard errors
    assert abs(noise.mean()) < 5 * np.sqrt(lr / noise.size)
    assert abs(noise.var() / lr - 1) < 5 * np.sqrt(2.0 / noise.size)
    pmx.random.seed(11)
    again, _ = _sgld_noise(pmx, big, big)
    pmx.random.seed(12)
    other, _ = _sgld_noise(pmx, big, big)
    assert np.array_equal(again, noise) and not np.allclose(other, noise)

    attrs = {"lr": 0.1, "wd": 0.0, "momentum": 0.9, "rescale_grad": 1.0,
             "clip_gradient": -1.0}
    w = torch.ones(5)
    pok.fused_sgd_mom_update(attrs, w, w, w)
    pok.fused_sgd_mom_tree(attrs, {"a": w.clone()}, {"a": w}, {"a": w.clone()})
    counts = launch_counts()
    assert counts["sgd_mom_update"] == counts["sgd_mom_multi"] == 0
    assert counts["sgd_mom_update_v1"] == 0
    assert not any(counts.values()), counts
    # the per-op launch's grid: at least one block, at most a wave of
    # resident blocks, and none without a float4 group of its own
    for per_sm in (1, 3, 8):
        for n in (1, 3, 4, 1023, 65536, 65537, 1 << 20, 1 << 22,
                  32000 * 1024):
            grid = pok._per_op_grid(n, 132, per_sm)
            assert 1 <= grid <= 132 * per_sm
            assert grid <= -(-n // (pok._PER_OP_THREADS * 4
                                    * pok._PER_OP_UNROLL))
        assert pok._per_op_grid(0, 132, per_sm) == 0
    meta = torch.empty(5, device="meta")
    with pytest.raises(MXNetError):
        pok.fused_sgd_mom_update(attrs, meta, meta, meta)
    with pytest.raises(MXNetError):
        pok.fused_sgd_mom_tree(attrs, {"a": meta}, {"a": meta}, {"a": meta})
