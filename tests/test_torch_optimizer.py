"""mxnet_tpu_torch's SGD-momentum step against the JAX package.

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
"""

import numpy as np
import pytest
import torch

from mxnet_tpu.ops.fused import optimizer_kernels as jok
from mxnet_tpu.ops.fused.parity import _PARITY
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import optimizer_kernels as pok
from mxnet_tpu_torch.ops.registry import get_op

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


def test_cpu_steps_launch_no_kernel_and_other_devices_raise():
    reset_launch_counts()
    attrs = {"lr": 0.1, "wd": 0.0, "momentum": 0.9, "rescale_grad": 1.0,
             "clip_gradient": -1.0}
    w = torch.ones(5)
    pok.fused_sgd_mom_update(attrs, w, w, w)
    pok.fused_sgd_mom_tree(attrs, {"a": w.clone()}, {"a": w}, {"a": w.clone()})
    counts = launch_counts()
    assert counts["sgd_mom_update"] == counts["sgd_mom_multi"] == 0
    meta = torch.empty(5, device="meta")
    with pytest.raises(MXNetError):
        pok.fused_sgd_mom_update(attrs, meta, meta, meta)
    with pytest.raises(MXNetError):
        pok.fused_sgd_mom_tree(attrs, {"a": meta}, {"a": meta}, {"a": meta})
