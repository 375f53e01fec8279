"""mxnet_tpu_torch's ``LayerNorm`` op against the JAX package.

Forward: the port's op (its kernel wrapper's plain version on CPU tensors)
against the Pallas kernel ``fused_layer_norm_op`` (interpret mode) and the
stock op ``_layer_norm``.  Gradient: the port's ``torch.autograd.Function``
(backward from the forward's row statistics) against ``jax.grad`` of the
stock ``_layer_norm``, because the Pallas kernel has no gradient rule.
Tolerance 2e-5 (the fp32 class of the JAX parity harness) for the forward
and 1e-4 for gradients, which sum over every row.  The reference grid's bf16
and fp16 cases (``norm_kernels.py`` ``_ln_op_case``) hold the forward's plain
version, fp32 math with y in the data's dtype, to ``parity._TOL``'s class of
that dtype; on the same cases the op's gradient (fp32 math) against
``jax.grad`` of the stock op: the data's gradient in its dtype, to its
class, and gamma's and beta's in fp32, to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops.fused import norm_kernels as jnk
from mxnet_tpu.ops.fused.parity import _TOL
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import norm_kernels as pnk
from mxnet_tpu_torch.ops.registry import get_op

TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(shape, axis, seed):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    return (rng.randn(*shape).astype(np.float32) * 3 + 1,
            rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,axis", [((2, 16, 32), -1), ((3, 7, 33), -1),
                                        ((4, 6, 5), 1)])
def test_layer_norm_op_forward_and_gradient_match_jax(shape, axis):
    x, g, b, dy = _inputs(shape, axis, seed=sum(shape))
    attrs = {"axis": axis, "eps": 1e-5}
    jargs = tuple(map(jnp.asarray, (x, g, b)))
    stock = np.asarray(jatt._layer_norm(attrs, *jargs))
    kernel = np.asarray(jnk.fused_layer_norm_op(attrs, *jargs))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    (y,), _ = get_op("LayerNorm").apply(get_op("LayerNorm").parse_attrs(
        {"axis": axis}), xs)
    np.testing.assert_allclose(y.detach().numpy(), kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.detach().numpy(), stock, rtol=TOL, atol=TOL)

    def loss(x, g, b):
        return jnp.sum(jatt._layer_norm(attrs, x, g, b) * jnp.asarray(dy))

    want = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_layer_norm_op_low_precision_matches_jax():
    for case in (("bfloat16", (3, 5, 64)), ("float16", (2, 9, 17))):
        stock, fused, (data, gamma, beta) = jnk._ln_op_case(case)
        want_kernel = np.asarray(fused(data, gamma, beta)).astype(np.float32)
        want_stock = np.asarray(stock(data, gamma, beta)).astype(np.float32)
        dtype = getattr(torch, case[0])
        x = torch.from_numpy(np.asarray(data).astype(np.float32)).to(dtype)
        y, mean, rstd = pnk.fused_layer_norm_op(
            x, torch.from_numpy(np.array(gamma)),
            torch.from_numpy(np.array(beta)))
        assert y.dtype == dtype and mean.dtype == rstd.dtype == torch.float32
        rtol, atol = _TOL[case[0]]
        for want in (want_kernel, want_stock):
            np.testing.assert_allclose(y.float().numpy(), want, rtol=rtol,
                                       atol=atol)
        x64 = np.asarray(data).astype(np.float64).reshape(-1, case[1][-1])
        np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(rstd.numpy(),
                                   1 / np.sqrt(x64.var(-1) + 1e-5),
                                   rtol=TOL, atol=TOL)
        # the gradient: fp32 math, dx in the data's dtype, dgamma and dbeta
        # in the parameters' (fp32), as autodiff of the JAX op gives them
        dy = np.random.RandomState(7).randn(*case[1]).astype(np.float32)
        attrs = {"axis": -1, "eps": 1e-5}

        def loss(x, g, b):
            y = jatt._layer_norm(attrs, x, g, b).astype(jnp.float32)
            return jnp.sum(y * jnp.asarray(dy))

        want = jax.grad(loss, argnums=(0, 1, 2))(data, gamma, beta)
        xs = [x.requires_grad_(True)] + [
            torch.from_numpy(np.array(a)).requires_grad_(True)
            for a in (gamma, beta)]
        op = get_op("LayerNorm")
        (y,), _ = op.apply(op.parse_attrs({}), xs)
        assert y.dtype == dtype
        got = torch.autograd.grad(y, xs, torch.from_numpy(dy).to(dtype))
        assert got[0].dtype == dtype and want[0].dtype == data.dtype
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.asarray(want[0]).astype(np.float32),
                                   rtol=rtol, atol=atol)
        for gt, wt in zip(got[1:], want[1:]):
            assert gt.dtype == torch.float32
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)


def test_row_statistics_are_mean_and_rsqrt_of_population_variance():
    x, g, b, _ = _inputs((5, 12), -1, seed=3)
    y, mean, rstd = pnk.fused_layer_norm_op(*map(torch.from_numpy, (x, g, b)))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x64.var(-1) + 1e-5),
                               rtol=TOL, atol=TOL)
    assert mean.shape == rstd.shape == (5,)


def test_cpu_layer_norm_op_launches_no_kernel():
    reset_launch_counts()
    x, g, b, _ = _inputs((2, 8), -1, seed=0)
    pnk.layer_norm_op(*map(torch.from_numpy, (x, g, b)))
    assert launch_counts()["layer_norm_op"] == 0
