"""mxnet_tpu_torch's LM layer norm and GELU+bias against the JAX package.

The same numpy inputs (seeded) go through the port's wrappers on CPU
tensors (their plain versions) and through the JAX package's Pallas
kernels ``fused_lm_layer_norm`` / ``fused_lm_gelu_bias`` (interpret mode on
the CPU) and their stock twins.  Tolerance: the fp32 class of the JAX
package's parity harness, 2e-5 absolute and relative — the two frameworks
sum the row statistics in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops.fused import norm_kernels as jnk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import norm_kernels as pnk

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(c).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 1, 32), (3, 21, 33)])
def test_lm_layer_norm_matches_jax(shape):
    x, gamma, beta = _inputs(shape, seed=sum(shape))
    got = pnk.lm_layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                            torch.from_numpy(beta)).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    kernel = np.asarray(jnk.fused_lm_layer_norm(*jargs))
    stock = np.asarray(jtfm._lm_ln_stock(*jargs))
    np.testing.assert_allclose(got, kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, stock, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 16, 128), (1, 1, 64), (3, 17, 65)])
def test_lm_gelu_bias_matches_jax(shape):
    h, bias, _ = _inputs(shape, seed=sum(shape) + 1)
    got = pnk.lm_gelu_bias(torch.from_numpy(h),
                           torch.from_numpy(bias)).numpy()
    kernel = np.asarray(jnk.fused_lm_gelu_bias(jnp.asarray(h),
                                               jnp.asarray(bias)))
    stock = np.asarray(jtfm._lm_gelu_bias_stock(jnp.asarray(h),
                                                jnp.asarray(bias)))
    np.testing.assert_allclose(got, kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, stock, rtol=TOL, atol=TOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's default is
    erf, which differs by up to ~4e-4 on [-3, 3] and must not be used."""
    h = torch.linspace(-3, 3, 601)
    zero = torch.zeros(1)
    got = pnk.lm_gelu_bias(h, zero)
    assert torch.equal(got, torch.nn.functional.gelu(h, approximate="tanh"))
    assert (got - torch.nn.functional.gelu(h)).abs().max() > 1e-4


def test_cpu_tensors_launch_no_kernel():
    reset_launch_counts()
    x, gamma, beta = (torch.from_numpy(a) for a in _inputs((2, 3, 8), 0))
    pnk.lm_layer_norm(x, gamma, beta)
    pnk.lm_gelu_bias(x, beta)
    assert launch_counts()["lm_layer_norm"] == 0
    assert launch_counts()["lm_gelu_bias"] == 0


def test_wrappers_refuse_other_devices():
    """Neither CPU nor CUDA: the wrapper raises instead of guessing."""
    x = torch.empty(2, 8, device="meta")
    g = torch.empty(8, device="meta")
    with pytest.raises(MXNetError):
        pnk.lm_layer_norm(x, g, g)
    with pytest.raises(MXNetError):
        pnk.lm_gelu_bias(x, g)
