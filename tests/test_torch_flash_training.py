"""mxnet_tpu_torch's flash attention with its gradient against the JAX
package's Pallas flash kernels.

Forward: the port's ``fused_flash_fwd`` on CPU tensors (its plain version)
against ``_flash_fwd_pallas(..., return_lse=True, interpret=True)``, o and
lse.  Backward: ``dq, dk, dv`` of the port's ``flash_attention``
(``torch.autograd.Function``, plain versions on the CPU) against
``jax.grad`` of ``flash_attention(..., interpret=True)``, which runs the
Pallas dk/dv and dq kernels in interpret mode.  Both causal values, T 64,
a ragged T 72, Tk != T and a scale other than 1/sqrt(D).  Tolerances as in
``tests/test_attention.py``: 2e-5 for the forward, 1e-4 for gradients
(the frameworks sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as patt
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import attention_kernels as pak

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(t, tk, seed, b=1, h=2, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, t, d).astype(np.float32))


@pytest.mark.parametrize("t,tk,causal,scale", [
    (64, 64, True, None),
    (72, 72, False, 0.3),     # ragged, not causal, another scale
    (64, 48, False, None),    # Tk != T
])
def test_flash_forward_and_lse_match_pallas(t, tk, causal, scale):
    q, k, v, _ = _inputs(t, tk, seed=t + tk)
    sm = scale if scale is not None else q.shape[-1] ** -0.5
    want_o, want_lse = jatt._flash_fwd_pallas(
        *map(jnp.asarray, (q, k, v)), causal, sm, interpret=True,
        return_lse=True)
    o, lse = pak.fused_flash_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                                 scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("t,tk,causal,scale", [
    (64, 64, True, 0.2),
    (72, 72, False, None),
])
def test_flash_gradients_match_pallas_backward(t, tk, causal, scale):
    q, k, v, w = _inputs(t, tk, seed=2 * t + 1)

    def loss(q, k, v):
        return jnp.sum(jatt.flash_attention(q, k, v, causal=causal,
                                            sm_scale=scale, interpret=True)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = patt.flash_attention(*xs, causal=causal, sm_scale=scale)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_backward_plain_agrees_with_autograd_of_the_forward():
    """The plain backward from lse equals autograd through the plain
    forward (so the lse convention is the forward's own), causal, with a
    scale other than 1/sqrt(D)."""
    q, k, v, do = map(torch.from_numpy, _inputs(40, 40, seed=5))
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    o, _ = patt.flash_fwd_plain(*xs, True, 0.37)
    want = torch.autograd.grad(o, xs, do)
    o, lse = patt.flash_fwd_plain(q, k, v, True, 0.37)
    got = patt.flash_bwd_plain(q, k, v, o, lse, do, True, 0.37)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_cpu_training_path_launches_no_kernel():
    reset_launch_counts()
    q, k, v, _ = map(torch.from_numpy, _inputs(8, 8, seed=1))
    xs = [a.requires_grad_(True) for a in (q, k, v)]
    patt.flash_attention(*xs, causal=True).sum().backward()
    counts = launch_counts()
    assert counts["flash_prefill"] == counts["flash_bwd_dkdv"] \
        == counts["flash_bwd_dq"] == 0


def test_flash_wrappers_refuse_other_devices():
    q = torch.empty(1, 2, 4, 16, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(MXNetError):
        pak.fused_flash_fwd(q, q, q)
    with pytest.raises(MXNetError):
        pak.fused_flash_bwd(q, q, q, q, lse, q)
