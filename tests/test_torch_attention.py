"""mxnet_tpu_torch's prefill and paged decode attention against the JAX
package.

Prefill: the port's ``fused_prefill_attention`` on CPU tensors (its plain
version) against the JAX package's ``fused_prefill_attention`` (the Pallas
flash kernel, interpret mode) and ``_stable_causal_attention_stock``,
including a ragged T.  Paged decode: against ``fused_paged_decode_attention``
(interpret mode) on two cases of that kernel's own parity grid
(``attention_kernels.py`` ``_paged_case``).  Tolerance 2e-5 absolute and
relative (fp32 class): the two frameworks sum the softmax and P.V in
different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops.fused import attention_kernels as jak
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as patt
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import attention_kernels as pak

TOL = 2e-5


def _qkv(shape, seed, tk=None):
    rng = np.random.RandomState(seed)
    kshape = shape[:2] + (tk or shape[2], shape[3])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*kshape).astype(np.float32),
            rng.randn(*kshape).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 2, 64, 16), (2, 2, 67, 16)])
def test_prefill_matches_jax_flash_and_stock(shape):
    q, k, v = _qkv(shape, seed=shape[2])
    got = pak.fused_prefill_attention(*map(torch.from_numpy, (q, k, v)))
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    flash = np.asarray(jak.fused_prefill_attention(*jargs))
    stock = np.asarray(jatt._stable_causal_attention_stock(*jargs))
    np.testing.assert_allclose(got.numpy(), flash, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), stock, rtol=TOL, atol=TOL)


def test_prefill_continuation_mask_matches_stock():
    """k longer than q (a continuation): row i sees keys <= i + Tk - Tq,
    the JAX package's offset causal mask."""
    q, k, v = _qkv((1, 2, 5, 8), seed=7, tk=12)
    got = patt.stable_causal_attention_plain(
        *map(torch.from_numpy, (q, k, v)))
    stock = np.asarray(jatt._stable_causal_attention_stock(
        *map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got.numpy(), stock, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [
    ("float32", 2, 16, 8, 3, (5, 20)),        # ragged contexts
    ("float32", 4, 32, 16, 2, (1, 17, 32)),   # ctx=1 and a full tail
])
def test_paged_decode_matches_jax_kernel(case):
    _, fused, args = jak._paged_case(case)
    want = np.asarray(fused(*args))
    np_args = [np.array(a) for a in args]
    got = pak.fused_paged_decode_attention(
        *[torch.from_numpy(a) for a in np_args])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_paged_decode_ignores_pad_pages_and_tails():
    """Whatever the pad block 0 and the unwritten tail of the last page
    hold, the output is the same (positions >= context_len are masked)."""
    _, _, args = jak._paged_case(("float32", 2, 16, 8, 3, (5, 20)))
    q, ks, vs, kp, vp, bt, cl = [torch.from_numpy(np.asarray(a).copy())
                                 for a in args]
    base = pak.fused_paged_decode_attention(q, ks, vs, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e3
    vp2[0] = -1e3
    kp2[bt[0, 0], 5:] = 7.0     # seq 0 has 5 tokens in its first page
    out = pak.fused_paged_decode_attention(q, ks, vs, kp2, vp2, bt, cl)
    assert torch.equal(out, base)


def test_cpu_tensors_launch_no_kernel():
    reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 9, 8), seed=1))
    patt.stable_causal_attention(q, k, v)
    assert launch_counts()["flash_prefill"] == 0
    assert launch_counts()["paged_decode"] == 0


def test_mixed_devices_raise():
    q = torch.empty(1, 2, 4, 8, device="meta")
    with pytest.raises(MXNetError):
        pak.fused_prefill_attention(q, q, q)
