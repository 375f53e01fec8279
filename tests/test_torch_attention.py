"""mxnet_tpu_torch's prefill and paged decode attention against the JAX
package.

Prefill: the port's ``fused_prefill_attention`` on CPU tensors (its plain
version) against the JAX package's ``fused_prefill_attention`` (the Pallas
flash kernel, interpret mode) and ``_stable_causal_attention_stock``,
including a ragged T.  Paged decode: against ``fused_paged_decode_attention``
(interpret mode) on three cases of that kernel's own parity grid
(``attention_kernels.py`` ``_paged_case``), the bf16 pool among them.
Tolerance 2e-5 absolute and relative (fp32 class) for fp32 inputs: the two
frameworks sum the softmax and P.V in different orders; the bf16 case is held
to the bf16 class of ``parity._TOL``.  Torch runs on one intra-op thread here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops.fused import attention_kernels as jak
from mxnet_tpu.ops.fused.parity import _TOL
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as patt
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.fused import attention_kernels as pak

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread.  Torch's first
    multi-threaded ``exp`` in a process (MKL VML, in chunks of 2048 over
    its OpenMP threads) has returned one worker thread's chunk off by
    ~1e-4 of its value while the same call again was exact (the prefill
    test's scores of one head and 32 rows; ROADMAP Queue C)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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
    ("bfloat16", 2, 64, 8, 2, (3, 9)),        # bf16 pool, fp32 math
])
def test_paged_decode_matches_jax_kernel(case):
    _, fused, args = jak._paged_case(case)
    want = np.asarray(fused(*args))
    # torch.from_numpy refuses ml_dtypes' bfloat16: go through float32
    dtype = getattr(torch, case[0])
    got = pak.fused_paged_decode_attention(*[
        torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))
        for a in args])
    assert got.dtype == torch.float32
    rtol, atol = _TOL[case[0]] if case[0] != "float32" else (TOL, TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_decode_splits_cover_the_card(monkeypatch):
    """The paged decode kernel's split count: about 4 blocks per SM over
    B * H * splits, no split of a full table under 64 keys, at most one
    split per page, at least one.  The work counters of the paged decode
    and the bf16 forward: one buffer per (device, stream), allocated anew
    and the old one kept when a launch needs more (on the CPU, with a
    stand-in for the current stream)."""
    sms = 132
    # the lane's step: 8 sequences, 16 heads, 128 pages of 16
    assert pak.decode_splits(8, 16, 128, 16, sms) == 5
    assert pak.decode_splits(1, 16, 128, 16, sms) == 32    # 2048 // 64 keys
    assert pak.decode_splits(64, 16, 128, 16, sms) == 1
    assert pak.decode_splits(1, 1, 3, 4, sms) == 1          # 12 keys
    assert pak.decode_splits(1, 1, 1000, 1, sms) == 15      # 1000 // 64
    for bsz in (1, 2, 8, 32):
        s = pak.decode_splits(bsz, 16, 128, 16, sms)
        assert 1 <= s <= 32 and (bsz * 16 * s >= 4 * sms or s == 32)

    stream = [11]

    class _Stream(object):
        @property
        def cuda_stream(self):
            return stream[0]

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(pak, "_counters", {})
    cpu = torch.device("cpu")
    first = pak._work_counters(cpu, 128)
    assert first.numel() == 1024 and not first.any()
    assert pak._work_counters(cpu, 2) is first
    stream[0] = 12
    second = pak._work_counters(cpu, 128)
    assert second is not first
    assert pak._work_counters(cpu, 1024) is second
    grown = pak._work_counters(cpu, 2048)
    assert grown.numel() == 2048 and grown is not second
    assert pak._counters == {(cpu, 11): [first], (cpu, 12): [second, grown]}


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
