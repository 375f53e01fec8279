"""mxnet_tpu_torch's PagedKVCache: allocator lifecycle, typed 429, and pools
equal to the JAX package's cache after the same writes."""

import numpy as np
import pytest
import torch

from mxnet_tpu.ops.kv_cache import PagedKVCache as JaxCache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kv_cache import CacheExhaustedError, PagedKVCache
from mxnet_tpu_torch.serving import admission


def _cache(cls=PagedKVCache, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 6)
    if cls is PagedKVCache:
        kw.setdefault("device", "cpu")
    return cls(num_layers=2, num_heads=2, head_dim=3, **kw)


def test_alloc_free_lifecycle():
    c = _cache()
    c.allocate("a", 5)                       # 2 blocks
    c.allocate("b", 4)                       # 1 block
    assert c.stats()["used"] == 3
    c.allocate("a", 8)                       # growth within 2 blocks: no-op
    assert len(c.block_table("a", 4).nonzero()[0]) <= 2
    c.allocate("a", 9)                       # grows to 3 blocks
    assert c.stats()["used"] == 4
    table = c.block_table("a", 5)
    assert table.dtype == np.int32 and list(table[3:]) == [0, 0]
    assert sorted(c.free("a")) == sorted(table[:3].tolist())
    assert c.free("missing") == []
    assert c.stats()["used"] == 1 and c.sequences() == ["b"]
    with pytest.raises(MXNetError):
        c.block_table("a", 4)


def test_exhaustion_is_typed_429_and_allocates_nothing():
    c = _cache()
    c.allocate("a", 16)                      # 4 of 6 blocks
    with pytest.raises(CacheExhaustedError) as ei:
        c.allocate("b", 12)                  # needs 3, 2 free
    err = ei.value
    assert err.http_status == 429
    assert err.kv_cache_blocks_free == 2 and err.kv_cache_blocks_total == 6
    assert admission.reject_reason(err) == "cache_exhausted"
    assert c.stats()["used"] == 4 and c.sequences() == ["a"]


def test_writes_past_the_allocation_raise():
    c = _cache()
    c.allocate("a", 4)
    with pytest.raises(MXNetError):
        c.write_prefill("a", np.zeros((2, 5, 2, 3), np.float32),
                        np.zeros((2, 5, 2, 3), np.float32))
    with pytest.raises(MXNetError):
        c.write_token("a", 4, np.zeros((2, 2, 3), np.float32),
                      np.zeros((2, 2, 3), np.float32))


def test_pools_and_stats_equal_the_jax_cache_after_the_same_writes():
    rng = np.random.RandomState(0)
    ours, theirs = _cache(), _cache(JaxCache)
    assert ours.k_pages.device.type == "cpu"
    for c in (ours, theirs):
        c.allocate("a", 7)
        c.allocate("b", 3)
    ka, va = (rng.randn(2, 6, 2, 3).astype(np.float32) for _ in range(2))
    kb, vb = (rng.randn(2, 3, 2, 3).astype(np.float32) for _ in range(2))
    steps = [(rng.randn(2, 2, 3).astype(np.float32),
              rng.randn(2, 2, 3).astype(np.float32)) for _ in range(2)]
    theirs.write_prefill("a", ka, va)
    theirs.write_prefill("b", kb, vb)
    theirs.write_token("a", 6, *steps[0])
    theirs.write_token("b", 3, *steps[1])
    ours.write_prefill("a", torch.from_numpy(ka), torch.from_numpy(va))
    ours.write_prefill("b", kb, vb)
    # the decode step's batch write: both sequences in one indexed copy
    k_step = torch.from_numpy(np.stack([steps[0][0], steps[1][0]], 1))
    v_step = torch.from_numpy(np.stack([steps[0][1], steps[1][1]], 1))
    ours.write_tokens(["a", "b"], [6, 3], k_step, v_step)
    assert np.array_equal(ours.k_pages.numpy(), theirs.k_pages)
    assert np.array_equal(ours.v_pages.numpy(), theirs.v_pages)
    assert ours.length("a") == theirs.length("a") == 7
    assert ours.stats() == theirs.stats()
    ours.free("a")
    theirs.free("a")
    assert ours.stats() == theirs.stats()


def test_cache_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        PagedKVCache(num_layers=1, num_heads=1, head_dim=2)
