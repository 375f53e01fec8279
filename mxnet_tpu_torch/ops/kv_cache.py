"""Block-allocated paged KV cache for autoregressive decode.

Counterpart of ``mxnet_tpu/ops/kv_cache.py``: the same free-list allocator,
per-sequence block tables, typed 429 on exhaustion and ``stats()``.  K/V
live in fixed-size token blocks drawn from a shared pool; logical position
``t`` of a sequence lives at ``(table[t // block_size], t % block_size)``.

Layout, as in the JAX package::

    k_pages / v_pages : [num_layers, num_blocks, block_size, heads, dim]

The pools are torch tensors on the cache's device, allocated once and
updated in place (the JAX package keeps host numpy pools and ships them to
the device every step).  A prefill's K/V go in with one indexed copy per
pool, and a decode step's K/V for the whole batch with one more: nothing
moves through the host.  Allocation and block tables stay on the host.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["CacheExhaustedError", "PagedKVCache", "default_block_size",
           "default_num_blocks"]


class CacheExhaustedError(MXNetError):
    """No free KV-cache blocks for a new sequence or a grown one.

    Carries ``http_status = 429`` (the client should back off and retry;
    accepted sequences are never evicted to make room).
    """

    http_status = 429


def default_block_size():
    """Tokens per cache block (``MXNET_TPU_GEN_BLOCK_SIZE``, default 16)."""
    return int(os.environ.get("MXNET_TPU_GEN_BLOCK_SIZE", "16"))


def default_num_blocks():
    """Blocks in the shared pool (``MXNET_TPU_GEN_BLOCKS``, default 64)."""
    return int(os.environ.get("MXNET_TPU_GEN_BLOCKS", "64"))


class PagedKVCache(object):
    """Free-list block allocator + per-sequence block tables + the pools.

    Thread-safe: the generation lane allocates and frees from its loop
    thread while clients may cancel from theirs.
    """

    def __init__(self, num_layers, num_heads, head_dim, block_size=None,
                 num_blocks=None, dtype=torch.float32, device=None,
                 model="default"):
        self.block_size = int(block_size or default_block_size())
        self.num_blocks = int(num_blocks or default_num_blocks())
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise MXNetError("PagedKVCache needs positive block_size/"
                             "num_blocks (got %d/%d)"
                             % (self.block_size, self.num_blocks))
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.model = model
        self.device = resolve_device(device)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._lock = threading.Lock()
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables = {}      # seq_id -> [block ids]
        self._lengths = {}     # seq_id -> tokens written

    # -- allocation --------------------------------------------------

    def _blocks_for(self, num_tokens):
        return -(-max(num_tokens, 1) // self.block_size)

    def allocate(self, seq_id, num_tokens):
        """Reserve capacity for ``num_tokens`` total tokens of ``seq_id``.

        Idempotent growth: call again with a larger total to extend.
        Raises :class:`CacheExhaustedError` (and allocates nothing) if the
        free list cannot cover the extension.
        """
        need_total = self._blocks_for(num_tokens)
        with self._lock:
            table = self._tables.get(seq_id, [])
            grow = need_total - len(table)
            if grow > len(self._free):
                used = self.num_blocks - len(self._free)
                err = CacheExhaustedError(
                    "kv cache exhausted: seq %r needs %d more block(s), "
                    "%d free of %d" % (seq_id, grow, len(self._free),
                                       self.num_blocks))
                err.kv_cache_occupancy = used / float(self.num_blocks)
                err.kv_cache_blocks_free = len(self._free)
                err.kv_cache_blocks_total = self.num_blocks
                raise err
            if grow > 0:
                fresh = [self._free.pop() for _ in range(grow)]
                self._tables[seq_id] = table + fresh
                self._lengths.setdefault(seq_id, 0)

    def free(self, seq_id):
        """Return ``seq_id``'s blocks to the pool; returns the freed block
        ids (empty for an unknown sequence)."""
        with self._lock:
            table = self._tables.pop(seq_id, None) or []
            self._lengths.pop(seq_id, None)
            if table:
                self._free.extend(reversed(table))
            return list(table)

    # -- reads -------------------------------------------------------

    def length(self, seq_id):
        return self._lengths.get(seq_id, 0)

    def sequences(self):
        with self._lock:
            return sorted(self._tables)

    def block_table(self, seq_id, max_blocks):
        """Padded ``int32[max_blocks]`` table for a decode dispatch; pad
        entries point at block 0, which decode attention never reads past
        the context length."""
        table = self._tables.get(seq_id)
        if table is None:
            raise MXNetError("unknown sequence %r" % (seq_id,))
        if len(table) > max_blocks:
            raise MXNetError(
                "sequence %r spans %d blocks > table width %d"
                % (seq_id, len(table), max_blocks))
        out = np.zeros(max_blocks, dtype=np.int32)
        out[:len(table)] = table
        return out

    # -- writes ------------------------------------------------------

    def _slots(self, seq_id, positions, what):
        """Flat pool rows (``block * block_size + offset``) of ``seq_id``'s
        ``positions``; caller holds the lock."""
        table = self._tables.get(seq_id)
        positions = np.asarray(positions, dtype=np.int64)
        if table is None or positions.size and (
                positions.min() < 0
                or positions.max() >= len(table) * self.block_size):
            raise MXNetError("%s(%r) exceeds allocation" % (what, seq_id))
        blocks = np.asarray(table, dtype=np.int64)[positions // self.block_size]
        return blocks * self.block_size + positions % self.block_size

    def _scatter(self, slots, k, v):
        """One indexed copy per pool: ``k``/``v`` ``[L, n, H, D]`` into
        flat rows ``slots``."""
        idx = torch.as_tensor(slots, dtype=torch.long).to(self.device)
        shape = (self.num_layers, self.num_blocks * self.block_size,
                 self.num_heads, self.head_dim)
        for pool, src in ((self.k_pages, k), (self.v_pages, v)):
            src = torch.as_tensor(src).to(device=self.device,
                                          dtype=pool.dtype)
            pool.view(shape).index_copy_(1, idx, src)

    def write_prefill(self, seq_id, k, v):
        """Store prompt K/V: ``k``/``v`` ``[L, T, heads, dim]`` (tensors on
        the cache's device, or arrays).  Requires a prior :meth:`allocate`
        covering ``T`` tokens."""
        num = k.shape[1]
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None or len(table) < self._blocks_for(num):
                raise MXNetError(
                    "write_prefill(%r, %d tokens) exceeds allocation"
                    % (seq_id, num))
            self._scatter(self._slots(seq_id, np.arange(num), "write_prefill"),
                          k, v)
            self._lengths[seq_id] = max(self._lengths.get(seq_id, 0), num)

    def write_token(self, seq_id, pos, k, v):
        """Store one decoded token's K/V: ``k``/``v`` ``[L, heads, dim]``."""
        self.write_tokens([seq_id], [pos], k[:, None], v[:, None])

    def write_tokens(self, seq_ids, positions, k, v):
        """Store one decode step's K/V for a batch: ``k``/``v``
        ``[L, n, heads, dim]``, row ``i`` at ``positions[i]`` of
        ``seq_ids[i]``, all in one indexed copy per pool."""
        with self._lock:
            slots = np.concatenate([
                self._slots(s, [p], "write_token")
                for s, p in zip(seq_ids, positions)])
            self._scatter(slots, k, v)
            for s, p in zip(seq_ids, positions):
                self._lengths[s] = max(self._lengths.get(s, 0), int(p) + 1)

    # -- introspection ----------------------------------------------

    def stats(self):
        with self._lock:
            used = self.num_blocks - len(self._free)
            written = sum(self._lengths.values())
            return {"blocks": self.num_blocks, "used": used,
                    "free": len(self._free),
                    "occupancy": used / float(self.num_blocks),
                    "headroom": len(self._free) / float(self.num_blocks),
                    "fragmentation": (1.0 - written
                                      / float(used * self.block_size))
                                     if used else 0.0,
                    "sequences": len(self._tables),
                    "block_size": self.block_size,
                    "pool_bytes": 2 * self.k_pages.numel()
                                  * self.k_pages.element_size()}
