"""Operators of the port: attention, the paged KV cache and the fused
kernel tier (``ops/fused``) with its CUDA build (``ops/_build.py``)."""

from . import attention, fused, kv_cache
from ._build import launch_counts, reset_launch_counts

__all__ = ["attention", "fused", "kv_cache", "launch_counts",
           "reset_launch_counts"]
