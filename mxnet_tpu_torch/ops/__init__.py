"""Operators of the port: the op registry and the ops the training graph
uses (``registry``, ``tensor``, ``nn``, ``attention``), the paged KV cache,
and the fused kernel tier (``ops/fused``) with its CUDA build
(``ops/_build.py``)."""

from . import attention, fused, kv_cache, nn, registry, tensor
from ._build import launch_counts, reset_launch_counts

__all__ = ["attention", "fused", "kv_cache", "launch_counts", "nn",
           "registry", "reset_launch_counts", "tensor"]
