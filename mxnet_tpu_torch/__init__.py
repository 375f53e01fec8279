"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module names.  It
serves the transformer LM through the autoregressive generation lane
(:mod:`.serving.generation`) and trains it, and ResNet, through Symbol →
graph function → :class:`~.parallel.ShardedTrainer` on an NVIDIA Hopper
card, with kernels written by hand in CUDA C++ (``csrc/``): flash attention
forward and backward, block-table paged decode attention, the LM layer
norm, the FFN's GELU+bias epilogue, the ``LayerNorm`` op, the SGD-momentum
step, and a tiled GEMM with three epilogues (the 1x1-conv dgrad that
``MXTPU_CONV1X1=pallas`` selects, and the two kernels of
:mod:`.tools.bottleneck_probe`).
Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version
instead.

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``mxnet_tpu``.
"""

from . import (attribute, base, context, executor, initializer, models,
               name, ops, parallel, serving, symbol)
from .base import MXNetError
from .context import resolve_device

__all__ = ["MXNetError", "attribute", "base", "context", "executor",
           "initializer", "models", "name", "ops", "parallel",
           "resolve_device", "serving", "symbol"]
