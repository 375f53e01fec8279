"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module names.  This
slice serves the transformer LM through the autoregressive generation
lane (:mod:`.serving.generation`) on an NVIDIA Hopper card, with four
kernels written by hand in CUDA C++ (``csrc/``): flash prefill attention,
block-table paged decode attention, the LM layer norm and the FFN's
GELU+bias epilogue.  Entry points run on the card unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``mxnet_tpu``.
"""

from . import base, context, models, ops, serving
from .base import MXNetError
from .context import resolve_device

__all__ = ["MXNetError", "base", "context", "models", "ops",
           "resolve_device", "serving"]
