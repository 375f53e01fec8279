"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module names, used
the same way (``import mxnet_tpu_torch as mx``: ``mx.nd``, ``mx.sym``,
``mx.mod.Module``, ``mx.io.NDArrayIter``, ``mx.gpu()``).  It serves the
transformer LM through the autoregressive generation lane
(:mod:`.serving.generation`) and trains it, and ResNet, through Symbol →
graph function → :class:`~.parallel.ShardedTrainer`, or through
``Module.fit`` over NDArrays and an Executor, on an NVIDIA Hopper card,
with kernels written by hand in CUDA C++ (``csrc/``): flash attention
forward and backward, block-table paged decode attention, the LM layer
norm, the FFN's GELU+bias epilogue, the ``LayerNorm`` op, the SGD-momentum
step, and a tiled GEMM with three epilogues (the 1x1-conv dgrad that
``MXTPU_CONV1X1=pallas`` selects, and the two kernels of
:mod:`.tools.bottleneck_probe`).  The other optimizers' updates are plain
PyTorch: the JAX package has no kernel for them either.
Entry points run on the card unless the caller passes ``device="cpu"``
(or a ``cpu()`` context: ``mx.tpu()`` and ``mx.gpu()`` both name the
card); on CPU tensors every kernel wrapper runs its plain PyTorch version
instead.

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``mxnet_tpu``.
"""

from . import (attribute, base, callback, context, executor, initializer,
               io, lr_scheduler, metric, model, models, name, ndarray, ops,
               optimizer, parallel, random, serving, symbol)
from . import module
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import (Context, cpu, current_context, gpu, resolve_device,
                      tpu)

__all__ = ["Context", "MXNetError", "attribute", "base", "callback", "context",
           "cpu", "current_context", "executor", "gpu", "initializer", "io",
           "lr_scheduler", "metric", "mod", "model", "models", "module",
           "name", "nd", "ndarray", "ops", "optimizer", "parallel", "random",
           "resolve_device", "serving", "sym", "symbol", "tpu"]
