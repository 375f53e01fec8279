"""Errors and dtype names shared across the port (the JAX package's
``base.py``).

The framework's one error type, which every typed serving and cache error
derives from, and the mapping between numpy dtypes (or their names) and
torch dtypes.  numpy has no bfloat16, so ``"bfloat16"`` maps by name.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "np_dtype", "numeric_types", "string_types",
           "torch_dtype"]

string_types = (str,)
numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: ``base.py:MXNetError``)."""


def torch_dtype(dtype):
    """numpy dtype, its name, ``"bfloat16"`` or a torch dtype → the torch
    dtype (``None`` → float32)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def np_dtype(dtype):
    """torch dtype → numpy dtype; bfloat16, which numpy lacks, stays the
    torch dtype."""
    if dtype == torch.bfloat16:
        return dtype
    return torch.empty(0, dtype=dtype).numpy().dtype
