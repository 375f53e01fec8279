"""Device resolution: the card unless the caller asks for the CPU.

Every entry point of the port takes a ``device`` argument.  ``None``
means the current CUDA device; when CUDA is not available that is an
error, never a quiet move to the CPU.  ``"cpu"`` must be asked for by
name (the tests do, to compare the port's plain versions with the JAX
package).
"""

from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]

def resolve_device(device=None):
    """``None`` or ``"cuda"`` → the current CUDA device; ``"cpu"`` → the
    CPU.  Raises :class:`MXNetError` when CUDA is asked for (or defaulted
    to) and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("mxnet_tpu_torch runs on 'cuda' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
