"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper takes its plain PyTorch version for a CPU tensor and, for a
CUDA tensor, launches its kernel or raises: there is no fallback from a
failed build or launch to the plain version.
"""

from . import attention_kernels, conv_kernels, norm_kernels, optimizer_kernels

__all__ = ["attention_kernels", "conv_kernels", "norm_kernels",
           "optimizer_kernels"]
