"""Module package (the JAX package's ``module/``): ``BaseModule`` and
``Module`` on one context.  ``BucketingModule``, ``SequentialModule`` and
``PythonModule`` are a later slice."""

from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
