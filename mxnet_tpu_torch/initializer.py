"""Initializers (the JAX package's ``initializer.py``, as far as the
trainer needs them).

An initializer is called on ``(InitDesc(name), array)`` and fills the
array by the name's suffix: ``*weight`` by the initializer's rule, ``*bias``
and ``*beta`` with 0, ``*gamma`` with 1.  The rules draw from numpy's
global stream exactly as the JAX package's do, so the same seed gives the
same bits in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["InitDesc", "Initializer", "Uniform"]


class InitDesc(str):
    """A parameter's name, as an initializer is handed it."""


class Initializer(object):
    """Base initializer; callable on ``(InitDesc, array)``, where the array
    supports ``shape`` and ``arr[:] = value`` (a numpy array does)."""

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or an InitDesc")
        if desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            arr[:] = 0.0
        elif desc.endswith("gamma"):
            arr[:] = 1.0
        else:
            raise ValueError("Unknown initialization pattern for %s: the "
                             "port initializes weight/bias/gamma/beta" % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")


class Uniform(Initializer):
    """Weights uniform on ``[-scale, scale)``."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = np.random.uniform(-self.scale, self.scale, arr.shape)
