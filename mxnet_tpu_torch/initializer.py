"""Initializers (the JAX package's ``initializer.py``, as far as the
trainer and ``Module.init_params`` need them).

An initializer is called on ``(InitDesc(name, attrs), array)`` and fills
the array by the name's suffix: ``*weight`` by the initializer's rule,
``*bias`` and ``*beta`` with 0, ``*gamma`` with 1, moving means with 0 and
moving variances with 1; a variable's own ``__init__`` attribute (a JSON
``[name, kwargs]``) wins over the suffix.  The array is anything with
``shape`` that takes ``arr[:] = value`` (an NDArray, a numpy array).  The
rules draw from numpy's global stream exactly as the JAX package's do, so
the same seed gives the same bits in both packages.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["InitDesc", "Initializer", "Uniform", "Xavier", "register"]


class InitDesc(str):
    """A parameter's name, with its variable's attributes, as an
    initializer is handed it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class Initializer(object):
    """Base initializer; callable on ``(InitDesc, array)``."""

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or an InitDesc")
        init = getattr(desc, "attrs", None) and desc.attrs.get("__init__")
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            arr[:] = 0.0
        elif desc.endswith("gamma"):
            arr[:] = 1.0
        elif desc.endswith(("moving_mean", "running_mean", "moving_inv_var",
                            "moving_avg")):
            arr[:] = 0.0
        elif desc.endswith(("moving_var", "running_var")):
            arr[:] = 1.0
        else:
            raise ValueError("Unknown initialization pattern for %s: the "
                             "port initializes weight/bias/gamma/beta and "
                             "moving statistics" % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")


@register
class Uniform(Initializer):
    """Weights uniform on ``[-scale, scale)``."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = np.random.uniform(-self.scale, self.scale, arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot: uniform or gaussian of scale ``sqrt(magnitude /
    factor)``, the factor the fan in, out or their mean."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = np.random.uniform(-scale, scale, arr.shape)
        elif self.rnd_type == "gaussian":
            arr[:] = np.random.normal(0, scale, arr.shape)
        else:
            raise ValueError("Unknown random type")
