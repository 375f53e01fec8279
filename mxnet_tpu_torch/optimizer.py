"""Optimizers (the JAX package's ``optimizer.py``: its base class, SGD and
the updater).

``SGD.update`` runs the registered update ops on NDArrays, writing into
the weight's and the momentum's own storage: ``nd.sgd_mom_update(w, g, m,
out=[w, m])``, one launch of the per-op SGD-momentum kernel a parameter on
the card, or ``nd.sgd_update`` without momentum.  ``get_updater`` is the
closure ``Module.update`` calls once per parameter.  The JAX package's
other optimizers run ops that the port's registry lacks (``adam_update``
...): creating one raises, naming the op.
"""

from __future__ import annotations

import pickle
import threading

from . import ndarray as nd
from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Updater", "create", "get_updater",
           "register"]

# The JAX package's other optimizers and the update math each needs.
_NOT_PORTED = {"adam": "the op adam_update", "rmsprop": "the op "
               "rmsprop_update", "nag": "its Nesterov update",
               "sgld": "its Langevin noise", "ccsgd": "its update",
               "adagrad": "its update", "adadelta": "its update",
               "ftrl": "its update", "dcasgd": "its update",
               "test": "its update"}


class Optimizer(object):
    """Base optimizer: the registry, learning rate and weight decay with
    per-parameter multipliers (``__lr_mult__``/``__wd_mult__`` attributes
    or ``set_lr_mult``/``set_wd_mult``) and the update counts an
    ``lr_scheduler`` reads."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key in Optimizer.opt_registry:
            return Optimizer.opt_registry[key](**kwargs)
        if key in _NOT_PORTED:
            raise MXNetError("optimizer %r needs %s, which mxnet_tpu_torch "
                             "does not have yet (it trains with 'sgd')"
                             % (name, _NOT_PORTED[key]))
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self._count_lock = threading.Lock()
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                if name in attrs:
                    if "__lr_mult__" in attrs[name]:
                        self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
                    if "__wd_mult__" in attrs[name]:
                        self.wd_mult[name] = float(attrs[name]["__wd_mult__"])

    def create_state(self, index, weight):
        raise NotImplementedError()

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_count_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._count_lock = threading.Lock()

    def _update_count(self, index):
        with self._count_lock:
            if index not in self._index_update_count:
                self._index_update_count[index] = self.begin_num_update
            self._index_update_count[index] += 1
            self.num_update = max(self._index_update_count[index],
                                  self.num_update)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              is not None else self.lr)
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum, through the registered ``sgd_mom_update`` (the
    per-op kernel on the card) or, with momentum 0, ``sgd_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.NDArray(weight._data.new_zeros(weight.shape))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient or -1.0)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=[weight, state],
                              momentum=self.momentum, **kwargs)
        else:
            nd.sgd_update(weight, grad, out=weight, **kwargs)


def create(name, rescale_grad=1.0, **kwargs):
    """An optimizer by name (or the given one)."""
    if isinstance(name, Optimizer):
        return name
    return Optimizer.create_optimizer(name, rescale_grad=rescale_grad,
                                      **kwargs)


class Updater(object):
    """``updater(index, grad, weight)``: the optimizer's step with a state
    per index, made at the index's first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        self.states = pickle.loads(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
