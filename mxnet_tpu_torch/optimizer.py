"""Optimizers (the JAX package's ``optimizer.py``: SGD, NAG, SGLD, ccSGD,
Adam, AdaGrad, RMSProp, AdaDelta, Ftrl, DCASGD and Test, and the updater).

Each ``update`` writes into the weight's and its states' own storage.
``SGD`` runs ``nd.sgd_mom_update(w, g, m, out=[w, m])``, one launch of the
per-op SGD-momentum kernel a parameter on the card, or ``nd.sgd_update``
without momentum; ``Adam`` runs ``nd.adam_update`` and ``RMSProp``
``nd.rmsprop_update`` (``centered``: ``nd.rmspropalex_update``), the
registered ops the trainer runs too.  The others are written here in
PyTorch as the JAX package writes them in jnp; ``SGLD`` draws its noise
from :mod:`.random`.  States are NDArrays on the weight's device, or tuples
of them.  ``get_updater`` is the closure ``Module.update`` calls once per
parameter.
"""

from __future__ import annotations

import math
import pickle
import threading

import torch

from . import ndarray as nd
from . import random as _random
from .ops.tensor import prep_grad

__all__ = ["AdaDelta", "AdaGrad", "Adam", "DCASGD", "Ftrl", "NAG",
           "Optimizer", "RMSProp", "SGD", "SGLD", "Test", "Updater",
           "ccSGD", "create", "get_updater", "register"]


def _zeros_like(weight):
    """A state array of the weight's shape, dtype and device."""
    return nd.NDArray(torch.zeros_like(weight._data))


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
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
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
        return _zeros_like(weight)

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


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        w = weight._data
        if state is not None:
            mom = state._data * self.momentum
            gfull = g + wd * w
            mom = mom + gfull
            g2 = gfull + self.momentum * mom
            state._write(mom)
            weight._write(w - lr * g2)
        else:
            weight._write(w - lr * (g + wd * w))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: the noise is drawn from the
    weight device's generator (:mod:`.random`)."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        w = weight._data
        noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                            generator=_random.generator(w.device)) \
            * math.sqrt(lr)
        weight._write(w - lr / 2 * (g + wd * w) + noise)


@register
class ccSGD(SGD):
    """Same as SGD."""


@register
class Adam(Optimizer):
    """Adam, through the registered ``adam_update``; ``t`` is the
    parameter's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        nd.adam_update(weight, grad, mean, var, out=[weight, mean, var],
                       lr=lr, wd=wd, beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, t=t,
                       rescale_grad=self.rescale_grad,
                       clip_gradient=self.clip_gradient or -1.0)


@register
class AdaGrad(Optimizer):
    """AdaGrad."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        w = weight._data
        hist = state._data + torch.square(g)
        state._write(hist)
        weight._write(w - lr * (g / torch.sqrt(hist + self.float_stable_eps)
                                + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp through ``rmsprop_update``; ``centered=True`` is Alex
    Graves's variant, through ``rmspropalex_update``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient or -1.0,
                      gamma1=self.gamma1, epsilon=self.epsilon)
        if not self.centered:
            (n,) = state
            nd.rmsprop_update(weight, grad, n, out=[weight, n], **kwargs)
        else:
            n, g, delta = state
            nd.rmspropalex_update(weight, grad, n, g, delta,
                                  out=[weight, n, g, delta],
                                  gamma2=self.gamma2, **kwargs)


@register
class AdaDelta(Optimizer):
    """AdaDelta."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        acc_g, acc_delta = state
        new_acc_g = self.rho * acc_g._data + (1.0 - self.rho) * torch.square(g)
        delta = (torch.sqrt(acc_delta._data + self.epsilon)
                 / torch.sqrt(new_acc_g + self.epsilon) * g)
        new_acc_delta = (self.rho * acc_delta._data
                         + (1.0 - self.rho) * torch.square(delta))
        acc_g._write(new_acc_g)
        acc_delta._write(new_acc_delta)
        weight._write(weight._data - delta - wd * weight._data)


@register
class Ftrl(Optimizer):
    """FTRL."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        z, n = state
        sigma = (torch.sqrt(n._data + torch.square(g))
                 - torch.sqrt(n._data)) / lr
        new_z = z._data + g - sigma * weight._data
        new_n = n._data + torch.square(g)
        z._write(new_z)
        n._write(new_n)
        weight._write(torch.where(
            torch.abs(new_z) <= self.lamda1, torch.zeros_like(new_z),
            (torch.sign(new_z) * self.lamda1 - new_z)
            / ((self.beta + torch.sqrt(new_n)) / lr + wd)))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = prep_grad(grad._data, self.rescale_grad, self.clip_gradient)
        mon, previous_weight = state
        w = weight._data
        delta = -lr * (g + wd * w
                       + self.lamda * g * g * (w - previous_weight._data))
        if mon is not None:
            delta = self.momentum * mon._data + delta
            mon._write(delta)
        previous_weight._write(w)
        weight._write(w + delta)


@register
class Test(Optimizer):
    """``w += rescale_grad * grad``; the state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight._write(weight._data + grad._data * self.rescale_grad)
        state._write(weight._data)


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
