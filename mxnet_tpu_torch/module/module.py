"""Module: the intermediate-level trainer over one Symbol (the JAX
package's ``module/module.py``), on one context.

``bind`` makes one :class:`~..executor.Executor` (``simple_bind``) on the
context; ``init_params`` copies the initial weights into its arrays;
``init_optimizer`` makes the optimizer with ``rescale_grad = 1 / batch``
and its updater (any optimizer of :mod:`..optimizer`, by name or given);
``update`` calls the updater once per parameter, so an SGD-momentum step
is one launch of the per-op kernel a parameter.  The optimizer's states,
tuples of arrays for Adam and its like, are saved and loaded whole
(``save_optimizer_states``, ``Module.load(..., load_optimizer_states=
True)``).

The context defaults to the current one: the card unless ``with
mx.cpu():`` is in force (an error without CUDA), where the JAX package
defaults to ``cpu()``.  Several contexts (data parallelism,
``work_load_list``), ``group2ctx`` placement, ``shared_module``, kvstores
other than one device's ``"local"`` and monitors are later slices and
raise.
"""

from __future__ import annotations

import logging

import numpy as _np

from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _update_params, load_checkpoint,
                     save_checkpoint)
from ..ndarray import NDArray, zeros
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


class Module(BaseModule):
    """Module over a Symbol on one context."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 group2ctx=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        context = [c if c is not None else current_context()
                   for c in context]
        if len(context) != 1:
            raise MXNetError("Module over %d contexts (%s): data "
                             "parallelism is not ported yet (a later "
                             "slice); give one context" % (len(context),
                                                           context))
        if group2ctx:
            raise MXNetError("group2ctx placement is not ported yet (a "
                             "later slice)")
        if work_load_list is not None:
            raise MXNetError("work_load_list splits a batch over several "
                             "contexts: not ported yet (a later slice)")
        context[0].torch_device     # raises for the card without CUDA
        self._context = context

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None

        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes_memo = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol and parameters."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._output_shapes_memo is None:
            shape_dict = {d.name: d.shape for d in self._data_shapes}
            shape_dict.update({l.name: l.shape for l in self._label_shapes})
            _, out_shapes, _ = self._symbol.infer_shape_partial(**shape_dict)
            self._output_shapes_memo = list(zip(self._output_names,
                                                out_shapes))
        return self._output_shapes_memo

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the parameters from ``arg_params``/``aux_params`` where
        given, else from ``initializer`` (in name order, drawing from
        numpy as the JAX package does), and copy them to the executor."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {
                name: zeros(arr.shape, ctx, dtype=arr._data.dtype)
                for name, arr in self._exec.arg_dict.items()
                if name in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                name: zeros(arr.shape, ctx, dtype=arr._data.dtype)
                for name, arr in self._exec.aux_dict.items()}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    arr[:] = cache[name]
                return
            if cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name, None)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec.copy_params_from(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            return
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=True)
        self.params_initialized = True
        # only the executor's arrays hold them: the module's are stale
        self._params_dirty = True

    def _sync_params_from_devices(self):
        """Copy the executor's parameters into the module's arrays (a
        snapshot: later updates do not reach it)."""
        if self._exec is None:
            return
        if self._arg_params is not None:
            for name in self._param_names:
                if name in self._exec.arg_dict and name in self._arg_params:
                    self._arg_params[name][:] = self._exec.arg_dict[name]
        if self._aux_params is not None:
            for name, arr in self._exec.aux_dict.items():
                if name in self._aux_params:
                    self._aux_params[name][:] = arr
        self._params_dirty = False

    # ------------------------------------------------------------------
    # bind
    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind one executor on the context for these input shapes."""
        if shared_module is not None:
            raise MXNetError("shared_module is not ported yet (with "
                             "BucketingModule, a later slice)")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._bound_grad_req = grad_req
        self.binded = True

        def _norm(shapes):
            return [s if isinstance(s, DataDesc) else
                    DataDesc(s[0], tuple(s[1])) for s in shapes or []]

        self._data_shapes = _norm(data_shapes)
        self._label_shapes = _norm(label_shapes) if label_shapes else []
        descs = self._data_shapes + self._label_shapes
        shape_dict = {d.name: d.shape for d in descs}
        type_dict = {d.name: str(_np.dtype(d.dtype)) for d in descs}
        req = {}
        for name in self._symbol.list_arguments():
            if (name in self._param_names
                    and name not in self._fixed_param_names):
                req[name] = grad_req if for_training else "null"
            elif name in self._data_names:
                req[name] = grad_req if inputs_need_grad else "null"
            else:
                req[name] = "null"
        self._exec = self._symbol.simple_bind(
            self._context[0], grad_req=req, type_dict=type_dict,
            **shape_dict)

    def _reset_bind(self):
        self.binded = False
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes_memo = None

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind to new input shapes, keeping parameters and
        optimizer."""
        assert self.binded
        params = self.get_params() if self.params_initialized else None
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True,
                  grad_req=self._bound_grad_req)
        if params is not None:
            self.set_params(*params)

    # ------------------------------------------------------------------
    # optimizer
    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (by name: ``rescale_grad`` defaults to one over
        the batch size) and its updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        _create_kvstore(kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._data_shapes[0].shape[0]
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _param_arrays(self):
        return [[self._exec.arg_dict[n]] for n in self._param_names]

    def _grad_arrays(self):
        return [[self._exec.grad_dict.get(n)] for n in self._param_names]

    # ------------------------------------------------------------------
    # computation
    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch)
        self._exec.forward(is_train=is_train)

    def _load_batch(self, data_batch):
        """Copy the batch into the executor's input arrays."""
        arrays = list(data_batch.data or [])
        names = list(self._data_names)
        labels = list(data_batch.label or [])
        if self.for_training or labels:
            names = names + list(self._label_names)
            arrays = arrays + labels
        for name, arr in zip(names, arrays):
            if name not in self._exec.arg_dict:
                continue
            tgt = self._exec.arg_dict[name]
            if isinstance(arr, NDArray) and arr.shape != tgt.shape:
                raise MXNetError(
                    "shape mismatch for %r: batch %s vs bound %s (use "
                    "force_rebind or reshape for other shapes)"
                    % (name, arr.shape, tgt.shape))
            tgt[:] = arr

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """The optimizer's step, once per parameter."""
        assert (self.binded and self.params_initialized
                and self.optimizer_initialized)
        self._params_dirty = True
        _update_params(self._param_arrays(), self._grad_arrays(),
                       updater=self._updater, num_device=1)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert (self.binded and self.params_initialized
                and self.inputs_need_grad)
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        outputs = self.get_outputs()
        if (not getattr(eval_metric, "takes_all_outputs", False)
                and len(labels) and len(outputs) > len(labels)):
            outputs = outputs[:len(labels)]
        eval_metric.update(labels, outputs)

    # ------------------------------------------------------------------
    # optimizer states
    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def install_monitor(self, mon):
        raise MXNetError("monitors are not ported yet (a later slice)")
