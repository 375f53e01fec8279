"""ShardedTrainer on one device (the JAX package's ``parallel/trainer.py``).

The JAX trainer traces forward, backward and the optimizer update into one
jitted step over a device mesh.  The port's step runs the same math
eagerly on one device: the graph function of :mod:`..executor`, the loss
``sum(outputs)`` differentiated by ``torch.autograd`` (a ``SoftmaxOutput``
head supplies its own cross-entropy gradient), then the update.  The
optimizer is any registered ``<name>_update`` op, as in the JAX trainer
(:func:`resolve_update_op`).  SGD with momentum is ONE launch of the
multi-tensor SGD-momentum kernel over every parameter
(``fused_sgd_mom_tree``, the JAX trainer's ``use_tree`` route); any other
op runs once per parameter, with the op's states in ``moms[name]`` (one
stored bare, several as a tuple).  An op that takes ``t`` (Adam's bias
correction) reads the step counter ``moms["__num_update__"]``, an int32
scalar on the device, so a step never waits for the host.
``skip_nonfinite`` folds the finite check of the loss and every gradient
into a device flag, so a bad batch leaves every weight, state, the counter
and the auxiliary states as they were and the host never waits for the
verdict.  Auxiliary states (BatchNorm's moving statistics) go through the
graph in training mode and come back updated.

Parameters and states are updated in place (the JAX step donates its
inputs) and returned.  Mesh sharding, ZeRO, gradient accumulation, mixed
precision, LR schedules, rematerialization and multi-step pipelining are
later slices and raise :class:`~mxnet_tpu_torch.base.MXNetError` naming
themselves.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..executor import graph_fn
from ..initializer import InitDesc, Uniform
from ..ops.fused.optimizer_kernels import (fused_sgd_mom_tree,
                                           sgd_mom_tree_stock)
from ..ops.registry import get_op
from ..symbol import infer, torch_dtype

__all__ = ["ShardedTrainer", "fused_sgd_mom_tree", "resolve_update_op",
           "sgd_mom_tree_stock", "trainer_state_from_jax"]


_STEP_COUNT = "__num_update__"  # the step counter's key in moms


def resolve_update_op(optimizer, optimizer_params, momentum, learning_rate,
                      wd, rescale_grad, clip_gradient):
    """``(update_op, attrs, n_states, needs_t)`` of an optimizer name over
    the registered update ops (the JAX package's ``resolve_update_op``):
    ``"sgd"`` is ``sgd_mom_update`` with momentum (from ``momentum=`` or
    ``optimizer_params``) and ``sgd_update`` without; any other name is
    the op ``<name>_update``."""
    opt_name = (optimizer or "sgd").lower()
    opt_kwargs = dict(optimizer_params or {})
    if opt_name == "sgd":
        if ("momentum" in opt_kwargs and momentum
                and opt_kwargs["momentum"] != momentum):
            raise MXNetError("momentum given twice (momentum=%r, "
                             "optimizer_params['momentum']=%r)"
                             % (momentum, opt_kwargs["momentum"]))
        eff_mom = opt_kwargs.pop("momentum", momentum)
        op_name = "sgd_mom_update" if eff_mom else "sgd_update"
        if eff_mom:
            opt_kwargs["momentum"] = eff_mom
    else:
        if momentum:
            raise MXNetError("momentum= is an SGD knob; pass "
                             "optimizer_params for %r" % opt_name)
        op_name = (opt_name if opt_name.endswith("_update")
                   else opt_name + "_update")
    try:
        update_op = get_op(op_name)
    except MXNetError:
        raise MXNetError("no fused update op %r for optimizer %r"
                         % (op_name, opt_name)) from None
    static = {"lr": learning_rate, "wd": wd, "rescale_grad": rescale_grad,
              "clip_gradient": (clip_gradient if clip_gradient is not None
                                else -1.0)}
    static.update(opt_kwargs)
    attrs = update_op.parse_attrs(static)
    return (update_op, attrs, update_op.n_outputs(attrs) - 1,
            "t" in update_op.params)


def _mesh_devices(mesh):
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if size is None:
        size = len(mesh) if hasattr(mesh, "__len__") else 1
    return int(size)


class ShardedTrainer:
    """A whole-model training step on one device.

    ``symbol`` is a loss-headed graph (e.g. a ``SoftmaxOutput`` net);
    ``data_shapes``/``label_shapes`` map input names to global shapes;
    ``type_dict`` gives input dtypes (``{"data": "int32"}``).  ``device``
    ``None`` means the CUDA device (an error without one); ``"cpu"`` runs
    every kernel's plain version.  ``mesh`` may be ``None`` or anything of
    one device.

    ``init(seed)`` → ``(params, moms, aux)`` (``moms`` by parameter, and
    the step counter when the op takes ``t``); ``place_batch(arrays)`` →
    the batch as tensors; ``step_fn()`` → ``step(params, moms, aux, batch,
    rng=None) -> (outputs, params, moms, aux)``.  With ``skip_nonfinite``
    the outputs end with a float flag (1.0 the update applied, 0.0
    skipped), as in the JAX trainer.
    """

    def __init__(self, symbol, mesh=None, data_shapes: Dict[str, tuple] = None,
                 label_shapes: Optional[Dict[str, tuple]] = None,
                 type_dict: Optional[Dict[str, str]] = None,
                 learning_rate=0.01, momentum=0.0, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, optimizer="sgd", optimizer_params=None,
                 skip_nonfinite=False, device=None, dtype="float32",
                 remat=False, remat_policy=None, zero_stage=0,
                 lr_scheduler=None, grad_accum=1, multi_precision=False,
                 pipeline_steps=1):
        later = {"remat": bool(remat) or remat_policy is not None,
                 "zero_stage": zero_stage != 0, "grad_accum": grad_accum != 1,
                 "multi_precision": bool(multi_precision),
                 "lr_scheduler": lr_scheduler is not None,
                 "pipeline_steps": pipeline_steps != 1,
                 "dtype": dtype != "float32"}
        for knob, given in later.items():
            if given:
                raise MXNetError("ShardedTrainer %s is not ported yet (a "
                                 "later slice)" % knob)
        if _mesh_devices(mesh) > 1:
            raise MXNetError("ShardedTrainer mesh of %d devices: the port "
                             "trains on one device (a later slice shards)"
                             % _mesh_devices(mesh))
        if not data_shapes:
            raise MXNetError("ShardedTrainer needs data_shapes")
        self.symbol = symbol
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # 16-bit projections (a bf16 graph) sum in fp32 throughout, as
            # the JAX package's do: cuBLAS may not reduce split-K partials
            # in bf16 or fp16
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = False
            torch.backends.cuda.matmul \
                .allow_fp16_reduced_precision_reduction = False
        shapes = dict(data_shapes)
        shapes.update(label_shapes or {})
        type_dict = dict(type_dict or {})
        arg_shapes, _, aux_shapes, arg_dtypes, aux_dtypes = infer(
            symbol, shapes, type_dict)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self._input_names = set(shapes)
        self.param_names = [n for n in arg_names
                            if n not in self._input_names]
        self.arg_shapes = dict(zip(arg_names, arg_shapes))
        self.aux_shapes = dict(zip(aux_names, aux_shapes))
        self.arg_dtypes = dict(zip(arg_names, arg_dtypes))
        self.aux_dtypes = dict(zip(aux_names, aux_dtypes))
        self._diff = [n for n in self.param_names
                      if not np.issubdtype(self.arg_dtypes[n], np.integer)]
        (self._update_op, self._opt_attrs, self._n_states,
         self._needs_t) = resolve_update_op(
            optimizer, optimizer_params, momentum, learning_rate, wd,
            rescale_grad, clip_gradient)
        self._use_tree = self._update_op.name == "sgd_mom_update"
        self._skip_nonfinite = bool(skip_nonfinite)
        self._run = graph_fn(symbol)
        self._step = None

    def init(self, initializer=None, seed=0):
        """``(params, moms, aux)`` dicts of tensors on the device.  The
        weights are drawn on the host from numpy's global stream seeded
        with ``seed`` (the caller's stream position is restored), exactly
        as the JAX trainer draws them."""
        initializer = initializer or Uniform(0.07)
        saved = np.random.get_state()
        np.random.seed(seed)
        try:
            params, moms, aux = {}, {}, {}
            for n in self.param_names:
                arr = np.zeros(self.arg_shapes[n], self.arg_dtypes[n])
                initializer(InitDesc(n), arr)
                params[n] = torch.from_numpy(arr).to(self.device)
                if self._n_states:
                    states = tuple(torch.zeros_like(params[n])
                                   for _ in range(self._n_states))
                    moms[n] = states[0] if self._n_states == 1 else states
            for n, shp in self.aux_shapes.items():
                fill = (np.ones if n.endswith("_var") or "moving_var" in n
                        else np.zeros)
                aux[n] = torch.from_numpy(
                    fill(shp, self.aux_dtypes[n])).to(self.device)
        finally:
            np.random.set_state(saved)
        if self._needs_t:
            moms[_STEP_COUNT] = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        return params, moms, aux

    def place_batch(self, arrays):
        """Host arrays → tensors on the device, under the same names."""
        out = {}
        for n, v in arrays.items():
            v = np.asarray(v)
            want = self.arg_shapes.get(n)
            if want is not None and tuple(v.shape) != tuple(want):
                raise MXNetError("batch %r has shape %s, the trainer was "
                                 "built for %s" % (n, v.shape, tuple(want)))
            out[n] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return out

    def step_fn(self):
        """The train step: ``(params, moms, aux, batch, rng=None) ->
        (outputs, params, moms, aux)``."""
        if self._step is None:
            self._step = self._build_step()
        return self._step

    def _build_step(self):
        run, diff = self._run, list(self._diff)
        attrs, guard = self._opt_attrs, self._skip_nonfinite
        update_op, use_tree = self._update_op, self._use_tree

        def step(params, moms, aux, batch, rng=None):
            leaves = {n: params[n].detach().requires_grad_(True)
                      for n in diff}
            args = dict(batch)
            args.update(params)
            args.update(leaves)
            outs, new_aux = run(args, aux, rng, True)
            loss = sum(o.float().sum() for o in outs)
            # a parameter no output depends on (BatchNorm's gamma under
            # fix_gamma) gets a zero gradient, as under jax.grad; the update
            # still decays it by wd
            raw = torch.autograd.grad(loss, [leaves[n] for n in diff],
                                      allow_unused=True)
            grads = {n: torch.zeros_like(leaves[n]) if g is None
                     else g.contiguous() for n, g in zip(diff, raw)}
            outs = [o.detach() for o in outs]
            new_aux = {n: t.detach() for n, t in new_aux.items()}
            ok = None
            if guard:
                flags = [torch.isfinite(loss.detach())]
                flags += [torch.isfinite(g).all() for g in grads.values()]
                ok = torch.stack(flags).all()
            with torch.no_grad():
                if use_tree:
                    fused_sgd_mom_tree(attrs, {n: params[n] for n in diff},
                                       grads, {n: moms[n] for n in diff}, ok)
                else:
                    self._update_each(params, moms, grads, ok)
                if ok is not None:
                    new_aux = {n: torch.where(ok, t, aux[n])
                               for n, t in new_aux.items()}
                    outs.append(ok.to(torch.float32))
            return outs, params, moms, new_aux

        return step

    def _update_each(self, params, moms, grads, ok):
        """The update op once per differentiated parameter, each new value
        written into its tensor (kept as it was where ``ok`` is False), the
        step counter too."""
        attrs, bare = self._opt_attrs, self._n_states == 1
        count = moms.get(_STEP_COUNT)
        if self._needs_t:
            attrs = dict(attrs, t=count + 1)
        for n in self._diff:
            states = (moms[n],) if bare else moms.get(n, ())
            news, _ = self._update_op.apply(
                attrs, [params[n], grads[n], *states])
            olds = (params[n],) + tuple(states)
            for old, new in zip(olds, news):
                old.copy_(new if ok is None else torch.where(ok, new, old))
        if self._needs_t:
            count.copy_(attrs["t"] if ok is None
                        else torch.where(ok, attrs["t"], count))


def trainer_state_from_jax(params, moms, aux, device=None):
    """The JAX trainer's ``(params, moms, aux)`` dicts (numpy arrays, or
    anything ``numpy.asarray`` takes; a state of several slots a tuple of
    them, the step counter a scalar) → the port's, same names and layout,
    as tensors on ``device`` (default: the CUDA device).  Each array is
    copied."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, tuple):
            return tuple(conv(x) for x in a)
        a = np.array(a)
        return torch.from_numpy(a).to(device=device,
                                      dtype=torch_dtype(a.dtype))

    return tuple({n: conv(a) for n, a in d.items()}
                 for d in (params, moms, aux))
