"""The SGD-momentum step: CUDA kernel wrappers and plain versions.

Counterpart of ``mxnet_tpu/ops/fused/optimizer_kernels.py``
(``fused_sgd_mom_update``) and of the trainer's whole-tree step
(``mxnet_tpu/parallel/trainer.py`` ``sgd_mom_tree_stock`` and
``fused_sgd_mom_tree``).  The kernel is in ``csrc/optimizer_kernels.cu``,
with two entries:

* :func:`fused_sgd_mom_update` -- one tensor, out of place or into given
  outputs (the registry op ``sgd_mom_update``, which the optimizer's
  ``nd.sgd_mom_update(w, g, m, out=[w, m])`` runs once per parameter),
  on a grid sized to the card (:func:`_per_op_grid`);
* :func:`fused_sgd_mom_tree` -- every parameter in ONE launch, in place,
  with the ``skip_nonfinite`` flag read on the card (the trainer's step).
  The JAX trainer donates its step's inputs; the port writes the new
  weights and momenta into the same tensors instead.

``attrs`` is the update op's attribute dict: ``lr``, ``wd``, ``momentum``,
``rescale_grad`` and ``clip_gradient`` (``<= 0`` or ``None``: no clip).
The arithmetic is the JAX spelling, each operation rounded on its own, so
kernel and plain version agree bit for bit on the card.  The one-tensor
step's first design stays in the library as ``SGD_MOM_UPDATE_V1``, for
timing in turns; no path launches it.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .._build import Kernel, device_kind, load, require

__all__ = ["SGD_MOM_MULTI", "SGD_MOM_UPDATE", "SGD_MOM_UPDATE_V1",
           "fused_sgd_mom_tree",
           "fused_sgd_mom_update", "sgd_mom_tree_stock",
           "sgd_mom_update_plain"]

_P = ctypes.c_void_p
_F = ctypes.c_float
SGD_MOM_UPDATE = Kernel(
    "sgd_mom_update", "optimizer_kernels", "mxtpu_sgd_mom_update",
    [_P] * 5 + [ctypes.c_longlong, ctypes.c_uint] + [_F] * 5)
SGD_MOM_UPDATE_V1 = Kernel(
    "sgd_mom_update_v1", "optimizer_kernels", "mxtpu_sgd_mom_update_v1",
    [_P] * 5 + [ctypes.c_longlong] + [_F] * 5)
SGD_MOM_MULTI = Kernel(
    "sgd_mom_multi", "optimizer_kernels", "mxtpu_sgd_mom_multi",
    [_P, ctypes.c_int, ctypes.c_longlong, _P] + [_F] * 5)

# Elements per chunk of the multi-tensor launch: csrc/optimizer_kernels.cu
# kChunk.
_CHUNK = 1 << 16
# Threads a block and float4 groups a thread keeps in flight in the per-op
# launch: csrc/optimizer_kernels.cu kPerOpThreads, kPerOpUnroll.
_PER_OP_THREADS = 256
_PER_OP_UNROLL = 1
_PER_OP_ELEMS = _PER_OP_THREADS * 4 * _PER_OP_UNROLL
_waves = {}


def _per_op_grid(n, sms, per_sm, elems=_PER_OP_ELEMS):
    """Blocks of one per-op launch over ``n`` elements: one per ``elems``
    (a block's elements in flight), so no block is left without work, at
    most a full wave of ``per_sm`` resident blocks on each of ``sms`` SMs
    (a grid-stride loop covers the rest); 0 for ``n`` 0."""
    return min(-(-n // elems), per_sm * sms)


def _per_op_wave(device):
    """``(SMs, resident blocks an SM)`` of the per-op kernel on ``device``,
    from the device and the occupancy API, once a device."""
    if device.index not in _waves:
        fn = load("optimizer_kernels").mxtpu_sgd_mom_update_blocks_per_sm
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(ctypes.byref(blocks))
        if rc != 0 or blocks.value < 1:
            raise MXNetError("sgd_mom_update: occupancy query failed (%d)"
                             % rc)
        _waves[device.index] = (
            torch.cuda.get_device_properties(device).multi_processor_count,
            blocks.value)
    return _waves[device.index]


def _clip(attrs):
    clip = attrs.get("clip_gradient")
    return -1.0 if clip is None else float(clip)


def _scalars(attrs):
    return (float(attrs["lr"]), float(attrs["wd"]), float(attrs["momentum"]),
            float(attrs["rescale_grad"]), _clip(attrs))


def sgd_mom_update_plain(attrs, w, g, mom):
    """``(w', m')``: ``g * rescale``, clipped to ``[-clip, clip]`` when
    ``clip > 0``, ``m' = momentum * m - lr * (g + wd * w)``, ``w' = w +
    m'`` (``ops/tensor.py`` ``_prep_grad`` + ``_sgd_mom_update``)."""
    g = g * attrs["rescale_grad"]
    clip = _clip(attrs)
    if clip > 0:
        g = torch.clamp(g, -clip, clip)
    new_mom = attrs["momentum"] * mom - attrs["lr"] * (g + attrs["wd"] * w)
    return w + new_mom, new_mom


def fused_sgd_mom_update(attrs, w, g, mom, out=None):
    """The per-op momentum step → ``(w', m')`` (the kernel for CUDA
    tensors, :func:`sgd_mom_update_plain` for CPU ones).  New tensors, or
    with ``out=(w_out, m_out)`` those, written in place; they may be ``w``
    and ``mom`` themselves (the optimizer's ``out=[weight, state]``)."""
    outs = () if out is None else tuple(out)
    if device_kind((w, g, mom) + outs) == "cpu":
        new_w, new_m = sgd_mom_update_plain(attrs, w, g, mom)
        if out is None:
            return new_w, new_m
        outs[0].copy_(new_w)
        outs[1].copy_(new_m)
        return outs
    w_out, m_out = outs or (torch.empty_like(w), torch.empty_like(mom))
    for t in (w, g, mom, w_out, m_out):
        require("sgd_mom_update", t, torch.float32, w.shape)
    grid = _per_op_grid(w.numel(), *_per_op_wave(w.device))
    if grid:
        SGD_MOM_UPDATE.launch(w.device, w.data_ptr(), g.data_ptr(),
                              mom.data_ptr(), w_out.data_ptr(),
                              m_out.data_ptr(), w.numel(), grid,
                              *_scalars(attrs))
    return w_out, m_out


def sgd_mom_tree_stock(attrs, params, grads, moms, ok=None):
    """The whole-tree step spelled per parameter: one
    :func:`sgd_mom_update_plain` each, then (when ``ok`` is given) the
    ``skip_nonfinite`` guard as separate keep-old selects.  Returns new
    ``(params, moms)`` dicts; the inputs are left as they were."""
    new_p, new_m = {}, {}
    for n in params:
        new_p[n], new_m[n] = sgd_mom_update_plain(attrs, params[n], grads[n],
                                                  moms[n])
    if ok is not None:
        new_p = {n: torch.where(ok, new_p[n], params[n]) for n in params}
        new_m = {n: torch.where(ok, new_m[n], moms[n]) for n in params}
    return new_p, new_m


def fused_sgd_mom_tree(attrs, params, grads, moms, ok=None):
    """The whole-tree momentum step IN PLACE: every ``params[n]`` and
    ``moms[n]`` gets its new value; returns ``(params, moms)``.  ``ok`` (a
    bool scalar tensor, or ``None``) keeps every old value when false.

    CUDA tensors: ONE launch of the multi-tensor kernel over a device
    table of the tensors' addresses; ``ok`` is read on the card, so the
    host never waits for it.  CPU tensors: the plain update, copied in."""
    names = list(params)
    tensors = [params[n] for n in names] + [grads[n] for n in names] \
        + [moms[n] for n in names]
    if ok is not None:
        tensors.append(ok)
    if not names:
        return params, moms
    if device_kind(tensors) == "cpu":
        new_p, new_m = sgd_mom_tree_stock(attrs, params, grads, moms, ok)
        for n in names:
            params[n].copy_(new_p[n])
            moms[n].copy_(new_m[n])
        return params, moms
    rows, chunk0 = [], 0
    for n in names:
        w, g, m = params[n], grads[n], moms[n]
        for t in (w, g, m):
            require("sgd_mom_multi", t, torch.float32, w.shape)
        rows.append((w.data_ptr(), g.data_ptr(), m.data_ptr(), w.numel(),
                     chunk0))
        chunk0 += -(-w.numel() // _CHUNK)
    dev = params[names[0]].device
    if ok is not None:
        if ok.dtype != torch.bool or ok.numel() != 1:
            raise MXNetError("sgd_mom_multi: ok must be one bool, got %s %s"
                             % (ok.dtype, tuple(ok.shape)))
    # pinned, so the copy is queued behind the backward, not waited for
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    SGD_MOM_MULTI.launch(dev, table.data_ptr(), len(rows), chunk0,
                         None if ok is None else ok.data_ptr(),
                         *_scalars(attrs))
    return params, moms
