"""Checkpoints, ``BatchEndParam`` and the per-parameter update loop (the
JAX package's ``model.py``).

A checkpoint is the JAX package's pair of files: ``prefix-symbol.json``
(the graph JSON) and ``prefix-%04d.params`` (an npz of ``arg:name`` /
``aux:name`` arrays, written atomically), so a checkpoint of either
package loads in the other.  The port writes it on the calling thread;
the JAX package writes it on its engine's IO lane.

On one device with ``kvstore`` ``"local"`` (or ``"device"``, or None) the
store is ``None`` and ``Module.update`` calls the updater once per
parameter, as the JAX package does; any other store is a later slice, and
so is the store's side of the update (``_initialize_kvstore``, push and
pull).
``FeedForward`` is a later slice too.
"""

from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["BatchEndParam", "load_checkpoint", "save_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    arrays = {("arg:%s" % k): v.asnumpy() for k, v in arg_params.items()}
    arrays.update({("aux:%s" % k): v.asnumpy()
                   for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd._save_npz(param_name, arrays, "dict")
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)``, the arrays on ``ctx`` (the
    current context by default)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for one device
    and a local store; anything else raises."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and kvstore in ("local", "device")):
        return None, False
    raise MXNetError("kvstore %r on %d device(s) is not ported yet (a "
                     "later slice): train on one device with kvstore="
                     "'local'" % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device):
    """The updater once per parameter (and device), in order."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)
