"""Tensor ops of the port's training graphs (the JAX package's
``ops/tensor.py``, as far as the transformer's and ResNet's symbols need it).

``Embedding``, ``Reshape`` (with MXNet's special codes), ``Flatten``,
``transpose``, the broadcasting and scalar arithmetic of NDArray's
operators and ``elemwise_add`` (the ``+`` of two symbols), ``Cast`` and
the optimizer update ops ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update``.  Each
compute rule takes ``(attrs, *tensors)``; plain PyTorch, differentiable by
autograd, except ``sgd_mom_update``, which is the CUDA kernel's wrapper.
The other update ops are spelled as the JAX package's, each operation
rounded on its own; that package has no kernel for them either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .fused.optimizer_kernels import fused_sgd_mom_update
from .registry import P, register

__all__ = ["adam_rate", "infer_reshape", "prep_grad"]


def _binary(name, fn, aliases=()):
    register(name, aliases=aliases, arg_names=["lhs", "rhs"])(
        lambda attrs, lhs, rhs: fn(lhs, rhs))


def _binary_scalar(name, fn):
    # the scalar takes the tensor's dtype, as in the JAX package
    register(name, params={"scalar": P("float", 0.0, required=True)})(
        lambda attrs, x: fn(x, torch.tensor(attrs["scalar"], dtype=x.dtype,
                                            device=x.device)))


# The arithmetic of the graphs (``elemwise_add`` is the ``+`` of two
# symbols) and of NDArray's operators (``a - b``, ``a * 2``, ``-a``).
for _names, _fn in ((("elemwise_add", "_plus", "_add"), torch.add),
                    (("broadcast_add", "broadcast_plus"), torch.add),
                    (("broadcast_sub", "broadcast_minus"), torch.sub),
                    (("broadcast_mul",), torch.mul),
                    (("broadcast_div",), torch.div),
                    (("broadcast_mod",), torch.remainder),
                    (("broadcast_power",), torch.pow)):
    _binary(_names[0], _fn, aliases=_names[1:])
for _name, _fn in (("_plus_scalar", torch.add), ("_minus_scalar", torch.sub),
                   ("_rminus_scalar", lambda x, s: s - x),
                   ("_mul_scalar", torch.mul), ("_div_scalar", torch.div),
                   ("_rdiv_scalar", lambda x, s: s / x),
                   ("_power_scalar", torch.pow),
                   ("_mod_scalar", torch.remainder)):
    _binary_scalar(_name, _fn)
register("negative", aliases=["_neg"])(lambda attrs, x: -x)


def infer_reshape(shape, target):
    """MXNet Reshape special codes: 0 copy, -1 infer, -2 copy the rest,
    -3 merge two, -4 split one (reference ``matrix_op-inl.h``)."""
    src, out, t = list(shape), [], list(target)
    i = j = 0
    while j < len(t):
        d = t[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = t[j + 1], t[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=["reshape"],
          params={"shape": P("shape", None), "target_shape": P("shape", None),
                  "keep_highest": P("bool", False),
                  "reverse": P("bool", False)})
def _reshape(attrs, x):
    tgt = attrs["shape"] or attrs["target_shape"]
    return x.reshape(infer_reshape(tuple(x.shape), tgt))


@register("Flatten", aliases=["flatten"])
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


@register("transpose", params={"axes": P("shape", None)})
def _transpose(attrs, x):
    axes = attrs["axes"]
    return x.permute(*axes) if axes else x.permute(*range(x.dim() - 1, -1, -1))


# The dtypes Cast takes (names of the JAX package's base.STR_TO_DTYPE that
# the port's graphs use).
_CAST_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@register("Cast", aliases=["cast"], params={"dtype": P("str", "float32")})
def _cast(attrs, x):
    dtype = _CAST_DTYPES.get(attrs["dtype"])
    if dtype is None:
        raise MXNetError("Cast to %s is not ported (the port casts to %s)"
                         % (attrs["dtype"], sorted(_CAST_DTYPES)))
    return x.to(dtype)


@register("Embedding", arg_names=["data", "weight"],
          params={"input_dim": P("int", 0, required=True),
                  "output_dim": P("int", 0, required=True),
                  "dtype": P("str", "float32")})
def _embedding(attrs, data, weight):
    idx = torch.clamp(data.long(), 0, attrs["input_dim"] - 1)
    return F.embedding(idx, weight)


_OPT_COMMON = {"lr": P("float", 0.01, required=True), "wd": P("float", 0.0),
               "rescale_grad": P("float", 1.0),
               "clip_gradient": P("float", -1.0)}


def prep_grad(g, rescale_grad, clip_gradient):
    """``g * rescale_grad``, clipped to ``[-clip, clip]`` when clip > 0 (the
    update ops' and the optimizers' first step)."""
    g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep_grad(g, attrs):
    return prep_grad(g, attrs["rescale_grad"], attrs["clip_gradient"])


@register("sgd_update", arg_names=["weight", "grad"],
          params=dict(_OPT_COMMON))
def _sgd_update(attrs, w, g):
    g = _prep_grad(g, attrs)
    return w - attrs["lr"] * (g + attrs["wd"] * w)


@register("sgd_mom_update", arg_names=["weight", "grad", "mom"],
          num_outputs=2, writes_out=True,
          params=dict(_OPT_COMMON, momentum=P("float", 0.0)))
def _sgd_mom_update(attrs, w, g, mom, out=None):
    return fused_sgd_mom_update(attrs, w, g, mom, out)



# The last bias-corrected rate made on each device: Module's updater asks
# for the same one once a parameter, the trainer once a parameter a step.
_rates = {}


def adam_rate(lr, beta1, beta2, t, device):
    """Adam's bias-corrected rate ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``
    as a float32 scalar tensor on ``device``, every operation in float32
    there, as the JAX package computes it.  ``t`` is a Python int (the
    optimizer's update count) or an integer tensor on ``device`` (the
    trainer's step counter, read without a sync); equal values give equal
    bits either way."""
    device = torch.device(device)
    # a tensor t by identity: the entry keeps it alive, so its id is unique
    key = (float(lr), float(beta1), float(beta2),
           (id(t), t._version) if torch.is_tensor(t) else int(t))
    last = _rates.get(device)
    if last is not None and last[0] == key:
        return last[2]
    f32 = dict(dtype=torch.float32, device=device)
    tf = (t.to(torch.float32) if torch.is_tensor(t)
          else torch.full((), float(t), **f32))
    b1, b2 = torch.full((), beta1, **f32), torch.full((), beta2, **f32)
    rate = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
    _rates[device] = (key, t, rate)
    return rate


@register("adam_update", arg_names=["weight", "grad", "mean", "var"],
          num_outputs=3,
          params=dict(_OPT_COMMON, beta1=P("float", 0.9),
                      beta2=P("float", 0.999), epsilon=P("float", 1e-8),
                      t=P("int", 1)))
def _adam_update(attrs, w, g, mean, var):
    g = _prep_grad(g, attrs) + attrs["wd"] * w
    b1, b2 = attrs["beta1"], attrs["beta2"]
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    lr = adam_rate(attrs["lr"], b1, b2, attrs["t"], w.device)
    new_w = w - lr * new_mean / (torch.sqrt(new_var) + attrs["epsilon"])
    return new_w, new_mean, new_var


@register("rmsprop_update", arg_names=["weight", "grad", "n"], num_outputs=2,
          params=dict(_OPT_COMMON, gamma1=P("float", 0.95),
                      epsilon=P("float", 1e-8)))
def _rmsprop_update(attrs, w, g, n):
    g = _prep_grad(g, attrs) + attrs["wd"] * w
    g1 = attrs["gamma1"]
    new_n = g1 * n + (1 - g1) * torch.square(g)
    new_w = w - attrs["lr"] * g / torch.sqrt(new_n + attrs["epsilon"])
    return new_w, new_n


@register("rmspropalex_update", arg_names=["weight", "grad", "n", "g",
                                           "delta"],
          num_outputs=4,
          params=dict(_OPT_COMMON, gamma1=P("float", 0.95),
                      gamma2=P("float", 0.9), epsilon=P("float", 1e-8)))
def _rmspropalex_update(attrs, w, grad, n, g, delta):
    grad = _prep_grad(grad, attrs) + attrs["wd"] * w
    g1, g2 = attrs["gamma1"], attrs["gamma2"]
    new_n = g1 * n + (1 - g1) * torch.square(grad)
    new_g = g1 * g + (1 - g1) * grad
    new_delta = g2 * delta - attrs["lr"] * grad / torch.sqrt(
        new_n - torch.square(new_g) + attrs["epsilon"])
    return w + new_delta, new_n, new_g, new_delta
