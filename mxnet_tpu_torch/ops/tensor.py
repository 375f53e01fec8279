"""Tensor ops of the port's training graphs (the JAX package's
``ops/tensor.py``, as far as the transformer's and ResNet's symbols need it).

``Embedding``, ``Reshape`` (with MXNet's special codes), ``Flatten``,
``transpose``, the broadcasting and scalar arithmetic of NDArray's
operators and ``elemwise_add`` (the ``+`` of two symbols), ``Cast`` and the optimizer update ops ``sgd_update`` and
``sgd_mom_update``.  Each compute
rule takes ``(attrs, *tensors)``; plain PyTorch, differentiable by autograd,
except ``sgd_mom_update``, which is the CUDA kernel's wrapper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .fused.optimizer_kernels import fused_sgd_mom_update
from .registry import P, register

__all__ = ["infer_reshape"]


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


@register("sgd_update", arg_names=["weight", "grad"],
          params=dict(_OPT_COMMON))
def _sgd_update(attrs, w, g):
    g = g * attrs["rescale_grad"]
    if attrs["clip_gradient"] is not None and attrs["clip_gradient"] > 0:
        g = torch.clamp(g, -attrs["clip_gradient"], attrs["clip_gradient"])
    return w - attrs["lr"] * (g + attrs["wd"] * w)


@register("sgd_mom_update", arg_names=["weight", "grad", "mom"],
          num_outputs=2, writes_out=True,
          params=dict(_OPT_COMMON, momentum=P("float", 0.0)))
def _sgd_mom_update(attrs, w, g, mom, out=None):
    return fused_sgd_mom_update(attrs, w, g, mom, out)
