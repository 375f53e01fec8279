"""Layer ops of the transformer training graph (the JAX package's
``ops/nn.py``, as far as this slice's symbols need it).

``FullyConnected`` is ``torch.matmul`` (``F.linear``): the JAX package
leaves it to XLA, outside any Pallas kernel.  ``Activation``'s ``gelu`` is
the tanh form, ``jax.nn.gelu``'s default.  ``SoftmaxOutput`` is a
``torch.autograd.Function`` whose backward ignores the incoming gradient,
as the reference's loss layers do: ``p - onehot(label)``, then
``normalization``, then ``grad_scale`` (``_softmax_output_rule``).  So
``sum(outputs).backward()`` trains a cross-entropy loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import P, register

__all__ = []


def _fc_input_names(attrs):
    return (["data", "weight"] if attrs.get("no_bias")
            else ["data", "weight", "bias"])


@register("FullyConnected", arg_names=["data", "weight", "bias"],
          input_names_fn=_fc_input_names,
          params={"num_hidden": P("int", 0, required=True),
                  "no_bias": P("bool", False), "flatten": P("bool", True)})
def _fully_connected(attrs, data, weight, bias=None):
    if attrs["flatten"] and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if attrs["no_bias"] else bias)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


@register("Activation",
          params={"act_type": P("str", "relu", enum=sorted(_ACTIVATIONS))})
def _activation(attrs, x):
    return _ACTIVATIONS[attrs["act_type"]](x)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the flattened trailing axes; the backward returns
    ``(p - onehot) [* valid] / norm * grad_scale [* head gradient]`` and
    a zero label gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, out_grad):
        p = torch.softmax(data.reshape(data.shape[0], -1), -1)
        p = p.reshape(data.shape)
        ctx.save_for_backward(p, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization,
                   out_grad)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, out_grad = ctx.cfg
        lab = label.reshape(-1).long()
        flat = p.reshape(p.shape[0], -1)
        # one [rows, classes] buffer, updated in place: at the bench's head
        # ([16384, 32000] fp32) each extra copy would be 2.1 GB.  A label
        # outside [0, classes) subtracts nothing (jax.nn.one_hot's zeros).
        inside = (lab >= 0) & (lab < flat.shape[1])
        grad = flat.clone()
        grad.scatter_add_(1, lab.clamp(0, flat.shape[1] - 1)[:, None],
                          -inside.to(p.dtype)[:, None])
        valid = None
        if use_ignore:
            valid = (lab != int(ignore_label)).to(p.dtype)
            grad.mul_(valid[:, None])
        if normalization == "batch":
            grad.div_(p.shape[0])
        elif normalization == "valid":
            n_valid = (valid.sum() if valid is not None
                       else torch.tensor(float(p.shape[0]), device=p.device))
            grad.div_(torch.clamp(n_valid, min=1.0))
        if grad_scale != 1.0:
            grad.mul_(grad_scale)
        grad = grad.reshape(p.shape)
        if out_grad:
            grad.mul_(g)
        return (grad, torch.zeros_like(label), None, None, None, None, None)


@register("SoftmaxOutput", aliases=["Softmax"], arg_names=["data", "label"],
          params={"grad_scale": P("float", 1.0),
                  "ignore_label": P("float", -1.0),
                  "multi_output": P("bool", False),
                  "use_ignore": P("bool", False),
                  "preserve_shape": P("bool", False),
                  "normalization": P("str", "null",
                                     enum=["null", "batch", "valid"]),
                  "out_grad": P("bool", False),
                  "smooth_alpha": P("float", 0.0)})
def _softmax_output(attrs, data, label):
    if attrs["multi_output"] or attrs["preserve_shape"]:
        raise MXNetError("SoftmaxOutput: multi_output and preserve_shape "
                         "are not ported yet")
    label = label.to(data.dtype)
    if data.is_meta:
        return torch.empty_like(data)
    return _SoftmaxOutput.apply(
        data, label, attrs["grad_scale"], attrs["ignore_label"],
        attrs["use_ignore"], attrs["normalization"], attrs["out_grad"])
