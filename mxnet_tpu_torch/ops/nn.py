"""Layer ops of the port's training graphs (the JAX package's ``ops/nn.py``,
as far as the transformer's and ResNet's symbols need it).

``FullyConnected`` is ``torch.matmul`` (``F.linear``): the JAX package
leaves it to XLA, outside any Pallas kernel.  ``Convolution`` is cuDNN
(``F.conv2d``), except the 1x1 stride-1 NHWC convolutions that
``MXTPU_CONV1X1`` selects, whose backward is the JAX package's hand-rolled
one (:class:`_Conv1x1NHWC`): in ``pallas`` mode its dgrad is the CUDA kernel
of ``ops/fused/conv_kernels.py``.  ``Pooling``, ``Pad`` and ``BatchNorm``
spell the JAX ops' arithmetic (asymmetric pooling pads, the full-kernel
average, BatchNorm's shifted single-pass statistics) in plain PyTorch.
``Activation``'s ``gelu`` is the tanh form, ``jax.nn.gelu``'s default.
``SoftmaxOutput`` is a ``torch.autograd.Function`` whose backward ignores
the incoming gradient, as the reference's loss layers do: ``p -
onehot(label)``, then ``normalization``, then ``grad_scale``
(``_softmax_output_rule``).  So ``sum(outputs).backward()`` trains a
cross-entropy loss.

Every op keeps the JAX op's dtypes: weights are cast to the data's dtype
at use (fp32 masters under a bf16 graph), fp16 computes in fp32, and
BatchNorm's statistics are fp32 whatever the data's dtype.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .fused.conv_kernels import conv1x1_dgrad
from .registry import P, register

__all__ = ["relayout_copies", "reset_relayout_copies"]


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
    dtype = data.dtype
    weight = weight.to(dtype)
    bias = None if attrs["no_bias"] else bias.to(dtype)
    if dtype == torch.float16:   # as the JAX op: fp16 computes in fp32
        return F.linear(data.float(), weight.float(),
                        None if bias is None else bias.float()).to(dtype)
    return F.linear(data, weight, bias)


# ----------------------------------------------------------------------
# Convolution
# ----------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}

# Copies made to bring a tensor of the NHWC path into row-major NHWC order
# ("out": a conv's or pool's output; "dy", "x": the 1x1 backward's
# operands).  Each is a relayout the profile would show as a copy kernel;
# the ResNet drive reads these counts.
relayout_copies = {"out": 0, "dy": 0, "x": 0}


def reset_relayout_copies():
    for k in relayout_copies:
        relayout_copies[k] = 0


def _dense(t, what):
    """``t`` itself when it is row-major already, else a counted copy (not
    counted for shape inference's ``meta`` tensors, which hold no data)."""
    if t.is_contiguous() or t.is_meta:
        return t.contiguous()
    relayout_copies[what] += 1
    return t.contiguous()


def _conv1x1_pick_bm(M):
    """The JAX kernel's row block (``nn.py`` ``_conv1x1_pick_bm``): ``None``
    when no block of 4096..128 rows divides ``M``, and then the dgrad is
    the plain product in ``pallas`` mode too, as in the JAX package."""
    for bm in (4096, 2048, 1024, 512, 256, 128):
        if M % bm == 0:
            return bm
    return None


class _Conv1x1NHWC(torch.autograd.Function):
    """1x1 stride-1 NHWC conv with the JAX package's hand-rolled backward
    (``nn.py`` ``_conv1x1_nhwc``).  Forward: cuDNN on channels-last views
    (no copy).  Backward: the wgrad as one product contracting ``M = B*H*W``
    (``torch.matmul``, as the JAX package leaves it to XLA), the dgrad as
    ``torch.matmul`` (``dot``) or the CUDA kernel (``pallas``).  ``mode``
    is the ``MXTPU_CONV1X1`` value the forward call read; its backward
    uses the same one.  The JAX package reads the variable when the step
    is traced."""

    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2))
        return _dense(out.permute(0, 2, 3, 1), "out")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        mode = ctx.mode
        if mode not in ("dot", "pallas"):
            raise MXNetError(
                "MXTPU_CONV1X1=%r is not a backward mode (valid: 'default' "
                "or unset = the stock conv, 'dot', 'pallas'); refusing to "
                "guess — a silent fallback would mislabel a benchmark" % mode)
        b, h, w_, i = x.shape
        o = w.shape[0]
        m = b * h * w_
        wio = w.reshape(o, i)
        dy2 = _dense(dy, "dy").reshape(m, o)
        x2 = _dense(x, "x").reshape(m, i)
        dw = torch.matmul(dy2.t(), x2).to(w.dtype).reshape(w.shape)
        if mode == "pallas" and _conv1x1_pick_bm(m) is not None:
            dx = conv1x1_dgrad(dy2, wio, x.dtype)
        else:
            dx = torch.matmul(dy2, wio).to(x.dtype)
        return dx.reshape(x.shape), dw, None


def _conv1x1_eligible(attrs, out_dtype, nd, stride, dilate, pad, nhwc,
                      mode):
    """The JAX rule (``nn.py`` ``_conv1x1_eligible``) for the
    ``MXTPU_CONV1X1`` value ``mode``."""
    if mode in ("", "default"):
        return False
    return (nhwc and nd == 2 and tuple(attrs["kernel"]) == (1, 1)
            and tuple(stride) == (1, 1) and tuple(dilate) == (1, 1)
            and tuple(pad) == (0, 0) and attrs["num_group"] == 1
            and out_dtype in (torch.bfloat16, torch.float32))


@register("Convolution", aliases=["Convolution_v1"],
          arg_names=["data", "weight", "bias"],
          input_names_fn=_fc_input_names,
          params={"kernel": P("shape", None, required=True),
                  "stride": P("shape", None), "dilate": P("shape", None),
                  "pad": P("shape", None),
                  "num_filter": P("int", 0, required=True),
                  "num_group": P("int", 1), "workspace": P("int", 1024),
                  "no_bias": P("bool", False), "cudnn_tune": P("str", None),
                  "cudnn_off": P("bool", False),
                  "layout": P("str", None,
                              enum=["NCHW", "NCW", "NCDHW", "NHWC"])})
def _convolution(attrs, data, weight, bias=None):
    """NC[D]HW activations with OI[D]HW weights, or NHWC with OHWI; NHWC
    runs cuDNN on channels-last views of both (``permute``, no copy)."""
    nd = len(attrs["kernel"])
    stride = attrs["stride"] or (1,) * nd
    dilate = attrs["dilate"] or (1,) * nd
    pad = attrs["pad"] or (0,) * nd
    nhwc = attrs.get("layout") == "NHWC" and nd == 2
    out_dtype = data.dtype
    weight = weight.to(out_dtype)
    if out_dtype == torch.float16:
        data, weight = data.float(), weight.float()
    mode = os.environ.get("MXTPU_CONV1X1", "")   # read at each call
    if _conv1x1_eligible(attrs, out_dtype, nd, stride, dilate, pad, nhwc,
                         mode):
        out = _Conv1x1NHWC.apply(data, weight, mode).to(out_dtype)
    elif nhwc:
        out = F.conv2d(data.permute(0, 3, 1, 2), weight.permute(0, 3, 1, 2),
                       None, stride, pad, dilate, attrs["num_group"])
        out = _dense(out.permute(0, 2, 3, 1), "out").to(out_dtype)
    else:
        out = _CONV[nd](data, weight, None, stride, pad, dilate,
                        attrs["num_group"]).to(out_dtype)
    if not attrs["no_bias"]:
        bias = bias.to(out_dtype)
        out = out + (bias if nhwc else bias.reshape((1, -1) + (1,) * nd))
    return out


# ----------------------------------------------------------------------
# Pooling, Pad
# ----------------------------------------------------------------------

_POOL = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}


@register("Pooling", aliases=["Pooling_v1"],
          params={"kernel": P("shape", None, required=True),
                  "pool_type": P("str", "max", enum=["max", "avg", "sum"]),
                  "global_pool": P("bool", False),
                  "pooling_convention": P("str", "valid",
                                          enum=["valid", "full"]),
                  "stride": P("shape", None), "pad": P("shape", None),
                  "cudnn_off": P("bool", False),
                  "layout": P("str", None,
                              enum=["NCHW", "NCW", "NCDHW", "NHWC"])})
def _pooling(attrs, data):
    """The JAX op's windows: spatial dim ``x`` gets ``p`` in front and
    ``max((out - 1) * s + k - x - p, p)`` behind (``out`` by the ``valid``
    or ``full`` convention), padded explicitly with -inf (max) or 0, then an
    unpadded pool; ``avg`` divides the window sum by the whole kernel
    volume, padding included."""
    nd = data.dim() - 2
    nhwc = attrs.get("layout") == "NHWC" and nd == 2
    spatial0 = 1 if nhwc else 2
    pt = attrs["pool_type"]
    if attrs["global_pool"]:
        axes = tuple(range(spatial0, spatial0 + nd))
        if pt == "max":
            return data.amax(dim=axes, keepdim=True)
        if pt == "sum":
            return data.sum(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"] or (1,) * nd)
    pad = tuple(attrs["pad"] or (0,) * nd)
    pads = []
    for i in range(nd):
        x, k, s, p = data.shape[spatial0 + i], kernel[i], stride[i], pad[i]
        if attrs["pooling_convention"] == "full":
            out_sz = int(math.ceil((x + 2 * p - k) / s)) + 1
        else:
            out_sz = (x + 2 * p - k) // s + 1
        pads.append((p, max((out_sz - 1) * s + k - x - p, p)))
    x = data.permute(0, 3, 1, 2) if nhwc else data
    if nd == 1:   # as a 2-D pool over a unit height
        x, kernel, stride, pads = (x.unsqueeze(2), (1,) + kernel,
                                   (1,) + stride, [(0, 0)] + pads)
    flat = [v for pair in reversed(pads) for v in pair]
    if any(flat):
        fill = -math.inf if pt == "max" else 0.0
        x = F.pad(x, flat, value=fill)
    max_pool, avg_pool = _POOL[len(kernel)]
    if pt == "max":
        out = max_pool(x, kernel, stride)
    else:
        out = avg_pool(x, kernel, stride, divisor_override=1)   # the sum
        if pt == "avg":
            out = out / math.prod(kernel)
    if nd == 1:
        out = out.squeeze(2)
    return _dense(out.permute(0, 2, 3, 1), "out") if nhwc else out


@register("Pad", aliases=["pad"],
          params={"mode": P("str", "constant",
                            enum=["constant", "edge", "reflect"]),
                  "pad_width": P("shape", None, required=True),
                  "constant_value": P("float", 0.0)})
def _pad(attrs, x):
    """``pad_width`` holds (before, after) pairs from the first axis on;
    ``edge`` and ``reflect`` pad trailing axes only (torch's rule)."""
    pw = attrs["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if attrs["mode"] == "constant":
        flat = [v for pair in reversed(pairs) for v in pair]
        return F.pad(x, flat, value=attrs["constant_value"])
    while pairs and pairs[0] == (0, 0):
        pairs = pairs[1:]
    flat = [v for pair in reversed(pairs) for v in pair]
    return F.pad(x, flat,
                 mode="replicate" if attrs["mode"] == "edge" else "reflect")


# ----------------------------------------------------------------------
# BatchNorm
# ----------------------------------------------------------------------


@register("BatchNorm", arg_names=["data", "gamma", "beta"],
          aux_names=["moving_mean", "moving_var"],
          params={"eps": P("float", 1e-3), "momentum": P("float", 0.9),
                  "fix_gamma": P("bool", True),
                  "use_global_stats": P("bool", False),
                  "output_mean_var": P("bool", False),
                  "cudnn_off": P("bool", False), "axis": P("int", 1)},
          needs_mode=True)
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var,
                is_train=False):
    """The JAX op's formula (``nn.py`` ``_batch_norm``), not
    ``F.batch_norm`` (whose running variance is unbiased).  Training:
    shifted single-pass statistics in fp32 with the shift ``s`` the moving
    mean (detached): ``mean = s + E[x-s]``, ``var = max(E[(x-s)^2] -
    E[x-s]^2, 0)``; the moving stats take the biased ``var``.  The
    normalisation runs in the data's dtype.  Returns ``(out, new moving
    mean, new moving var)``."""
    eps, mom = attrs["eps"], attrs["momentum"]
    ch = attrs["axis"] % data.dim()
    axes = tuple(i for i in range(data.dim()) if i != ch)
    bshape = tuple(-1 if i == ch else 1 for i in range(data.dim()))
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)   # a constant: gamma gets no gradient
    if is_train and not attrs["use_global_stats"]:
        shift = moving_mean.detach().float()
        xs = data.float() - shift.reshape(bshape)
        n = data.numel() // data.shape[ch]
        d_mean = xs.sum(dim=axes) / n
        mean = shift + d_mean
        var = torch.clamp_min(xs.square().sum(dim=axes) / n
                              - d_mean.square(), 0.0)
        new_mm = mom * moving_mean + (1 - mom) * mean.detach()
        new_mv = mom * moving_var + (1 - mom) * var.detach()
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    dt = data.dtype
    out = ((data - mean.reshape(bshape).to(dt)) * inv.reshape(bshape).to(dt)
           * gamma.reshape(bshape).to(dt) + beta.reshape(bshape).to(dt))
    return out, new_mm, new_mv


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
