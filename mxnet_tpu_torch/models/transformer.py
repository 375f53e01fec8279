"""Decoder-only transformer LM: the training symbol and the functional
serving path.

:func:`get_symbol` is the JAX package's ``get_symbol`` (the graph that
``bench.py`` trains through ``ShardedTrainer``), for a dense FFN, a
softmax head and no rematerialization, in fp32 or (the bench's own
configuration) bf16; its other values raise.

The rest is the counterpart of the functional half of
``mxnet_tpu/models/transformer.py`` (``lm_config``, ``init_lm_params``,
``lm_prefill``, ``lm_decode_step``).
Parameters are a dict under the JAX package's checkpoint names
(``embed_weight``, ``pos_embed_weight`` ``[1, T, C]``, ``l0_ln1_gamma``,
``l0_attn_qkv_weight`` ``[3C, C]``, ..., ``pred_weight``), in the same
layouts: ``einsum("btc,fc->btf", x, w)`` is ``F.linear(x, w)``, so weights
cross between the packages without renaming or transposing
(:func:`params_from_jax`).  :class:`TransformerLM` holds them as an
``nn.Module`` under the same names.

Each block is pre-norm: layer norm, fused QKV projection, causal attention,
output projection, residual; layer norm, FFN with the GELU+bias epilogue,
residual.  On a CUDA device the attention, layer norms and epilogue run the
port's CUDA kernels and the projections run cuBLAS in full fp32 (TF32 off).
On the CPU every op is a plain version spelled so that token ``t``'s logits
have the same bits in a ``T``-row prefill, a full-sequence forward and a
one-row decode step (see :mod:`~mxnet_tpu_torch.ops.attention`); the
projections there are a multiply-and-reduce over C, because torch's CPU
sgemm takes a different summation order for one row than for several.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import symbol as sym
from ..base import MXNetError
from ..context import resolve_device
from ..ops.attention import paged_decode_attention, stable_causal_attention
from ..ops.fused.norm_kernels import lm_gelu_bias, lm_layer_norm

__all__ = ["TransformerLM", "get_symbol", "init_lm_params", "lm_config",
           "lm_decode_step", "lm_prefill", "params_from_jax",
           "params_to_numpy"]


def get_symbol(num_classes=32000, seq_len=1024, num_embed=512, num_heads=8,
               num_layers=6, dropout=0.0, causal=True,
               context_parallel_axis="", dtype="float32", head="softmax",
               remat="none", ffn="dense", **kwargs):
    """The LM's training graph: inputs ``data`` ``(batch, seq_len)`` int
    tokens and ``softmax_label`` ``(batch, seq_len)``; pre-norm blocks of
    ``LayerNorm`` → ``MultiHeadAttention`` → residual, ``LayerNorm`` →
    FFN (4x, tanh GELU) → residual; a final ``LayerNorm``, the vocab
    projection ``pred`` and one ``SoftmaxOutput`` head named ``softmax``.
    Parameter names and shapes are the JAX package's.  ``dtype`` other
    than fp32 casts the activations after the positional add and the
    ``pred`` logits back to fp32 before the head, as the JAX graph does:
    the parameters stay fp32 and each op casts them at use."""
    unported = {"dropout": dropout > 0,
                "head": head != "softmax", "remat": remat != "none",
                "ffn": ffn != "dense",
                "context_parallel_axis": bool(context_parallel_axis)}
    for knob, given in unported.items():
        if given:
            raise MXNetError("transformer.get_symbol %s=%r is not ported yet"
                             % (knob, locals().get(knob, kwargs.get(knob))))
    data = sym.Variable("data")
    x = sym.Embedding(data=data, input_dim=num_classes, output_dim=num_embed,
                      name="embed")
    pos = sym.Variable("pos_embed_weight", shape=(1, seq_len, num_embed))
    x = sym.broadcast_add(x, pos)
    if dtype != "float32":
        x = sym.Cast(x, dtype=dtype)
    for i in range(num_layers):
        h = sym.LayerNorm(x, name="l%d_ln1" % i)
        h = sym.MultiHeadAttention(h, num_heads=num_heads, causal=causal,
                                   name="l%d_attn" % i)
        x = x + h
        h = sym.LayerNorm(x, name="l%d_ln2" % i)
        h = sym.FullyConnected(h, num_hidden=4 * num_embed, flatten=False,
                               name="l%d_ffn1" % i)
        h = sym.Activation(h, act_type="gelu", name="l%d_gelu" % i)
        h = sym.FullyConnected(h, num_hidden=num_embed, flatten=False,
                               name="l%d_ffn2" % i)
        x = x + h
    x = sym.LayerNorm(x, name="final_ln")
    pred = sym.Reshape(x, shape=(-1, num_embed))
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    pred = sym.FullyConnected(pred, num_hidden=num_classes, name="pred")
    if dtype != "float32":
        pred = sym.Cast(pred, dtype="float32")
    return sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def lm_config(num_classes=128, seq_len=64, num_embed=32, num_heads=4,
              num_layers=2):
    """Config dict shared by :func:`init_lm_params` / :func:`lm_prefill` /
    :func:`lm_decode_step`."""
    if num_embed % num_heads:
        raise ValueError("num_embed %d not divisible by num_heads %d"
                         % (num_embed, num_heads))
    return {"num_classes": num_classes, "seq_len": seq_len,
            "num_embed": num_embed, "num_heads": num_heads,
            "num_layers": num_layers}


def init_lm_params(cfg, seed=0, scale=0.02):
    """Random fp32 params as numpy arrays under the checkpoint names.

    Draws the same ``numpy.random.RandomState(seed)`` sequence as the JAX
    package's ``init_lm_params``, so the two give the same bits."""
    rng = np.random.RandomState(seed)
    c, v, t = cfg["num_embed"], cfg["num_classes"], cfg["seq_len"]

    def w(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    params = {"embed_weight": w(v, c), "pos_embed_weight": w(1, t, c),
              "final_ln_gamma": np.ones(c, np.float32),
              "final_ln_beta": np.zeros(c, np.float32),
              "pred_weight": w(v, c), "pred_bias": np.zeros(v, np.float32)}
    for i in range(cfg["num_layers"]):
        params.update({
            "l%d_ln1_gamma" % i: np.ones(c, np.float32),
            "l%d_ln1_beta" % i: np.zeros(c, np.float32),
            "l%d_ln2_gamma" % i: np.ones(c, np.float32),
            "l%d_ln2_beta" % i: np.zeros(c, np.float32),
            "l%d_attn_qkv_weight" % i: w(3 * c, c),
            "l%d_attn_out_weight" % i: w(c, c),
            "l%d_ffn1_weight" % i: w(4 * c, c),
            "l%d_ffn1_bias" % i: np.zeros(4 * c, np.float32),
            "l%d_ffn2_weight" % i: w(c, 4 * c),
            "l%d_ffn2_bias" % i: np.zeros(c, np.float32),
        })
    return params


def params_from_jax(params, device=None):
    """Checkpoint dict (numpy or JAX arrays, or tensors) → fp32 tensors on
    ``device`` (default: the CUDA device), same names, same layouts."""
    device = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                  else a).to(device=device,
                                             dtype=torch.float32)
            for name, a in params.items()}


def params_to_numpy(params):
    """Tensors → numpy arrays under the same names (the way back)."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}


# Elements of the ``[rows, outputs, C]`` product that a CPU projection
# builds at once (64 MiB of fp32); wider projections take their outputs in
# chunks, so a full-width model's vocab head fits in memory.
_CPU_PRODUCT_ELEMS = 1 << 24


def _linear(x, w):
    """``einsum("btc,fc->btf", x, w)``."""
    if x.is_cuda:
        return F.linear(x, w)
    # one reduction of fixed length C per output, whatever the row count
    # and however the outputs are chunked
    step = max(1, _CPU_PRODUCT_ELEMS // max(1, x.numel()))
    if step >= w.shape[0]:
        return (x[..., None, :] * w).sum(-1)
    return torch.cat([(x[..., None, :] * w[i:i + step]).sum(-1)
                      for i in range(0, w.shape[0], step)], -1)


def _lm_ln(x, gamma, beta):
    return lm_layer_norm(x, gamma, beta)


def _lm_qkv(x, qkv_weight, cfg):
    """Fused QKV projection of ``[B, T, C]`` → q, k, v each
    ``[B, H, T, D]`` (views), split as ``reshape(b, t, 3, h, d)``."""
    b, t, c = x.shape
    h = cfg["num_heads"]
    qkv = _linear(x, qkv_weight).reshape(b, t, 3, h, c // h)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _lm_ffn(x, i, params):
    h = _linear(x, params["l%d_ffn1_weight" % i])
    h = lm_gelu_bias(h, params["l%d_ffn1_bias" % i])
    h = _linear(h, params["l%d_ffn2_weight" % i])
    return h + params["l%d_ffn2_bias" % i]


def _lm_logits(x, params):
    return _linear(x, params["pred_weight"]) + params["pred_bias"]


@torch.no_grad()
def lm_prefill(params, tokens, cfg):
    """Full-sequence forward of ``tokens`` int ``[B, T]`` (a tensor on the
    params' device).

    Returns ``(logits [B, T, V], k [L, B, T, H, D], v [L, B, T, H, D])``,
    K/V in cache page layout.  Also the lane's full forward, against which
    decode step ``t`` is held at row ``t``.
    """
    t = tokens.shape[1]
    x = params["embed_weight"][tokens.long()] + params["pos_embed_weight"][:, :t]
    ks, vs = [], []
    for i in range(cfg["num_layers"]):
        h = _lm_ln(x, params["l%d_ln1_gamma" % i], params["l%d_ln1_beta" % i])
        q, k, v = _lm_qkv(h, params["l%d_attn_qkv_weight" % i], cfg)
        a = stable_causal_attention(q, k, v)
        b, heads, tt, d = a.shape
        a = a.transpose(1, 2).reshape(b, tt, heads * d)
        x = x + _linear(a, params["l%d_attn_out_weight" % i])
        h = _lm_ln(x, params["l%d_ln2_gamma" % i], params["l%d_ln2_beta" % i])
        x = x + _lm_ffn(h, i, params)
        ks.append(k.transpose(1, 2))   # [B, T, H, D] page layout
        vs.append(v.transpose(1, 2))
    x = _lm_ln(x, params["final_ln_gamma"], params["final_ln_beta"])
    return _lm_logits(x, params), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def lm_decode_step(params, tokens, positions, k_pages, v_pages,
                   block_tables, context_lens, cfg):
    """One decode step for a batch of sequences through the paged cache.

    ``tokens``/``positions`` int ``[B]`` (position = context_len - 1);
    ``k_pages``/``v_pages`` ``[L, num_blocks, block_size, H, D]``;
    ``block_tables`` int32 ``[B, max_blocks]``; ``context_lens`` int32
    ``[B]`` counting the current token; all on the params' device.
    Returns ``(logits [B, V], k_step [L, B, H, D], v_step [L, B, H, D])``;
    the caller writes ``k_step``/``v_step`` into the pool only after the
    step succeeded.
    """
    x = (params["embed_weight"][tokens.long()]
         + params["pos_embed_weight"][0][positions.long()])[:, None, :]
    ks, vs = [], []
    for i in range(cfg["num_layers"]):
        h = _lm_ln(x, params["l%d_ln1_gamma" % i], params["l%d_ln1_beta" % i])
        q, k, v = _lm_qkv(h, params["l%d_attn_qkv_weight" % i], cfg)
        k1, v1 = k[:, :, 0], v[:, :, 0]      # [B, H, D]
        a = paged_decode_attention(q[:, :, 0], k1, v1, k_pages[i],
                                   v_pages[i], block_tables, context_lens)
        b, heads, d = a.shape
        x = x + _linear(a.reshape(b, 1, heads * d),
                        params["l%d_attn_out_weight" % i])
        h = _lm_ln(x, params["l%d_ln2_gamma" % i], params["l%d_ln2_beta" % i])
        x = x + _lm_ffn(h, i, params)
        ks.append(k1)
        vs.append(v1)
    x = _lm_ln(x, params["final_ln_gamma"], params["final_ln_beta"])
    return _lm_logits(x, params)[:, 0], torch.stack(ks), torch.stack(vs)


class TransformerLM(nn.Module):
    """The LM's parameters as an ``nn.Module``, registered under the
    checkpoint names (so ``state_dict()`` keys are ``embed_weight``,
    ``l0_attn_qkv_weight``, ...); ``forward`` is the full forward and
    :meth:`param_dict` feeds the functional path.

    ``params`` is a checkpoint dict (numpy or tensors); ``None`` draws
    :func:`init_lm_params` from ``seed``.  Inference only: the parameters
    do not require grad.
    """

    def __init__(self, cfg, params=None, device=None, seed=0):
        super().__init__()
        self.cfg = dict(cfg)
        if params is None:
            params = init_lm_params(self.cfg, seed=seed)
        for name, t in params_from_jax(params, device).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def param_dict(self):
        """``{checkpoint name: tensor}``, the functional path's params."""
        return dict(self.named_parameters())

    def forward(self, tokens):
        """Full forward of ``tokens [B, T]`` → logits ``[B, T, V]``."""
        return lm_prefill(self.param_dict(), tokens, self.cfg)[0]
