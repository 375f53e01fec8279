"""mxnet_tpu_torch's transformer LM against the JAX package, and its own
decode/full-forward contract.

- ``init_lm_params`` gives the JAX package's bits; ``params_from_jax``
  carries them across under the same names and layouts and back.
- ``lm_prefill`` / ``lm_decode_step`` logits and K/V match the JAX
  package's within 1e-4 absolute and relative: XLA and torch sum the
  projections and softmax in different orders, and the error compounds
  over the layers.
- Within the port on the CPU, a decode step through the paged cache gives
  EXACTLY the full forward's logits (``tests/test_generation.py``'s
  contract for the JAX package).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch.models import transformer as ptfm
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.kv_cache import PagedKVCache

VOCAB, SEQ_LEN, EMBED, HEADS, LAYERS = 64, 48, 16, 2, 2
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def lm():
    cfg = ptfm.lm_config(num_classes=VOCAB, seq_len=SEQ_LEN,
                         num_embed=EMBED, num_heads=HEADS, num_layers=LAYERS)
    return cfg, jtfm.init_lm_params(cfg, seed=0)


def test_init_lm_params_bitwise_equal_to_jax(lm):
    cfg, jparams = lm
    assert cfg == jtfm.lm_config(num_classes=VOCAB, seq_len=SEQ_LEN,
                                 num_embed=EMBED, num_heads=HEADS,
                                 num_layers=LAYERS)
    ours = ptfm.init_lm_params(cfg, seed=0)
    assert sorted(ours) == sorted(jparams)
    for name, a in jparams.items():
        assert ours[name].dtype == a.dtype and np.array_equal(ours[name], a)


def test_params_from_jax_round_trips(lm):
    cfg, jparams = lm
    tensors = ptfm.params_from_jax(jparams, "cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tensors.values())
    back = ptfm.params_to_numpy(tensors)
    assert all(np.array_equal(back[n], a) for n, a in jparams.items())
    module = ptfm.TransformerLM(cfg, params=jparams, device="cpu")
    assert sorted(module.state_dict()) == sorted(jparams)
    assert module.l0_attn_qkv_weight.shape == (3 * EMBED, EMBED)
    tokens = torch.tensor([[3, 1, 4, 1, 5]])
    assert torch.equal(module(tokens),
                       ptfm.lm_prefill(tensors, tokens, cfg)[0])


def test_prefill_matches_jax(lm):
    cfg, jparams = lm
    tokens = np.random.RandomState(1).randint(0, VOCAB, (2, 11))
    want = [np.asarray(a) for a in jtfm.lm_prefill(
        jparams, jnp.asarray(tokens, jnp.int32), cfg)]
    got = ptfm.lm_prefill(ptfm.params_from_jax(jparams, "cpu"),
                          torch.from_numpy(tokens), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_decode_step_matches_jax(lm):
    """A batch of three sequences, different lengths, one padded row."""
    cfg, jparams = lm
    rng = np.random.RandomState(2)
    blk, max_blocks = 4, SEQ_LEN // 4
    k_pages, v_pages = (rng.randn(LAYERS, 16, blk, HEADS, EMBED // HEADS)
                        .astype(np.float32) for _ in range(2))
    tables = np.zeros((4, max_blocks), np.int32)
    tables[0, :2] = [3, 4]
    tables[1, :3] = [5, 6, 7]
    tables[2, :1] = [8]
    ctx = np.array([7, 12, 2, 1], np.int32)
    tokens = rng.randint(0, VOCAB, 4).astype(np.int32)
    positions = ctx - 1
    want = [np.asarray(a) for a in jtfm.lm_decode_step(
        jparams, *map(jnp.asarray, (tokens, positions, k_pages, v_pages,
                                     tables, ctx)), cfg)]
    got = ptfm.lm_decode_step(
        ptfm.params_from_jax(jparams, "cpu"), torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(tables),
        torch.from_numpy(ctx), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_decode_exactly_equals_full_forward(lm):
    """Token t's logits from the paged decode path (padded block tables,
    a padded decode batch) have the full forward's bits at row t."""
    cfg, jparams = lm
    params = ptfm.params_from_jax(jparams, "cpu")
    reset_launch_counts()
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, VOCAB, size=5).tolist()
    steps = 9
    toks, ref = list(prompt), []
    for _ in range(steps):
        logits = ptfm.lm_prefill(params, torch.tensor([toks]), cfg)[0]
        ref.append(logits[0, len(toks) - 1])
        toks.append(int(ref[-1].argmax()))

    cache = PagedKVCache(LAYERS, HEADS, EMBED // HEADS, block_size=4,
                         num_blocks=32, device="cpu")
    cache.allocate("s", len(prompt) + steps)
    padded = torch.tensor([prompt + [0] * (8 - len(prompt))])
    logits, k, v = ptfm.lm_prefill(params, padded, cfg)
    assert torch.equal(logits[0, len(prompt) - 1], ref[0])
    cache.write_prefill("s", k[:, 0, :len(prompt)], v[:, 0, :len(prompt)])
    length, last = len(prompt), int(ref[0].argmax())
    for t in range(1, steps):
        table = cache.block_table("s", SEQ_LEN // 4)
        # batch bucket 2: the second row is padding (block 0, context 1)
        logits, ks, vs = ptfm.lm_decode_step(
            params, torch.tensor([last, 0]), torch.tensor([length, 0]),
            cache.k_pages, cache.v_pages,
            torch.from_numpy(np.stack([table, np.zeros_like(table)])),
            torch.tensor([length + 1, 1], dtype=torch.int32), cfg)
        assert torch.equal(logits[0], ref[t]), \
            "decode step %d differs from the full forward" % t
        cache.write_token("s", length, ks[:, 0], vs[:, 0])
        length += 1
        last = int(logits[0].argmax())
    assert toks[len(prompt):] == [int(r.argmax()) for r in ref]
    assert all(n == 0 for n in launch_counts().values())


def test_cpu_projection_chunks_wide_outputs(lm, monkeypatch):
    """A CPU projection wider than its memory budget takes its outputs in
    chunks with the same bits as one product, and the LM's logits keep
    their bits when every projection is chunked."""
    cfg, jparams = lm
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 7, 64).astype(np.float32))
    w = torch.from_numpy(rng.randn(1000, 64).astype(np.float32))
    whole = ptfm._linear(x, w)
    params = ptfm.params_from_jax(jparams, "cpu")
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (2, 9)))
    logits = ptfm.lm_prefill(params, tokens, cfg)[0]
    # 37 outputs per chunk, the last one ragged
    monkeypatch.setattr(ptfm, "_CPU_PRODUCT_ELEMS", x.numel() * 37)
    chunked = ptfm._linear(x, w)
    assert torch.equal(chunked, whole)
    np.testing.assert_allclose(chunked.numpy(),
                               torch.nn.functional.linear(x, w).numpy(),
                               rtol=2e-5, atol=2e-5)
    monkeypatch.setattr(ptfm, "_CPU_PRODUCT_ELEMS", 2 * 9 * EMBED * 5)
    assert torch.equal(ptfm.lm_prefill(params, tokens, cfg)[0], logits)
