"""mxnet_tpu_torch's generation lane against the JAX package's, and the
port's package boundary.

- A ``GenerationScheduler`` on ``device="cpu"`` answers three concurrent
  requests with the JAX lane's tokens, and each step's logits (the
  prefill's last row, then every decode step) within 1e-4 absolute and
  relative of the JAX lane's: the two frameworks sum in different orders.
- A request submitted mid-generation joins the running decode batch.
- Cache exhaustion sheds with the typed 429, counted by admission.
- ``LMBackend`` without ``device`` and without CUDA raises; the package
  imports neither ``jax`` nor ``mxnet_tpu``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ptfm
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops.kv_cache import CacheExhaustedError
from mxnet_tpu_torch.serving import GenerationScheduler, LMBackend

VOCAB, SEQ_LEN, EMBED, HEADS, LAYERS = 64, 48, 16, 2, 2
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    cfg = jtfm.lm_config(num_classes=VOCAB, seq_len=SEQ_LEN,
                         num_embed=EMBED, num_heads=HEADS,
                         num_layers=LAYERS)
    return cfg, jtfm.init_lm_params(cfg, seed=0)


class _Recorder(object):
    """Keeps every step's logits per sequence, for either package's
    backend: wraps prefill/decode and the cache's allocate/free on the
    instance."""

    def __init__(self, backend):
        self.log = []
        cache = backend.cache
        prefill, decode = backend.prefill, backend.decode
        allocate, free = cache.allocate, cache.free
        width = backend.max_blocks_per_seq

        def rec_prefill(tokens, length):
            out = prefill(tokens, length)
            self.log.append(("prefill", np.array(out[0])))
            return out

        def rec_decode(tokens, positions, tables, context):
            out = decode(tokens, positions, tables, context)
            self.log.append(("decode", np.array(tables), np.array(positions),
                             np.array(out[0])))
            return out

        def rec_allocate(seq_id, num_tokens):
            allocate(seq_id, num_tokens)
            self.log.append(("alloc", seq_id,
                             cache.block_table(seq_id, width)))

        def rec_free(seq_id):
            self.log.append(("free", seq_id))
            return free(seq_id)

        backend.prefill, backend.decode = rec_prefill, rec_decode
        cache.allocate, cache.free = rec_allocate, rec_free

    def logits_of(self, seq_id):
        rows, table, live = [], None, False
        for ev in self.log:
            if ev[0] == "alloc" and ev[1] == seq_id:
                table, live = ev[2], True
            elif ev[0] == "free" and ev[1] == seq_id:
                live = False
            elif live and ev[0] == "prefill" and not rows:
                rows.append(ev[1])
            elif live and ev[0] == "decode":
                tables, positions, logits = ev[1:]
                hit = np.where((tables == table).all(axis=1)
                               & (positions > 0))[0]
                assert len(hit) == 1
                rows.append(logits[hit[0]])
        return np.stack(rows)


def _run(sched, backend, prompts, new_tokens):
    rec = _Recorder(backend)
    reqs = [sched.submit("lm", p, max_new_tokens=n)
            for p, n in zip(prompts, new_tokens)]
    out = [r.result(timeout=60) for r in reqs]
    sched.close()
    return out, [rec.logits_of(r.seq_id) for r in reqs]


def _port(lm, **kw):
    cfg, params = lm
    be = LMBackend(params, cfg, block_size=4,
                   num_blocks=kw.pop("num_blocks", 64), device="cpu")
    sched = GenerationScheduler()
    sched.register("lm", be, decode_buckets=[1, 2, 4],
                   prefill_buckets=[8, 16], **kw)
    sched.warmup("lm")
    return sched, be


def test_lane_matches_the_jax_lane(lm):
    cfg, params = lm
    reset_launch_counts()
    prompts = [np.array([3, 9, 1, 7], np.int32),
               np.arange(1, 12).astype(np.int32),
               np.array([5, 5, 2, 8, 13, 21, 34], np.int32)]
    new_tokens = [8, 6, 7]

    sched, be = _port(lm)
    ours, our_logits = _run(sched, be, prompts, new_tokens)

    jsched = jserving.GenerationScheduler()
    jbe = jserving.LMBackend(params, cfg, block_size=4, num_blocks=64)
    jsched.register("lm", jbe, decode_buckets=[1, 2, 4],
                    prefill_buckets=[8, 16])
    jsched.warmup("lm")
    theirs, their_logits = _run(jsched, jbe, prompts, new_tokens)

    assert ours == theirs
    for mine, want, n in zip(our_logits, their_logits, new_tokens):
        assert mine.shape == want.shape == (n, VOCAB)
        np.testing.assert_allclose(mine, want, rtol=TOL, atol=TOL)
    assert all(n == 0 for n in launch_counts().values())


def test_request_joins_mid_generation(lm):
    sched, be = _port(lm)
    r1 = sched.submit("lm", np.array([1, 2, 3], np.int32),
                      max_new_tokens=24)
    deadline = time.monotonic() + 10
    while sched.stats("lm")["steps"] < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert sched.stats("lm")["steps"] >= 2, "r1 never started decoding"
    r2 = sched.submit("lm", np.array([9, 8], np.int32), max_new_tokens=24)
    assert len(r1.result(timeout=30)) == 24
    assert len(r2.result(timeout=30)) == 24
    st = sched.stats("lm")
    assert st["max_step_rows"] >= 2, "r2 never shared a decode step with r1"
    assert st["dispatch_errors"] == 0 and st["requests"] == 2
    # joining mid-flight never changed r2's tokens
    assert r2.generated == sched.generate("lm", [9, 8], max_new_tokens=24)
    sched.close()
    assert be.cache.stats()["used"] == 0


def test_exhaustion_sheds_with_typed_429(lm):
    sched, _ = _port(lm, num_blocks=4)        # 16 tokens of cache
    req = sched.submit("lm", np.arange(1, 10).astype(np.int32),
                       max_new_tokens=10)
    with pytest.raises(CacheExhaustedError):
        req.result(timeout=30)
    assert sched.admission.rejected[("lm", "cache_exhausted",
                                     "default")] == 1
    assert len(sched.generate("lm", [1, 2], max_new_tokens=3)) == 3
    sched.close()


def test_backend_needs_cuda_unless_cpu_is_asked_for(lm, monkeypatch):
    cfg, params = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        LMBackend(params, cfg)
    assert LMBackend(params, cfg, device="cpu").device.type == "cpu"


def test_package_imports_neither_jax_nor_mxnet_tpu():
    """Every module of the package (walked, so new ones are covered) and
    chip_smoke.py import neither jax nor anything of mxnet_tpu."""
    code = ("import importlib, pkgutil, sys, mxnet_tpu_torch, chip_smoke; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "mxnet_tpu_torch.__path__, 'mxnet_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) > 20, mods; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_hot_swap_reprefills_live_sequences(lm):
    """A swap mid-generation re-prefills live sequences on the new backend
    (same weights, so the token stream is unchanged) and frees them from
    it when they finish."""
    cfg, params = lm
    sched, be1 = _port(lm)
    clean = sched.generate("lm", [1, 2, 3], max_new_tokens=16)
    base = sched.stats("lm")["steps"]
    decode = be1.decode

    def slow_decode(*args):
        time.sleep(0.02)
        return decode(*args)

    be1.decode = slow_decode
    req = sched.submit("lm", np.array([1, 2, 3], np.int32),
                       max_new_tokens=16)
    deadline = time.monotonic() + 10
    while (sched.stats("lm")["steps"] < base + 2
           and time.monotonic() < deadline):
        time.sleep(0.002)
    assert sched.stats("lm")["active"] == 1
    be2 = LMBackend(params, cfg, block_size=4, num_blocks=64, device="cpu")
    assert sched.swap("lm", be2) is be1
    assert req.result(timeout=60) == clean
    assert sched.stats("lm")["reprefills"] >= 1, sched.stats("lm")
    assert be2.cache.stats()["used"] == 0
    sched.close()


def test_backend_infer_is_the_full_forward(lm):
    """The Backend protocol's full forward (no cache) returns the
    full-sequence logits of ``lm_prefill``."""
    cfg, params = lm
    be = LMBackend(params, cfg, block_size=4, num_blocks=8, device="cpu")
    tokens = np.array([[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]], np.int32)
    (logits,), cold = be.infer({"data": tokens})
    assert cold and not be.infer({"data": tokens})[1]
    want = ptfm.lm_prefill(be.params, torch.from_numpy(tokens).long(), cfg)[0]
    assert np.array_equal(logits, want.numpy())
    with pytest.raises(MXNetError):
        be.infer({"data": np.array([[VOCAB]], np.int32)})
