"""mxnet_tpu_torch's ShardedTrainer against the JAX package's, the slice
as a whole: ``get_symbol`` → ``ShardedTrainer`` → ``init`` →
``place_batch`` → ``step_fn``.

The port's trainer runs on ``device="cpu"`` (every kernel's plain
version); the JAX trainer on a one-device CPU mesh.  ``init(seed=0)`` gives
the same bits in both (the same numpy draws).  Three steps of the 2-layer
d32 LM with SGD momentum then agree within fp32 tolerances, stated below;
so do a momentum-0 run and a ``skip_nonfinite`` step over a NaN batch, on a
one-layer softmax classifier (whose float input can carry the NaN).  The
bench's own dtype, ``get_symbol(dtype="bfloat16")``, trains three steps
with fp32 parameters and momenta to the JAX trainer's results within the
bf16 class of the JAX parity harness (``parity._TOL``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops.fused.parity import _TOL
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch import symbol as psym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ptfm
from mxnet_tpu_torch.parallel import ShardedTrainer, trainer_state_from_jax

# Softmax outputs: probabilities of ~1/64, summed in other orders through
# two layers; weights after three steps of lr 1e-2; momenta are
# lr * rescale * gradient, small numbers held relative to their size.
OUT_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MOM_TOL = dict(rtol=1e-3, atol=1e-8)

B, T, V = 2, 16, 64
CFG = dict(num_classes=V, seq_len=T, num_embed=32, num_heads=4, num_layers=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on the test's own thread (see
    ``tests/test_torch_attention.py``: torch's first multi-threaded
    ``exp`` in a process can return one chunk at reduced accuracy)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))


def _np(d):
    return {n: np.asarray(a) for n, a in d.items()}


def _pair(jsy, psy, shapes, types, **kw):
    data = {k: v for k, v in shapes.items() if k == "data"}
    labels = {k: v for k, v in shapes.items() if k != "data"}
    jt = JTrainer(jsy, _mesh(), data_shapes=data, label_shapes=labels,
                  type_dict=types, **kw)
    pt = ShardedTrainer(psy, None, data_shapes=data, label_shapes=labels,
                        type_dict=types, device="cpu", **kw)
    return jt, pt


def _lm_batch(seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, V, (B, T)).astype(np.int32),
            "softmax_label": rng.randint(0, V, (B, T)).astype(np.float32)}


def _close(got, want, tol, what):
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   err_msg="%s %s" % (what, n), **tol)


def test_three_lm_steps_match_jax():
    jt, pt = _pair(jtfm.get_symbol(**CFG), ptfm.get_symbol(**CFG),
                   {"data": (B, T), "softmax_label": (B, T)},
                   {"data": "int32"}, learning_rate=1e-2, momentum=0.9,
                   rescale_grad=1.0 / (B * T))
    jp, jm, ja = jt.init(seed=0)
    pp, pm, pa = pt.init(seed=0)
    assert list(pp) == list(jp) and list(pm) == list(jm)
    for n in jp:
        assert np.array_equal(pp[n].numpy(), np.asarray(jp[n])), n
    # the JAX state carried across steps from the same point
    cp, cm, ca = trainer_state_from_jax(_np(jp), _np(jm), _np(ja), "cpu")
    for n in jp:
        assert torch.equal(cp[n], pp[n]) and torch.equal(cm[n], pm[n])
    jstep, pstep = jt.step_fn(), pt.step_fn()
    for i in range(3):
        batch = _lm_batch(i)
        jouts, jp, jm, ja = jstep(jp, jm, ja, jt.place_batch(batch),
                                  jax.random.PRNGKey(i))
        pouts, pp, pm, pa = pstep(pp, pm, pa, pt.place_batch(batch))
        assert len(pouts) == len(jouts) == 1
        np.testing.assert_allclose(pouts[0].numpy(), np.asarray(jouts[0]),
                                   **OUT_TOL)
    _close(pp, jp, PARAM_TOL, "param")
    _close(pm, jm, MOM_TOL, "momentum")


def test_three_bf16_lm_steps_match_jax():
    """The bench's dtype: the graph computes in bf16 between the two Casts
    while the trainer keeps fp32 parameters and momenta (the JAX trainer's
    ``arg_dtypes``).  The two frameworks round bf16 at other places (XLA
    fuses elementwise chains, torch rounds after each op; the port's flash
    plain versions round p where the Pallas kernel does, the JAX CPU path
    does not), so the outputs are held to the bf16 class and the weights and
    momenta to the same class with its absolute part scaled by each
    tensor's largest value (a bias starts at zero and holds only updates)."""
    rtol, atol = _TOL["bfloat16"]
    cfg = dict(CFG, dtype="bfloat16")
    jt, pt = _pair(jtfm.get_symbol(**cfg), ptfm.get_symbol(**cfg),
                   {"data": (B, T), "softmax_label": (B, T)},
                   {"data": "int32"}, learning_rate=1e-2, momentum=0.9,
                   rescale_grad=1.0 / (B * T))
    assert {n: str(t) for n, t in pt.arg_dtypes.items()} == \
        {n: str(t) for n, t in jt.arg_dtypes.items()}
    jp, jm, ja = jt.init(seed=0)
    pp, pm, pa = pt.init(seed=0)
    jstep, pstep = jt.step_fn(), pt.step_fn()
    for i in range(3):
        batch = _lm_batch(i)
        jouts, jp, jm, ja = jstep(jp, jm, ja, jt.place_batch(batch),
                                  jax.random.PRNGKey(i))
        pouts, pp, pm, pa = pstep(pp, pm, pa, pt.place_batch(batch))
        assert pouts[0].dtype == torch.float32
        np.testing.assert_allclose(pouts[0].numpy(), np.asarray(jouts[0]),
                                   rtol=rtol, atol=atol)
    for what, got, want in (("param", pp, jp), ("momentum", pm, jm)):
        for n in want:
            w = np.asarray(want[n])
            assert got[n].dtype == torch.float32 and w.dtype == np.float32
            np.testing.assert_allclose(got[n].numpy(), w, rtol=rtol,
                                       atol=atol * np.abs(w).max(),
                                       err_msg="%s %s" % (what, n))


def _classifier(lib):
    data = lib.Variable("data")
    fc = lib.FullyConnected(data, num_hidden=5, name="fc")
    return lib.SoftmaxOutput(fc, name="softmax")


def _cls_batch(seed, nan=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 6).astype(np.float32)
    if nan:
        x[1, 2] = np.nan
    return {"data": x, "softmax_label": np.array([0, 1, 4, 2], np.float32)}


@pytest.mark.parametrize("momentum,skip", [(0.0, False), (0.9, True)])
def test_classifier_steps_match_jax(momentum, skip):
    """Momentum 0 takes the per-parameter ``sgd_update`` loop; with
    ``skip_nonfinite`` a NaN batch (the second) leaves every weight and
    momentum as it was and the trailing flag reads 0.0."""
    jt, pt = _pair(_classifier(jsym), _classifier(psym),
                   {"data": (4, 6), "softmax_label": (4,)}, {},
                   learning_rate=0.1, momentum=momentum, wd=1e-3,
                   clip_gradient=0.5, skip_nonfinite=skip)
    jp, jm, ja = jt.init(seed=3)
    pp, pm, pa = pt.init(seed=3)
    jstep, pstep = jt.step_fn(), pt.step_fn()
    for i in range(3):
        batch = _cls_batch(i, nan=skip and i == 1)
        before = {n: t.clone() for n, t in pp.items()}
        jouts, jp, jm, ja = jstep(jp, jm, ja, jt.place_batch(batch),
                                  jax.random.PRNGKey(i))
        pouts, pp, pm, pa = pstep(pp, pm, pa, pt.place_batch(batch))
        assert len(pouts) == len(jouts) == (2 if skip else 1)
        if skip:
            assert float(pouts[-1]) == float(jouts[-1]) == (0.0 if i == 1
                                                            else 1.0)
            if i == 1:
                for n in pp:
                    assert torch.equal(pp[n], before[n])
        _close(pp, jp, PARAM_TOL, "param")
        _close(pm, jm, MOM_TOL, "momentum")
    assert (momentum == 0) == (pm == {} and jm == {})


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ShardedTrainer(_classifier(psym), None, data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)})


@pytest.mark.parametrize("knob", [
    {"zero_stage": 1}, {"grad_accum": 2}, {"multi_precision": True},
    {"lr_scheduler": lambda t: 0.1}, {"remat": True}, {"pipeline_steps": 2},
    {"optimizer": "adam"}])
def test_later_slices_raise_naming_their_knob(knob):
    name = next(iter(knob))
    with pytest.raises(MXNetError, match=name if name != "optimizer"
                       else "adam"):
        ShardedTrainer(_classifier(psym), None, data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)}, device="cpu",
                       **knob)


def test_mesh_of_many_devices_raises():
    with pytest.raises(MXNetError, match="mesh of 8 devices"):
        ShardedTrainer(_classifier(psym), np.zeros((2, 4)),
                       data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)}, device="cpu")
