"""The port's ResNet against the JAX package's, the slice as a whole:
``models.resnet`` → ``ShardedTrainer`` → ``init`` → ``place_batch`` →
``step_fn``.

* The bench's ResNet-50 symbol (bf16, NHWC, s2d stem) has the JAX
  package's argument, auxiliary and output names, and the same inferred
  shapes and dtypes (inference only, no compute).
* A small bottleneck net at 64 px, batch 2, takes two ``ShardedTrainer``
  steps in both packages from the JAX ``init(seed=0)`` carried across by
  ``trainer_state_from_jax``, fp32, under ``MXTPU_CONV1X1`` unset and
  ``pallas`` (the JAX Pallas dgrad in interpret mode, the port's plain
  version).  Outputs and BatchNorm's moving statistics agree to 1e-4 of
  each tensor's largest value.  Weights and momenta are held to 1e-3: the
  JAX package's own fp32 steps are farther than 1e-4 from the same steps
  in float64 on several tensors, so the two fp32 steps are not held closer
  than that.  The test also runs the two steps in float64 (the port's
  formula, on the CPU) and checks that, tensor by tensor, the port's fp32
  step is no farther from it than the JAX package's (or than 1e-4).
  ``bn0_gamma``'s momentum is held to 1e-2: the stem's output reaches the
  loss only through per-channel BatchNorms, so the exact gradient of its
  scale is zero up to ``eps``, and what both packages compute is rounding.
* One bf16 step's outputs agree at the ``bfloat16`` class of
  ``ops/fused/parity.py`` (2e-2).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from mxnet_tpu.models import resnet as jres
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu.symbol import _infer as jinfer
from mxnet_tpu_torch.models import resnet as pres
from mxnet_tpu_torch.parallel import ShardedTrainer, trainer_state_from_jax
from mxnet_tpu_torch.symbol import infer as pinfer

OUT_AUX_TOL = 1e-4
STATE_TOL = 1e-3
CANCELLING = {"bn0_gamma": 1e-2}   # momentum of a gradient that is ~0
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

B = 2
SMALL = dict(units=[1, 1, 1, 1], num_stages=4,
             filter_list=[8, 32, 64, 128, 256], num_classes=10,
             image_shape=(3, 64, 64), layout="NHWC", stem="s2d")
TRAIN = dict(momentum=0.9, learning_rate=0.1, wd=1e-4, rescale_grad=1.0 / B)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    on one CPU, and each torch op would otherwise start a thread per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bench_symbol(lib):
    return lib.get_symbol(num_classes=1000, num_layers=50,
                          image_shape=(3, 224, 224), dtype="bfloat16",
                          layout="NHWC", stem="s2d")


def test_resnet_symbols_match_jax():
    """The bench's ResNet-50 symbol, then other depths, stems and layouts
    (a loop, not parameters: see the note at the end of
    test_torch_conv1x1.py)."""
    psym, jsym = _bench_symbol(pres), _bench_symbol(jres)
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_auxiliary_states() == jsym.list_auxiliary_states()
    # bn_data, bn0, three in each of the 16 units, bn1
    assert len(psym.list_auxiliary_states()) == 2 * 51
    assert psym.list_outputs() == jsym.list_outputs() == ["softmax_output"]
    shapes = {"data": (128, 3, 224, 224), "softmax_label": (128,)}
    got, want = pinfer(psym, shapes), jinfer(jsym, shapes)
    for kind, g, w in zip(("arg shapes", "out shapes", "aux shapes",
                           "arg types", "aux types"), got, want):
        assert [None if x is None else (tuple(x) if kind.endswith("shapes")
                                        else np.dtype(x)) for x in g] == \
            [None if x is None else (tuple(x) if kind.endswith("shapes")
                                     else np.dtype(x)) for x in w], kind
    arg_types = dict(zip(psym.list_arguments(), got[3]))
    assert arg_types["conv0_weight"] == np.float32   # fp32 masters
    assert dict(zip(psym.list_arguments(), got[0]))["conv0_weight"] == \
        (64, 4, 4, 12)                               # the s2d stem, OHWI
    # other depths, stems and layouts of the unit table (cifar's 3 stages
    # of basic units among them): names and the inferred argument and
    # auxiliary shapes
    for layers, image, layout, stem, dtype in (
            (18, 224, "NCHW", "conv7", "float32"),
            (34, 224, "NHWC", "conv7", "float32"),
            (101, 224, "NHWC", "s2d", "bfloat16"),
            (20, 28, "NCHW", "conv7", "float32"),
            (56, 28, "NHWC", "conv7", "float32")):
        kw = dict(num_classes=10, num_layers=layers,
                  image_shape=(3, image, image), dtype=dtype, layout=layout,
                  stem=stem)
        psym, jsym = pres.get_symbol(**kw), jres.get_symbol(**kw)
        assert psym.list_arguments() == jsym.list_arguments(), kw
        assert psym.list_auxiliary_states() == \
            jsym.list_auxiliary_states(), kw
        shapes = {"data": (2, 3, image, image), "softmax_label": (2,)}
        got, want = pinfer(psym, shapes), jinfer(jsym, shapes)
        for i in (0, 2):
            assert [tuple(x) for x in got[i]] == \
                [tuple(x) for x in want[i]], kw


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.uniform(-1, 1, (B, 3, 64, 64)).astype(np.float32),
            "softmax_label": rng.randint(0, 10, (B,)).astype(np.float32)}


def _trainers(dtype="float32"):
    shapes = dict(data_shapes={"data": (B, 3, 64, 64)},
                  label_shapes={"softmax_label": (B,)})
    jt = JTrainer(jres.resnet(dtype=dtype, **SMALL),
                  Mesh(np.array(jax.devices()[:1]), ("data",)), **shapes,
                  **TRAIN)
    pt = ShardedTrainer(pres.resnet(dtype=dtype, **SMALL), None,
                        device="cpu", **shapes, **TRAIN)
    return jt, pt


def _np(d):
    return {n: np.asarray(a) for n, a in d.items()}


def _hold(got, want, tol, what, overrides=None):
    """Every tensor within ``tol`` (or its override) of its largest value."""
    for n in want:
        w = np.asarray(want[n], np.float64)
        g = got[n].detach().double().numpy()
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= (overrides or {}).get(n, tol), \
            "%s %s: %.3e of its largest value" % (what, n, err)


def _rel(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def test_two_resnet_steps_match_jax(monkeypatch):
    for mode in ("", "pallas"):
        monkeypatch.setenv("MXTPU_CONV1X1", mode)
        _two_steps_match_jax()


def _two_steps_match_jax():
    jt, pt = _trainers()
    jp, jm, ja = jt.init(seed=0)
    pp, pm, pa = trainer_state_from_jax(_np(jp), _np(jm), _np(ja), "cpu")
    assert list(pa) == list(ja) and len(pa) == 2 * 15
    # the same two steps in float64, by the port's formula
    exact = [{n: t.double() for n, t in d.items()} for d in (pp, pm, pa)]
    jstep, pstep = jt.step_fn(), pt.step_fn()
    for i in range(2):
        batch = _batch(i)
        jouts, jp, jm, ja = jstep(jp, jm, ja, jt.place_batch(batch),
                                  jax.random.PRNGKey(i))
        pouts, pp, pm, pa = pstep(pp, pm, pa, pt.place_batch(batch))
        _hold({"out": pouts[0]}, {"out": jouts[0]}, OUT_AUX_TOL, "output")
        exact = pstep(*exact, {n: torch.from_numpy(a.astype(np.float64))
                               for n, a in batch.items()})[1:]
    _hold(pa, ja, OUT_AUX_TOL, "aux")
    _hold(pp, jp, STATE_TOL, "weight")
    _hold(pm, jm, STATE_TOL, "momentum", CANCELLING)
    for what, port, ref, ex in (("weight", pp, jp, exact[0]),
                                ("momentum", pm, jm, exact[1])):
        for n in ex:
            port_err = _rel(port[n].numpy(), ex[n].numpy())
            jax_err = _rel(ref[n], ex[n].numpy())
            assert port_err <= max(OUT_AUX_TOL, jax_err), (
                "%s %s: the port's fp32 step is %.3e from the float64 one, "
                "the JAX package's %.3e" % (what, n, port_err, jax_err))


def test_bf16_resnet_step_outputs_match_jax():
    jt, pt = _trainers("bfloat16")
    jp, jm, ja = jt.init(seed=0)
    pp, pm, pa = trainer_state_from_jax(_np(jp), _np(jm), _np(ja), "cpu")
    batch = _batch(0)
    jouts = jt.step_fn()(jp, jm, ja, jt.place_batch(batch),
                         jax.random.PRNGKey(0))[0]
    pouts = pt.step_fn()(pp, pm, pa, pt.place_batch(batch))[0]
    assert pouts[0].dtype == torch.float32   # cast back after fc1
    np.testing.assert_allclose(pouts[0].numpy(), np.asarray(jouts[0]),
                               **BF16_TOL)
