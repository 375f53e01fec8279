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

The same LM tests train three steps through each package's ``Module.fit``
(an ``NDArrayIter`` over three batches, SGD momentum, ``Perplexity``)
from the JAX trainer's initial weights, held to the same tolerances, the
Perplexity readings too.  The classifier cases run the repo's end-to-end
drive (four Gaussian blobs, a two-layer MLP) through both packages'
``Module.fit`` (Xavier, ``FactorScheduler``, ``Speedometer``, ten epochs)
from one numpy seed, then score a checkpoint written by each package in
the other.  They also train with the other update ops (``adam``,
``rmsprop``, ``rmspropalex``: three trainer steps each, the states and
Adam's step counter held too) and run the blobs recipe with Adam.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.model import wait_for_checkpoint
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
# The blobs recipe with Adam: 400 samples in batches of 200.  Each new t of
# the JAX package's nd.adam_update compiles anew, per parameter shape.
BLOBS_BATCH = 200
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


def _module_state(mod):
    """A Module's parameters and optimizer states (by parameter name) as
    numpy; a state of several slots as a tuple."""
    args, _ = mod.get_params()
    states = mod._updater.states

    def host(st):
        return (tuple(x.asnumpy() for x in st) if isinstance(st, tuple)
                else st.asnumpy())

    return ({n: a.asnumpy() for n, a in args.items()},
            {n: host(states[i]) for i, n in enumerate(mod._param_names)
             if states.get(i) is not None})


def _slots(state):
    return state if isinstance(state, tuple) else (state,)


def _close_states(got, want, what):
    """Optimizer states (bare or tuples of slots, numpy or tensors) within
    MOM_TOL; the step counter equal."""
    assert sorted(got) == sorted(want), what
    for n in want:
        if n == "__num_update__":
            assert int(got[n]) == int(want[n]), what
            continue
        assert len(_slots(got[n])) == len(_slots(want[n])), (what, n)
        for i, (a, b) in enumerate(zip(_slots(got[n]), _slots(want[n]))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       err_msg="%s %s[%d]" % (what, n, i),
                                       **MOM_TOL)


def _fit_lm(mx, cfg, weights):
    """Three ``Module.fit`` steps of the LM on the CPU (one epoch of an
    NDArrayIter over ``_lm_batch(0..2)``) with the trainer tests' update,
    from ``weights``: ``(params, momenta, last outputs, the Perplexity
    reading after each batch, the metric's last labels and outputs)``."""
    tfm = jtfm if mx is jmx else ptfm
    batches = [_lm_batch(i) for i in range(3)]
    readings, last = [], []

    def after_batch(param):
        readings.append(param.eval_metric.get()[1])
        last[:] = [param.locals["data_batch"].label,
                   param.locals["self"].get_outputs()]

    with mx.cpu():
        it = mx.io.NDArrayIter(
            np.concatenate([b["data"] for b in batches]),
            np.concatenate([b["softmax_label"] for b in batches]),
            batch_size=B)
        mod = mx.mod.Module(tfm.get_symbol(**cfg), context=mx.cpu())
        mod.fit(it, num_epoch=1, eval_metric=mx.metric.Perplexity(None),
                optimizer="sgd", optimizer_params={
                    "learning_rate": 1e-2, "momentum": 0.9,
                    "rescale_grad": 1.0 / (B * T)},
                arg_params={n: mx.nd.array(np.asarray(a))
                            for n, a in weights.items()},
                batch_end_callback=after_batch)
        params, moms = _module_state(mod)
    return (params, moms, mod.get_outputs()[0].asnumpy(), readings,
            [a.asnumpy() for a in last[0]], [a.asnumpy() for a in last[1]])


def _modules_agree(cfg, weights, tol, mom_tol, out_tol):
    """Both packages' ``Module.fit`` steps agree within the tolerances
    (``mom_tol``/``tol`` None: the bf16 class, scaled per tensor); so do
    the two Perplexity metrics on the same labels and outputs."""
    jp, jm, jo, jr, lab, outs = _fit_lm(jmx, cfg, weights)
    pp, pm, po, pr, _, _ = _fit_lm(pmx, cfg, weights)
    assert sorted(pp) == sorted(jp) and sorted(pm) == sorted(jm)
    for what, got, want, t in (("param", pp, jp, tol), ("momentum", pm, jm,
                                                         mom_tol)):
        for n in want:
            np.testing.assert_allclose(
                got[n], want[n], err_msg="Module %s %s" % (what, n),
                **(t or dict(rtol=out_tol["rtol"], atol=out_tol["atol"]
                             * np.abs(want[n]).max())))
    np.testing.assert_allclose(po, jo, **out_tol)
    np.testing.assert_allclose(pr, jr, rtol=out_tol["rtol"])
    jmet, pmet = jmx.metric.Perplexity(None), pmx.metric.Perplexity(None)
    jmet.update(lab, outs)
    with pmx.cpu():
        pmet.update([pmx.nd.array(a) for a in lab],
                    [pmx.nd.array(a) for a in outs])
    assert pmet.num_inst == jmet.num_inst == B * T
    np.testing.assert_allclose(pmet.get()[1], jmet.get()[1], rtol=1e-6)


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
    weights = jt.init(seed=0)[0]
    _modules_agree(CFG, weights, PARAM_TOL, MOM_TOL, OUT_TOL)


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
    _modules_agree(cfg, jt.init(seed=0)[0], None, None,
                   dict(rtol=rtol, atol=atol))


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


def _blobs():
    rng = np.random.RandomState(0)
    centers = rng.randn(4, 10) * 3.0
    labels = rng.randint(0, 4, 400)
    data = (centers[labels] + rng.randn(400, 10)).astype(np.float32)
    return data, labels.astype(np.float32)


def _blobs_net(mx):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=32,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(net, num_hidden=4,
                                                      name="fc2"),
                                name="softmax")


def _fit_blobs(mx, prefix, optimizer_params, optimizer="sgd",
               num_epoch=10, batch_size=40):
    """The blobs recipe: ``num_epoch`` epochs of ``Module.fit``, shuffled
    batches and Xavier weights drawn from numpy's seed 0; then the training
    accuracy, and a checkpoint at ``prefix``.  Returns the module too."""
    data, labels = _blobs()
    saved = np.random.get_state()
    np.random.seed(0)
    try:
        with mx.cpu():
            train = mx.io.NDArrayIter(data, labels, batch_size=batch_size,
                                      shuffle=True)
            mod = mx.mod.Module(_blobs_net(mx), context=mx.cpu())
            mod.fit(train, num_epoch=num_epoch, optimizer=optimizer,
                    optimizer_params=optimizer_params,
                    initializer=mx.initializer.Xavier(),
                    batch_end_callback=mx.callback.Speedometer(batch_size, 5))
    finally:
        np.random.set_state(saved)
    with mx.cpu():
        acc = mod.score(mx.io.NDArrayIter(data, labels,
                                          batch_size=batch_size), "acc")
        mod.save_checkpoint(prefix, 1)
        params, moms = _module_state(mod)
    return params, moms, acc, mod


def _score_checkpoint(mx, prefix):
    data, labels = _blobs()
    with mx.cpu():
        sym, args, auxs = mx.model.load_checkpoint(prefix, 1)
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", (40, 10))],
                 label_shapes=[("softmax_label", (40,))], for_training=False)
        mod.set_params(args, auxs)
        return mod.score(mx.io.NDArrayIter(data, labels, batch_size=40),
                         "acc")


def _classifier_steps(skip, **kw):
    """Three steps of the classifier through both trainers (lr 0.1, wd,
    clip 0.5, ``kw``): outputs, weights and states held to the JAX
    trainer's after each; with ``skip`` the second batch carries a NaN,
    and that step must leave every weight, state slot and the step counter
    as they were, with the trailing flag 0.0.  Returns the port's trainer,
    its initial weights and its final ``(params, moms)``."""
    jt, pt = _pair(_classifier(jsym), _classifier(psym),
                   {"data": (4, 6), "softmax_label": (4,)}, {},
                   learning_rate=0.1, wd=1e-3, clip_gradient=0.5,
                   skip_nonfinite=skip, **kw)
    jp, jm, ja = jt.init(seed=3)
    pp, pm, pa = pt.init(seed=3)
    first = {n: t.clone() for n, t in pp.items()}
    # the JAX layout carried across: tuples of slots, the step counter
    cm = trainer_state_from_jax(
        {}, jax.tree_util.tree_map(np.asarray, jm), {}, "cpu")[1]
    assert sorted(cm) == sorted(pm)
    for n in pm:
        got, want = _slots(cm[n]), _slots(pm[n])
        assert len(got) == len(want), n
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n
    jstep, pstep = jt.step_fn(), pt.step_fn()
    for i in range(3):
        batch = _cls_batch(i, nan=skip and i == 1)
        before = [t.clone() for t in list(pp.values()) + [
            x for st in pm.values() for x in _slots(st)]]
        jouts, jp, jm, ja = jstep(jp, jm, ja, jt.place_batch(batch),
                                  jax.random.PRNGKey(i))
        pouts, pp, pm, pa = pstep(pp, pm, pa, pt.place_batch(batch))
        assert len(pouts) == len(jouts) == (2 if skip else 1)
        if skip:
            assert float(pouts[-1]) == float(jouts[-1]) == (0.0 if i == 1
                                                            else 1.0)
            if i == 1:
                after = list(pp.values()) + [x for st in pm.values()
                                             for x in _slots(st)]
                assert all(torch.equal(a, b) for a, b in zip(after, before))
        _close(pp, jp, PARAM_TOL, "param")
        _close_states(pm, jm, "%s state" % kw)
    return pt, first, pp, pm


def _module_steps(optimizer, weights, **params):
    """The port's ``Module.fit`` over the classifier trainer's three batches
    (one epoch, batch 4) from ``weights``: its ``(params, states)``."""
    batches = [_cls_batch(i) for i in range(3)]
    with pmx.cpu():
        it = pmx.io.NDArrayIter(
            np.concatenate([b["data"] for b in batches]),
            np.concatenate([b["softmax_label"] for b in batches]),
            batch_size=4)
        mod = pmx.mod.Module(_classifier(psym), context=pmx.cpu())
        mod.fit(it, num_epoch=1, optimizer=optimizer,
                optimizer_params=params, arg_params={
                    n: pmx.nd.NDArray(w.clone()) for n, w in weights.items()})
    return _module_state(mod)


@pytest.mark.parametrize("momentum,skip", [(0.0, False), (0.9, True)])
def test_classifier_steps_match_jax(momentum, skip, tmp_path):
    """Momentum 0 takes the per-parameter ``sgd_update`` loop; with
    ``skip_nonfinite`` a NaN batch (the second) leaves every weight and
    momentum as it was and the trailing flag reads 0.0.  Then the blobs
    recipe through both packages' ``Module.fit`` at the case's momentum,
    and each package's checkpoint scored by the other.

    The other optimizers: without the guard, three trainer steps with
    ``adam`` (its step counter in the states) and ``rmsprop``, the port's
    ``Module.fit`` with Adam bitwise its trainer, the blobs recipe with Adam
    (two epochs) in both packages, and the port's saved optimizer states
    loaded into a fresh Module (``Module.load``) giving the trained one's
    next update bit for bit; with the guard, ``rmspropalex`` and ``adam``,
    the NaN batch keeping every slot and the counter."""
    _classifier_steps(skip, momentum=momentum)
    for optimizer in ("rmspropalex", "adam") if skip else ("rmsprop", "adam"):
        pt, first, pp, pm = _classifier_steps(skip, optimizer=optimizer)
    assert int(pm["__num_update__"]) == 3 - skip
    if not skip:
        # Module's Adam runs the trainer's op with t its update count
        mp, mm = _module_steps("adam", first, learning_rate=0.1, wd=1e-3,
                               clip_gradient=0.5, rescale_grad=1.0)
        for n in pp:
            assert np.array_equal(mp[n], pp[n].numpy()), n
            assert all(np.array_equal(a, b.numpy())
                       for a, b in zip(mm[n], pm[n])), n

    jprefix, pprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    sgd = {"learning_rate": 0.2, "momentum": momentum}
    jp, jm, jacc, _ = _fit_blobs(jmx, jprefix, dict(
        sgd, lr_scheduler=jmx.lr_scheduler.FactorScheduler(20, 0.9)))
    pp, pm, pacc, _ = _fit_blobs(pmx, pprefix, dict(
        sgd, lr_scheduler=pmx.lr_scheduler.FactorScheduler(20, 0.9)))
    assert pacc == jacc and jacc[0][1] > 0.95
    for n in jp:
        np.testing.assert_allclose(pp[n], jp[n], err_msg="param " + n,
                                   **PARAM_TOL)
    assert sorted(pm) == sorted(jm) == ([] if momentum == 0 else sorted(jp))
    _close_states(pm, jm, "momentum")
    wait_for_checkpoint(jprefix + "-0001.params")
    assert _score_checkpoint(pmx, jprefix) == jacc
    assert _score_checkpoint(jmx, pprefix) == pacc
    if skip:
        return

    adam = {"learning_rate": 0.01}
    jp, jm, jacc, _ = _fit_blobs(jmx, jprefix, adam, "adam", 2, BLOBS_BATCH)
    pp, pm, pacc, mod = _fit_blobs(pmx, pprefix, adam, "adam", 2,
                                   BLOBS_BATCH)
    assert pacc == jacc and jacc[0][1] > 0.95
    for n in jp:
        np.testing.assert_allclose(pp[n], jp[n], err_msg="Adam param " + n,
                                   **PARAM_TOL)
    _close_states(pm, jm, "Adam state")
    # the saved states (two slots a parameter) in a fresh Module: the same
    # next update, bit for bit
    data, labels = _blobs()
    with pmx.cpu():
        mod.save_checkpoint(pprefix, 2, save_optimizer_states=True)
        fresh = pmx.mod.Module.load(pprefix, 2, load_optimizer_states=True,
                                    context=pmx.cpu())
        fresh.bind(data_shapes=[("data", (BLOBS_BATCH, 10))],
                   label_shapes=[("softmax_label", (BLOBS_BATCH,))])
        fresh.set_params(*mod.get_params())
        fresh.init_optimizer(optimizer="adam", optimizer_params=dict(
            adam, begin_num_update=2 * len(data) // BLOBS_BATCH))
        batch = pmx.io.NDArrayIter(data[:BLOBS_BATCH], labels[:BLOBS_BATCH],
                                   batch_size=BLOBS_BATCH).next()
        for m in (mod, fresh):
            m.forward_backward(batch)
            m.update()
        (ap, am), (bp, bm) = _module_state(mod), _module_state(fresh)
    for n in ap:
        assert np.array_equal(ap[n], bp[n]), n
        assert all(np.array_equal(a, b) for a, b in zip(am[n], bm[n])), n


def test_device_none_needs_cuda(monkeypatch):
    """The trainer, ``current_context()``, ``Module`` and ``mx.nd`` default
    to the card, and without one raise (naming ``cpu()``); ``mx.gpu()``
    and ``mx.tpu()`` name the same card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ShardedTrainer(_classifier(psym), None, data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)})
    for make in (pmx.current_context, lambda: pmx.nd.zeros((2,)),
                 lambda: pmx.mod.Module(_classifier(psym)),
                 lambda: pmx.mod.Module(_classifier(psym),
                                        context=pmx.tpu(0))):
        with pytest.raises(MXNetError, match=r"mx\.cpu\(\)"):
            make()
    assert pmx.tpu(0) == pmx.gpu(0) != pmx.cpu(0)
    with pmx.cpu():
        assert pmx.current_context() == pmx.cpu()
        assert pmx.nd.zeros((2,)).context == pmx.cpu()
        pmx.mod.Module(_classifier(psym))


@pytest.mark.parametrize("knob", [
    {"zero_stage": 1}, {"grad_accum": 2}, {"multi_precision": True},
    {"lr_scheduler": lambda t: 0.1}, {"remat": True}, {"pipeline_steps": 2},
    {"optimizer": "nadamax"}])
def test_later_slices_raise_naming_their_knob(knob):
    """Each knob of a later slice raises naming itself; so does an
    optimizer with no registered update op, and ``momentum=`` with an
    optimizer other than SGD."""
    name = next(iter(knob))
    with pytest.raises(MXNetError, match=name if name != "optimizer"
                       else "no fused update op 'nadamax_update'"):
        ShardedTrainer(_classifier(psym), None, data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)}, device="cpu",
                       **knob)
    if name == "optimizer":
        with pytest.raises(MXNetError, match="momentum= is an SGD knob"):
            ShardedTrainer(_classifier(psym), None,
                           data_shapes={"data": (4, 6)},
                           label_shapes={"softmax_label": (4,)},
                           device="cpu", optimizer="adam", momentum=0.9)


def test_mesh_of_many_devices_raises():
    with pytest.raises(MXNetError, match="mesh of 8 devices"):
        ShardedTrainer(_classifier(psym), np.zeros((2, 4)),
                       data_shapes={"data": (4, 6)},
                       label_shapes={"softmax_label": (4,)}, device="cpu")
