"""Evaluation metrics (the JAX package's ``metric.py``).

``Accuracy``, ``Perplexity`` and ``CrossEntropy`` work on the
prediction's device: they gather the label's entry (or take the argmax)
there and move only each batch's sums to the host.  At the bench LM's
width a prediction is ``(8 * 2048, 32000)`` fp32, 2.1 GB a batch, which
the JAX package's metrics copy to the host whole.  The others read numpy
copies, as in the JAX package.  Numeric rules are the JAX package's: the
``1e-10`` floor and ``ignore_label`` of ``Perplexity``, the ``eps`` of
``CrossEntropy``, labels truncated to integers.
"""

from __future__ import annotations

import math

import numpy
import torch

from .base import string_types
from .ndarray import NDArray

__all__ = ["Accuracy", "CompositeEvalMetric", "CrossEntropy", "CustomMetric",
           "EvalMetric", "Loss", "MAE", "MSE", "Perplexity", "RMSE",
           "TopKAccuracy", "create", "np"]


def check_label_shapes(labels, preds, shape=0):
    got = (len(labels), len(preds)) if shape == 0 else (labels.shape,
                                                        preds.shape)
    if got[0] != got[1]:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % got)


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def _paired(labels, preds, check=True):
    """(label, pred) numpy pairs, length-checked once up front."""
    if check:
        check_label_shapes(labels, preds)
    for label, pred in zip(labels, preds):
        yield _as_numpy(label), _as_numpy(pred)


def _on_device(labels, preds, check=True):
    """(label, pred) tensor pairs, the label moved to the prediction's
    device (the prediction never leaves it)."""
    if check:
        check_label_shapes(labels, preds)
    for label, pred in zip(labels, preds):
        p = pred._data if isinstance(pred, NDArray) else torch.as_tensor(
            numpy.asarray(pred))
        lab = label._data if isinstance(label, NDArray) else torch.as_tensor(
            numpy.asarray(label))
        yield lab.detach().to(p.device), p.detach()


class EvalMetric(object):
    """Base metric: ``sum_metric`` over ``num_inst``."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, label, pred):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    @staticmethod
    def _ratio(total, count):
        return total / count if count != 0 else float("nan")

    def get(self):
        if self.num is None:
            return (self.name, self._ratio(self.sum_metric, self.num_inst))
        return (["%s_%d" % (self.name, i) for i in range(self.num)],
                [self._ratio(x, y) for x, y in zip(self.sum_metric,
                                                   self.num_inst)])

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Several metrics at once."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError("Metric index {} is out of range 0 and {}"
                             .format(index, len(self.metrics)))
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, string_types):
                name, value = [name], [value]
            names.extend(name)
            results.extend(value)
        return (names, results)


class Accuracy(EvalMetric):
    def __init__(self, axis=1):
        super().__init__("accuracy")
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in _on_device(labels, preds):
            if pred.shape != label.shape:
                pred = pred.argmax(dim=self.axis)
            check_label_shapes(label, pred)
            hits = (pred.to(torch.int32).reshape(-1)
                    == label.to(torch.int32).reshape(-1))
            self.sum_metric += int(hits.sum().item())
            self.num_inst += hits.numel()


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        for label, pred in _paired(labels, preds):
            assert pred.ndim <= 2, "Predictions should be no more than 2 dims"
            check_label_shapes(label, pred)
            truth = label.astype("int32")
            if pred.ndim == 1:
                hit = numpy.equal(pred.astype("int32"), truth)
            else:
                k = min(self.top_k, pred.shape[1])
                top = numpy.argpartition(pred.astype("float32"), -k,
                                         axis=1)[:, -k:]
                hit = numpy.any(top == truth.reshape(-1, 1), axis=1)
            self.sum_metric += int(hit.sum())
            self.num_inst += hit.shape[0]


class Perplexity(EvalMetric):
    """``exp`` of the mean negative log-probability of the labels, each
    probability floored at ``1e-10``; labels equal to ``ignore_label``
    count as probability 1 and not as instances."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        for label, pred in _on_device(labels, preds, check=False):
            if self.axis not in (-1, pred.dim() - 1):
                pred = pred.movedim(self.axis, -1)
            flat = pred.reshape(-1, pred.shape[-1])
            idx = label.reshape(-1).to(torch.int64)
            assert idx.numel() == flat.shape[0], (
                "shape mismatch: %s vs. %s" % (tuple(label.shape),
                                               tuple(pred.shape)))
            picked = flat.gather(1, idx[:, None])[:, 0]
            count = idx.numel()
            if self.ignore_label is not None:
                keep = idx != self.ignore_label
                picked = torch.where(keep, picked, torch.ones_like(picked))
                count -= int((~keep).sum().item())
            nll = torch.log(torch.clamp(picked, min=1e-10)).double().sum()
            self.sum_metric -= float(nll.item())
            self.num_inst += count

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class _PerBatchRegression(EvalMetric):
    """Shared shape handling of the elementwise regression metrics."""

    def update(self, labels, preds):
        for label, pred in _paired(labels, preds):
            if label.ndim == 1:
                label = label.reshape(-1, 1)
            self.sum_metric += self._score(label, pred)
            self.num_inst += 1


class MAE(_PerBatchRegression):
    def __init__(self):
        super().__init__("mae")

    def _score(self, label, pred):
        return float(numpy.mean(numpy.abs(label - pred)))


class MSE(_PerBatchRegression):
    def __init__(self):
        super().__init__("mse")

    def _score(self, label, pred):
        return float(numpy.mean(numpy.square(label - pred)))


class RMSE(_PerBatchRegression):
    def __init__(self):
        super().__init__("rmse")

    def _score(self, label, pred):
        return float(numpy.sqrt(numpy.mean(numpy.square(label - pred))))


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in _on_device(labels, preds):
            idx = label.reshape(-1).to(torch.int64)
            assert idx.shape[0] == pred.shape[0]
            picked = pred.gather(1, idx[:, None])[:, 0]
            self.sum_metric += float(
                (-torch.log(picked + self.eps)).double().sum().item())
            self.num_inst += idx.numel()


class Loss(EvalMetric):
    """Mean of the raw outputs (for loss-headed nets)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += numpy.sum(pred.asnumpy())
            self.num_inst += pred.size


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    sum or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            out = self._feval(_as_numpy(label), _as_numpy(pred))
            total, count = out if isinstance(out, tuple) else (out, 1)
            self.sum_metric += total
            self.num_inst += count


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A numpy eval function as a metric."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_METRIC_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy, "mae": MAE, "mse": MSE, "rmse": RMSE, "top_k_accuracy": TopKAccuracy,
    "perplexity": Perplexity, "loss": Loss,
}


def create(metric, **kwargs):
    """A metric by name, from a callable, or a composite from a list."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    try:
        return _METRIC_REGISTRY[metric.lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable or in {}".format(
            sorted(_METRIC_REGISTRY)))
