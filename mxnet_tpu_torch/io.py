"""Data iterators (the JAX package's ``io.py``, its in-memory part).

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol, ``NDArrayIter``
over host arrays, and ``batch_arrays``.  ``NDArrayIter`` shuffles with the
same numpy draw as the JAX package (the global stream, or
``RandomState(seed)``), so one seed gives both packages the same batches,
and makes each batch on the current context.  The record-file, CSV and
prefetching iterators are a later slice.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "batch_arrays"]


def batch_arrays(batch, data_iter=None, input_names=None):
    """A ``DataBatch`` as ``(arrays, data_names)``: ``arrays`` maps input
    name → host numpy array (data, then labels, in descriptor order),
    ``data_names`` the names that came from ``provide_data``.  Descriptors
    come from the batch, else from ``data_iter``; with ``input_names``,
    names outside it are dropped."""
    ddescs = list(batch.provide_data
                  or getattr(data_iter, "provide_data", None) or [])
    ldescs = list(batch.provide_label
                  or getattr(data_iter, "provide_label", None) or [])
    arrays, data_names = {}, set()
    vals = list(batch.data or []) + list(batch.label or [])
    for i, (desc, v) in enumerate(zip(ddescs + ldescs, vals)):
        name = desc[0] if isinstance(desc, (tuple, list)) else desc.name
        if input_names is None or name in input_names:
            arrays[name] = (v.asnumpy() if hasattr(v, "asnumpy")
                            else _np.asarray(v))
            if i < len(ddescs):
                data_names.add(name)
    return arrays, data_names


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """An input's name and shape, with its dtype and layout."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch(object):
    """One batch: lists of data and label NDArrays, and the padding."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Inputs as a name-sorted list of ``(name, numpy array)``."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    return sorted((k, v.asnumpy() if isinstance(v, NDArray)
                   else _np.asarray(v)) for k, v in data.items())


class NDArrayIter(DataIter):
    """Batches of in-memory arrays; ``last_batch_handle`` ``pad`` (wrap
    to the start), ``discard`` or ``roll_over``."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            idx = _np.arange(self.num_data)
            (_np.random if seed is None
             else _np.random.RandomState(seed)).shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.data_list = [v for _, v in self.data] + [v for _, v in
                                                      self.label]
        self.num_source = len(self.data_list)
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    def _descs(self, source):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in source]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if (self.last_batch_handle == "roll_over"
                and self.cursor > self.num_data):
            self.cursor = -self.batch_size + (self.cursor - self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [array(v[self.cursor:end]) for _, v in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(_np.concatenate((v[self.cursor:], v[:pad]), axis=0))
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0
