"""Launch shapes of the LM layer norm on one card: its row-resident kernel
built at every shape, beside its first design and ``F.layer_norm``, at each
row count the generation lane gives it.

    python3 -m mxnet_tpu_torch.tools.lm_layer_norm_ab [--other DIR]

``csrc/norm_kernels.cu`` launches the LM layer norm at one shape, three
constants: W warps a row (``kLmWarpsPerRow``), R rows a block
(``kLmRowsPerBlock``) and gamma/beta loaded beside x or after the
statistics (``kLmEarly``).  The tool builds a copy of the source for each
of the 20 shapes (W 1, 2, 4, 8; R 1, 2, 4, 8 within 256 threads; early or
late) with nvcc and this checkout's flags, into ``build/lm_layer_norm_ab/``,
all at once.  It first holds every build's ``mxtpu_lm_layer_norm``, this
checkout's own library and the first design (``_v1``) against
``lm_layer_norm_plain`` at 2e-5 abs + rel, at C 1024, 1000 and 64 (ragged
groups, warps that hold no vector).  Then, at C 1024 (the bench LM's
width) and rows 1-8 (a decode step's buckets) and 64-512 (the prefill
buckets), it times all of them, ``F.layer_norm`` and ``zero_()`` of a
one-element tensor (the least time of any launch: the floor) in turns:
each round times every function once, in order on even rounds and in
reverse on odd ones, and each time is the mean of its rounds (CUDA-graph
replay of 200 launches).  The bound is the rows' bytes (x read, y written,
gamma and beta read) over 3.35 TB/s.

With ``--other DIR`` (the root of another checkout, for example a ``git
archive`` of the parent commit under ``build/``) it also builds that
checkout's ``norm_kernels.cu`` and times its ``mxtpu_lm_layer_norm`` and
``mxtpu_layer_norm_op`` (the LayerNorm op at the bench LM's training
shape [8 * 2048, 1024], fp32 and bf16) in turns with this checkout's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.fused import norm_kernels as nk
from .flash_bwd_ab import _graph_ms
from .flash_bwd_bf16_ab import _compile

__all__ = ["SHAPES", "builds", "check", "in_turns", "main", "sweep"]

ROWS = (1, 2, 4, 8, 64, 128, 256, 512)
COLS = 1024
# (warps a row, rows a block, gamma/beta early)
SHAPES = [(w, r, e) for e in (True, False) for w in (1, 2, 4, 8)
          for r in (1, 2, 4, 8) if 32 * w * r <= 256]
TOL = 2e-5
ITERS = 200
PEAK_BYTES_PER_S = 3.35e12
_SOURCE = "norm_kernels.cu"
_SHAPE_LINES = re.compile(r"constexpr int kLmWarpsPerRow = \d+;\n"
                          r"constexpr int kLmRowsPerBlock = \d+;\n"
                          r"constexpr bool kLmEarly = \w+;\n")
_P = ctypes.c_void_p


def _label(shape):
    w, r, e = shape
    return "W%d R%d %s" % (w, r, "early" if e else "late")


def builds(other=None):
    """``{label: source text}``: this checkout's source at each shape, and
    with ``other`` that checkout's source as it is."""
    with open(os.path.join(_build.CSRC_DIR, _SOURCE)) as f:
        src = f.read()
    if len(_SHAPE_LINES.findall(src)) != 1:
        raise RuntimeError("%s: the LM layer norm's launch shape constants "
                           "were not found" % _SOURCE)
    out = {_label(s): _SHAPE_LINES.sub(
        "constexpr int kLmWarpsPerRow = %d;\nconstexpr int kLmRowsPerBlock = "
        "%d;\nconstexpr bool kLmEarly = %s;\n"
        % (s[0], s[1], "true" if s[2] else "false"), src) for s in SHAPES}
    if other:
        with open(os.path.join(other, "mxnet_tpu_torch", "csrc", _SOURCE)) as f:
            out["other"] = f.read()
    return out


def _bind(lib, names=("mxtpu_lm_layer_norm",)):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def _runner(fn, *args):
    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("launch refused: %d" % rc)
    return run


def _functions(libs, x, g, b, y):
    """``{label: no-argument launch}`` of each shape's build, this
    checkout's library (``"as built"``) and ``_v1`` on ``x [rows, C]``
    into ``y``."""
    rows, cols = x.shape
    ptrs = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, cols,
            1e-5)
    out = {_label(s): _runner(libs[_label(s)].mxtpu_lm_layer_norm, *ptrs)
           for s in SHAPES}
    out["as built"] = _runner(libs["as built"].mxtpu_lm_layer_norm, *ptrs)
    out["v1"] = _runner(libs["as built"].mxtpu_lm_layer_norm_v1, *ptrs)
    return out


def _inputs(rows, cols, dev, seed):
    rng = np.random.RandomState(seed)
    x, g, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
               for s in ((rows, cols), (cols,), (cols,)))
    return x, g, b


def check(libs, dev):
    """Every build, this checkout's library and ``_v1`` against the plain
    version; raises on the first disagreement; returns the largest share
    of the gate."""
    worst = 0.0
    for cols in (COLS, 1000, 64):
        for rows in (1, 3, 8, 64, 512):
            x, g, b = _inputs(rows, cols, dev, rows * cols)
            want = nk.lm_layer_norm_plain(x, g, b)
            y = torch.empty_like(x)
            for label, run in _functions(libs, x, g, b, y).items():
                y.fill_(float("nan"))
                run()
                torch.cuda.synchronize()
                share = ((y - want).abs() / (TOL + TOL * want.abs())).max().item()
                if not share <= 1.0:
                    raise RuntimeError("%s at [%d, %d]: share of the gate %.3f"
                                       % (label, rows, cols, share))
                worst = max(worst, share)
    print("  every shape, this checkout's library and v1 at C 1024, 1000, 64 "
          "and rows 1-512: "
          "largest share of the %.0e gate %.3f" % (TOL, worst))
    return worst


def in_turns(fns, rounds=4, iters=ITERS):
    """Device ms of each of ``fns``: every round times each once, in order
    on even rounds and in reverse on odd ones; the mean of the rounds."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(_graph_ms(fns[k], iters))
    return {k: float(np.mean(v)) for k, v in times.items()}


def sweep(libs, dev, rows_list=ROWS, cols=COLS, rounds=4):
    """Time every function at each row count; prints a table a row count
    and returns ``{rows: {label: ms}}``."""
    one = torch.zeros(1, device=dev)
    out = {}
    for rows in rows_list:
        x, g, b = _inputs(rows, cols, dev, rows)
        y = torch.empty_like(x)
        fns = _functions(libs, x, g, b, y)
        fns["F.layer_norm"] = lambda: F.layer_norm(x, (cols,), g, b, eps=1e-5)
        fns["zero_ (floor)"] = one.zero_
        ms = in_turns(fns, rounds)
        nbytes = (2 * rows * cols + 2 * cols) * 4
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        shapes = sorted((_label(s) for s in SHAPES), key=ms.get)
        us = {k: v * 1e3 for k, v in ms.items()}
        print("  [%d, %d] us: bound %.2f; floor %.2f; v1 %.2f; as built %.2f; "
              "F.layer_norm %.2f; best %s %.2f"
              % (rows, cols, bound * 1e3, us["zero_ (floor)"], us["v1"],
                 us["as built"], us["F.layer_norm"], shapes[0],
                 us[shapes[0]]))
        print("    " + "; ".join("%s %.2f" % (k, us[k]) for k in shapes))
        out[rows] = dict(ms, bound=bound)
    return out


def against_other(lib, other, dev, rounds=4):
    """This checkout's LM layer norm and LayerNorm op against another's, in
    turns, at the lane's two largest shapes and the training shape."""
    for rows in (8, 512):
        x, g, b = _inputs(rows, COLS, dev, rows)
        y = torch.empty_like(x)
        ptrs = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
                COLS, 1e-5)
        ms = in_turns({"this": _runner(lib.mxtpu_lm_layer_norm, *ptrs),
                       "other": _runner(other.mxtpu_lm_layer_norm, *ptrs)},
                      rounds)
        print("  lm_layer_norm [%d, %d]: this %.5f ms, other %.5f ms"
              % (rows, COLS, ms["this"], ms["other"]))
    rows = 8 * 2048
    x, g, b = _inputs(rows, COLS, dev, 0)
    for name, code in (("float32", 0), ("bfloat16", 1)):
        xd = x.to(getattr(torch, name))
        y = torch.empty_like(xd)
        mean = torch.empty(rows, device=dev)
        rstd = torch.empty_like(mean)
        args = (xd.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), rows, COLS, 1e-5, code)
        fns = {}
        for label, l_ in (("this", lib), ("other", other)):
            fn = l_.mxtpu_layer_norm_op
            fn.argtypes = [_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
            fns[label] = _runner(fn, *args)
        fns["this"]()
        want = (y.clone(), mean.clone(), rstd.clone())
        fns["other"]()
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) for a, w in zip((y, mean, rstd), want))
        ms = in_turns(fns, rounds, 50)
        print("  layer_norm_op [%d, %d] %s: this %.5f ms, other %.5f ms; "
              "outputs bitwise equal: %s"
              % (rows, COLS, name, ms["this"], ms["other"], same))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="root of another checkout")
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_layer_norm_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    print("device %s" % torch.cuda.get_device_name(0))
    libs = {label: _bind(lib) for label, lib in _compile(
        builds(args.other), "lm_layer_norm_ab", "none").items()}
    libs["as built"] = _bind(_build.load("norm_kernels"), (
        "mxtpu_lm_layer_norm", "mxtpu_lm_layer_norm_v1"))
    check(libs, dev)
    sweep(libs, dev, rounds=args.rounds)
    if args.other:
        against_other(libs["as built"], libs["other"], dev, args.rounds)


if __name__ == "__main__":
    main()
