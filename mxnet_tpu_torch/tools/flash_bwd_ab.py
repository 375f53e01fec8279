"""A/B of the flash backward pair: this checkout's kernels against another
checkout's, on one card.

    python3 -m mxnet_tpu_torch.tools.flash_bwd_ab --other DIR

``DIR`` is the root of another checkout (for example a ``git archive`` of
the parent commit).  Its ``mxnet_tpu_torch/csrc/attention_kernels.cu`` is
built with this checkout's nvcc flags into ``DIR/build/flash_bwd_ab/`` and
loaded beside this checkout's library; both must export
``mxtpu_flash_bwd_dkdv`` and ``mxtpu_flash_bwd_dq`` with the arguments of
:mod:`mxnet_tpu_torch.ops.fused.attention_kernels`.  Both pairs get the
same q, k, v, dO (seeded normal, D 64, causal) and this checkout's forward
o and lse, and the tool prints:

- the largest error of each pair's dq, dk, dv against float64 gradients
  (the plain forward and backward in float64) at B 1, 16 heads, T 512,
  1024, 2048 and 4096, beside the fp32 plain version's own;
- each pair's device time at each ``--shapes`` entry (B,H,T), timed in
  turns (other, this, this, other; CUDA-graph replay of 10 launches).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import attention as att
from ..ops.fused import attention_kernels as ak

__all__ = ["build_other", "main"]

_SYMBOLS = (("mxtpu_flash_bwd_dkdv", 8), ("mxtpu_flash_bwd_dq", 7))


def build_other(root):
    """Build ``root``'s attention library; returns its two backward entry
    points as ctypes functions ``(dkdv, dq)``."""
    csrc = os.path.join(root, "mxnet_tpu_torch", "csrc")
    out_dir = os.path.join(root, "build", "flash_bwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "attention_kernels.so")
    cmd = [_build._nvcc()] + _build._NVCC_FLAGS + [
        "-I", csrc, "-o", lib_path, os.path.join(csrc, "attention_kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (root, proc.stdout
                                                       + proc.stderr))
    lib = ctypes.CDLL(lib_path)
    fns = []
    for symbol, nptr in _SYMBOLS:
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def _other_pair(fns):
    """``(q, k, v, o, lse, do) -> (dq, dk, dv)`` through the other
    checkout's entry points, as ``fused_flash_bwd`` calls this one's."""
    dkdv, dq_fn = fns

    def run(q, k, v, o, lse, do):
        b, h, t, d = q.shape
        delta = (do * o).sum(-1)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        dims = (b, h, t, t, d, 1, d ** -0.5)
        stream = torch.cuda.current_stream().cuda_stream
        rc = dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, stream)
        rc = rc or dq_fn(*ptrs, dq.data_ptr(), *dims, stream)
        if rc:
            raise RuntimeError("flash backward launch failed (%d)" % rc)
        return dq, dk, dv
    return run


def _inputs(b, h, t, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, 64).astype(np.float32))
                   .cuda() for _ in range(4))
    o, lse = ak.fused_flash_fwd(q, k, v, True)
    return q, k, v, o, lse, do


def _graph_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True)
    parser.add_argument("--shapes", nargs="*", default=["1,16,2048",
                                                        "8,16,2048"])
    args = parser.parse_args(argv)
    pairs = {"other": _other_pair(build_other(os.path.abspath(args.other))),
             "this": lambda *xs: ak.fused_flash_bwd(*xs, True)}
    for t in (512, 1024, 2048, 4096):
        q, k, v, o, lse, do = _inputs(1, 16, t, t)
        x64 = [x.double() for x in (q, k, v, do)]
        o64, lse64 = att.flash_fwd_plain(*x64[:3], True)
        want = att.flash_bwd_plain(*x64[:3], o64, lse64, x64[3], True)
        got = {"plain fp32": att.flash_bwd_plain(q, k, v, o, lse, do, True)}
        for name, run in pairs.items():
            got[name] = run(q, k, v, o, lse, do)
        for name, grads in got.items():
            print("[B=1 H=16 T=%d] %-10s against float64: dq %.3e, dk %.3e, "
                  "dv %.3e" % ((t, name) + tuple(
                      (g.double() - w).abs().max().item()
                      for g, w in zip(grads, want))))
        del x64, o64, lse64, want, got
    for shape in args.shapes:
        b, h, t = (int(x) for x in shape.split(","))
        xs = _inputs(b, h, t, 1)
        ms = {name: [] for name in pairs}
        for name in ("other", "this", "this", "other"):
            ms[name].append(_graph_ms(lambda: pairs[name](*xs)))
        print("[B=%d H=%d T=%d, causal, D 64] pair (with delta): other %.4f "
              "ms, this %.4f ms (in turns)" % (
                  b, h, t, sum(ms["other"]) / 2, sum(ms["this"]) / 2))


if __name__ == "__main__":
    main()
