"""Launch shapes of the per-op SGD-momentum step on one card: the kernel
built at each block size and unroll, beside its first design, at the bench
LM's parameter sizes.

    python3 -m mxnet_tpu_torch.tools.sgd_mom_ab [--rounds 4]

``csrc/optimizer_kernels.cu`` launches the one-tensor step
(``mxtpu_sgd_mom_update``) with three constants: threads a block
(``kPerOpThreads``), float4 groups each thread loads before it computes
(``kPerOpUnroll``) and programmatic dependent launch on or off
(``kPerOpPdl``).  The tool builds a copy of the source for each pair
(threads 128, 256, 512; unroll 1, 2, 4, 8) without it and for each with
unroll below 8 with it, 21 builds, with nvcc and this checkout's flags,
into ``build/sgd_mom_ab/``, all at once, and prints each build's
registers and spills.  Each build's grid is ``_per_op_grid`` with its own
elements a block and its own occupancy.  It first holds every build and the
first design (``_v1``) bit for bit against ``sgd_mom_update_plain``, into
outputs that a fill kernel has just written, at
n 1, 3, 255, 1023 and 65537, with the five tensors aligned, all 4 bytes
past 16-byte alignment (the scalar head) and with g alone 4 bytes off (the
scalar path).  Then, at each parameter size of the bench LM (12 layers,
d1024, vocab 32000: 126 tensors in 8 sizes), it times every build, this
checkout's library as built, ``_v1``, this checkout's kernel on one block
(sizes of at most 64K elements) and ``zero_()`` of a one-element tensor
(the launch floor) in turns: each round times every function once, in
order on even rounds and in reverse on odd ones, and each time is the mean
of its rounds (CUDA-graph replay of 50 launches, in place, each on its own
region of 1.2 GB of buffers, so the tensors come from device memory as
they do in a step, not from the 50 MB L2).  Last, the sum over the 126
tensors, one launch each, in turns.  The bound is 20 bytes an element
over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re

import torch

from ..ops import _build
from ..ops.fused import optimizer_kernels as ok_
from .flash_bwd_bf16_ab import _compile
from .lm_layer_norm_ab import in_turns

__all__ = ["LM_SIZES", "SHAPES", "builds", "check", "cold_launch", "main",
           "sweep"]

# (threads a block, float4 groups a thread, programmatic dependent launch)
SHAPES = [(t, u, pdl) for pdl in (False, True) for t in (128, 256, 512)
          for u in (1, 2, 4, 8) if not pdl or u < 8]
# {elements: tensors} of the bench LM's 126 parameters
LM_SIZES = {32000 * 1024: 2, 4096 * 1024: 24, 3072 * 1024: 12,
            2048 * 1024: 1, 1024 * 1024: 12, 32000: 1, 4096: 12, 1024: 62}
ATTRS = {"lr": 1e-3, "wd": 1e-4, "momentum": 0.9,
         "rescale_grad": 1.0 / 16384, "clip_gradient": -1.0}
ITERS = 50
PEAK_BYTES_PER_S = 3.35e12
_SOURCE = "optimizer_kernels.cu"
_CONSTS = re.compile(r"constexpr int kPerOpThreads = \d+;\n"
                     r"constexpr int kPerOpUnroll = \d+;\n"
                     r"((?://.*\n)*)constexpr bool kPerOpPdl = \w+;\n")
_P = ctypes.c_void_p
_F = ctypes.c_float


def _label(shape):
    return "T%d U%d%s" % (shape[0], shape[1], " PDL" if shape[2] else "")


def builds():
    """``{label: source text}``: this checkout's source at each shape."""
    with open(os.path.join(_build.CSRC_DIR, _SOURCE)) as f:
        src = f.read()
    if len(_CONSTS.findall(src)) != 1:
        raise RuntimeError("%s: the per-op launch constants were not found"
                           % _SOURCE)
    return {_label(s): _CONSTS.sub(
        lambda mo, s=s: "constexpr int kPerOpThreads = %d;\nconstexpr int "
        "kPerOpUnroll = %d;\n%sconstexpr bool kPerOpPdl = %s;\n"
        % (s[0], s[1], mo.group(1), "true" if s[2] else "false"), src)
        for s in SHAPES}


class _Lib(object):
    """One library's per-op entries on ``dev``: ``run(w, g, m, wo, mo,
    grid=None)`` launches the step (on this build's grid unless given),
    ``v1(...)`` the first design."""

    def __init__(self, lib, elems, dev):
        self.fn = lib.mxtpu_sgd_mom_update
        self.fn.argtypes = [_P] * 5 + [ctypes.c_longlong, ctypes.c_uint] \
            + [_F] * 5 + [_P]
        self.fn.restype = ctypes.c_int
        self.fn_v1 = lib.mxtpu_sgd_mom_update_v1
        self.fn_v1.argtypes = [_P] * 5 + [ctypes.c_longlong] + [_F] * 5 + [_P]
        self.fn_v1.restype = ctypes.c_int
        occ = lib.mxtpu_sgd_mom_update_blocks_per_sm
        occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        per_sm = ctypes.c_int(0)
        if occ(ctypes.byref(per_sm)) or per_sm.value < 1:
            raise RuntimeError("occupancy query failed")
        self.per_sm = per_sm.value
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.elems = elems
        self.scalars = ok_._scalars(ATTRS)

    def run(self, w, g, m, wo, mo, grid=None):
        n = w.numel()
        if grid is None:
            grid = ok_._per_op_grid(n, self.sms, self.per_sm, self.elems)
        rc = self.fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), wo.data_ptr(),
                     mo.data_ptr(), n, grid, *self.scalars,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("launch refused: %d" % rc)

    def v1(self, w, g, m, wo, mo):
        rc = self.fn_v1(w.data_ptr(), g.data_ptr(), m.data_ptr(),
                        wo.data_ptr(), mo.data_ptr(), w.numel(), *self.scalars,
                        torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("launch refused: %d" % rc)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check(libs, dev):
    """Every build and ``_v1`` bit for bit against the plain version, out of
    place; raises on the first difference."""
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = {label: lib.run for label, lib in libs.items()}
    runs["v1"] = libs["as built"].v1
    for n in (1, 3, 255, 1023, 65537):
        for offs in ((0, 0, 0, 0, 0), (1, 1, 1, 1, 1), (0, 1, 0, 0, 0)):
            w, g, m = (torch.randn(n + 4, device=dev, generator=gen)[o:o + n]
                       for o in offs[:3])
            want = ok_.sgd_mom_update_plain(ATTRS, w, g, m)
            for label, run in runs.items():
                wo, mo = (torch.full((n + 4,), float("nan"),
                                     device=dev)[o:o + n] for o in offs[3:])
                run(w, g, m, wo, mo)
                torch.cuda.synchronize()
                if not (_bits_equal(wo, want[0]) and _bits_equal(mo, want[1])):
                    raise RuntimeError("%s differs from the plain version at "
                                       "n %d, offsets %s" % (label, n, offs))
    print("  every build and v1 bitwise equal to the plain version at n 1, 3, "
          "255, 1023, 65537, aligned, head-peeled and g misaligned")


def cold_launch(run, buffers, n):
    """A no-argument launch of ``run(w, g, m, w_out, m_out)`` in place over
    ``n`` elements that takes the next region of the three flat
    ``buffers`` at each call, so that launches captured into one CUDA graph
    read device memory, not what the one before left in L2."""
    stride = -(-n // 64) * 64
    regions = max(1, (buffers[0].numel() - n) // stride + 1)
    at = itertools.count()

    def launch():
        o = next(at) % regions * stride
        w, g, m = (x[o:o + n] for x in buffers)
        run(w, g, m, w, m)
    return launch


def sweep(libs, dev, rounds=4):
    """Time every build, ``_v1`` and the floor at each LM size, then the
    126-tensor sum; prints a table a size."""
    gen = torch.Generator(device=dev).manual_seed(1)
    buffers = [torch.randn(3 * 32000 * 1024, device=dev, generator=gen)
               for _ in range(3)]
    one = torch.zeros(1, device=dev)
    built = libs["as built"]
    for n in sorted(LM_SIZES, reverse=True):
        fns = {label: cold_launch(lib.run, buffers, n)
               for label, lib in libs.items()}
        fns["v1"] = cold_launch(built.v1, buffers, n)
        if n <= 1 << 16:
            fns["one block"] = cold_launch(
                lambda *a: built.run(*a, grid=1), buffers, n)
        fns["zero_ (floor)"] = one.zero_
        ms = in_turns(fns, rounds, ITERS)
        bound = 20 * n / PEAK_BYTES_PER_S * 1e3
        us = {k: v * 1e3 for k, v in ms.items()}
        order = sorted((_label(s) for s in SHAPES), key=us.get)
        print("  n %d (x%d) us: bound %.2f; floor %.2f; v1 %.2f; as built "
              "%.2f (%.0f%% of the bound)%s; best %s %.2f"
              % (n, LM_SIZES[n], bound * 1e3, us["zero_ (floor)"], us["v1"],
                 us["as built"], 100 * bound / ms["as built"],
                 "; one block %.2f" % us["one block"] if "one block" in us
                 else "", order[0], us[order[0]]))
        print("    " + "; ".join("%s %.2f" % (k, us[k]) for k in order))
    del buffers
    tensors = [[torch.randn(n, device=dev, generator=gen) for _ in range(3)]
               for n, k in LM_SIZES.items() for _ in range(k)]

    def total(run):
        return lambda: [run(w, g, m, w, m) for w, g, m in tensors]

    fns = {label: total(lib.run) for label, lib in libs.items()}
    fns["v1"] = total(built.v1)
    ms = in_turns(fns, rounds, 3)
    nb = 20 * sum(n * k for n, k in LM_SIZES.items()) / PEAK_BYTES_PER_S * 1e3
    order = sorted((_label(s) for s in SHAPES), key=ms.get)
    print("  the 126 tensors, one launch each, ms: bound %.4f; v1 %.4f; as "
          "built %.4f (%.0f%% of the bound)"
          % (nb, ms["v1"], ms["as built"], 100 * nb / ms["as built"]))
    print("    " + "; ".join("%s %.4f" % (k, ms[k]) for k in order))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgd_mom_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    print("device %s" % torch.cuda.get_device_name(0))
    built = _compile(builds(), "sgd_mom_ab", "sgd_mom_update_kernel")
    libs = {label: _Lib(lib, t * 4 * u, dev)
            for (label, lib), (t, u, _) in zip(built.items(), SHAPES)}
    libs["as built"] = _Lib(_build.load("optimizer_kernels"),
                            ok_._PER_OP_ELEMS, dev)
    for label, lib in libs.items():
        print("  [%s] %d blocks an SM, %d SMs" % (label, lib.per_sm, lib.sms))
    check(libs, dev)
    sweep(libs, dev, args.rounds)


if __name__ == "__main__":
    main()
