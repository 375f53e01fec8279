"""Where the time of the bf16 flash forward goes, on one card: this
checkout's ``csrc/flash_fwd_bf16_sm90.cu`` beside two cut-down builds of it
and the first bf16 forward (``_v1``).

    python3 -m mxnet_tpu_torch.tools.flash_fwd_bf16_ab [--other DIR]

Builds (nvcc with this checkout's flags, into ``build/flash_fwd_bf16_ab/``):

- ``as is``: the source unchanged;
- ``products only``: every wgmma kept, the softmax between them (mask, max,
  exponentials, sums, O's rescale, bf16 fragments) replaced by a bit copy
  of S's fp32 results into the P fragments;
- ``elementwise only``: every wgmma removed (S filled by a cheap function
  of the thread and the tile, the P fragments consumed by an empty asm),
  the softmax and O's rescale kept;
- with ``--other DIR``, another checkout's source (for example a ``git
  archive`` of the parent commit under ``build/``).

The cut-down builds compute nothing useful; their patches are asserted to
apply, so an edit of the source that moves the patched lines fails here
first.  For each build the tool prints ptxas's wgmma-serialization lines
(C75xx) and each kernel's registers and spills, whether its o and lse
equal the ``_v1`` kernel's bits, and its device time in turns with the
``_v1`` kernel (v1, build, build, v1; CUDA-graph replay of 10 launches) at
the bench LM's training shape: B 8, 16 heads, T 2048, D 64, causal, with
lse.  When the forward overlaps its products with its softmax, the whole
takes less than products alone plus elementwise alone.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

from ..ops import _build
from ..ops.fused import attention_kernels as ak
from .flash_bwd_ab import _graph_ms
from .flash_bwd_bf16_ab import _HELPERS, _compile, _patched

__all__ = ["builds", "in_turns", "main"]

_SOURCE = "flash_fwd_bf16_sm90.cu"
_PRODUCTS_ONLY = [
    _HELPERS,
    ("        softmax_tile(s, kBK > tk_len || (causal && kBK - 1 > qg), 0, row0, row1, c, "
     "tk_len,\n                     causal, sl2, m0, m1, l0, l1, alpha0, alpha1);\n"
     "        to_frags<kBK>(s, pa);\n",
     "        bits_frags<kBK>(s, pa);\n"),
    ("        softmax_tile(s, k0 + kBK > tk_len || (causal && k0 + kBK - 1 > qg), k0, row0, "
     "row1,\n                     c, tk_len, causal, sl2, m0, m1, l0, l1, alpha0, alpha1);\n",
     "        alpha0 = alpha1 = 1.f;\n"),
    ("        to_frags<kBK>(s, pa);\n        if (leader)",
     "        bits_frags<kBK>(s, pa);\n        if (leader)")]
_ELEMENTWISE_ONLY = [
    _HELPERS,
    ("        product_ss<D, kBK>(s, qt, kRes, cw * 64, kst + st * kTile);\n",
     "        fake(s, tid);\n"),
    ("        product_ss<D, kBK>(s, qt, kRes, cw * 64, kst + s_next * kTile);\n",
     "        fake(s, tid + it);\n"),
    ("        product_rs<D, kBK>(acc, pa, vst + s_cur * kTile);\n", "        consume(pa);\n"),
    ("        product_rs<D, kBK>(acc, pa, vst + s_last * kTile);\n",
     "        consume(pa);\n")]


def builds(other=None):
    """``{label: source text}`` of the builds the tool times."""
    with open(os.path.join(_build.CSRC_DIR, _SOURCE)) as f:
        src = f.read()
    out = {"as is": src,
           "products only": _patched(src, _PRODUCTS_ONLY, _SOURCE),
           "elementwise only": _patched(src, _ELEMENTWISE_ONLY, _SOURCE)}
    if other:
        with open(os.path.join(other, "mxnet_tpu_torch", "csrc", _SOURCE)) as f:
            out["other"] = f.read()
    return out


def in_turns(libs, shape=(8, 16, 2048, 64)):
    """Each library's ``mxtpu_flash_fwd_bf16`` on one seeded causal input
    of ``shape`` (B, H, T, D): prints whether its o and lse equal the
    ``_v1`` kernel's bits and its device ms in turns with ``_v1``; returns
    ``{label: (ms, v1 ms)}``."""
    dev = torch.device("cuda", 0)
    b, h, t, d = shape
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(
        dev).to(torch.bfloat16) for _ in range(3))
    o, lse = torch.empty_like(q), torch.empty(b, h, t, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, t, t, d, 1, 1.0 / d ** 0.5)

    def v1(_i=0):
        ak.FLASH_FWD_BF16_V1.launch(dev, *args)

    v1()
    want = (o.clone(), lse.clone())
    out = {}
    for label, lib in libs.items():
        fn = lib.mxtpu_flash_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(_i=0, fn=fn):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError("launch failed: %d" % rc)

        run()
        torch.cuda.synchronize()
        same = bool(torch.equal(o, want[0]) and torch.equal(lse, want[1]))
        old, new = _graph_ms(v1), _graph_ms(run)
        new, old = (new + _graph_ms(run)) / 2, (old + _graph_ms(v1)) / 2
        print("  [%s] forward %.4f ms (v1 %.4f); o and lse equal v1's bits: %s"
              % (label, new, old, same))
        out[label] = (new, old)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="root of another checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_bf16_ab: no CUDA device")
    print("device %s" % torch.cuda.get_device_name(0))
    libs = _compile(builds(args.other), "flash_fwd_bf16_ab", r"flash_fwd_bf16_kernel")
    ms = in_turns(libs)
    if "products only" in ms and "elementwise only" in ms:
        print("  whole %.4f ms against products alone + elementwise alone %.4f + %.4f = "
              "%.4f ms" % (ms["as is"][0], ms["products only"][0], ms["elementwise only"][0],
                           ms["products only"][0] + ms["elementwise only"][0]))


if __name__ == "__main__":
    main()
