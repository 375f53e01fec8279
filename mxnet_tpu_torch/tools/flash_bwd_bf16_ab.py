"""Where the time of the bf16 flash backward pair goes, on one card: this
checkout's ``csrc/flash_bwd_bf16_sm90.cu`` beside two cut-down builds of it
and the first bf16 pair (``_v1``).

    python3 -m mxnet_tpu_torch.tools.flash_bwd_bf16_ab [--other DIR]

Builds (nvcc with this checkout's flags, into ``build/flash_bwd_bf16_ab/``):

- ``as is``: the source unchanged;
- ``products only``: every wgmma kept, the elementwise work between them
  (exponentials, masks, dS, bf16 fragments) replaced by a bit copy of the
  products' fp32 results, which the compiler then drops;
- ``elementwise only``: every wgmma removed (S and dP filled by a cheap
  function of the thread and the tile, the fragments consumed by an empty
  asm), the elementwise work kept;
- with ``--other DIR``, another checkout's source (for example a ``git
  archive`` of the parent commit under ``build/``).

The cut-down builds compute nothing useful; their patches are asserted to
apply, so an edit of the source that moves the patched lines fails here
first.  For each build the tool prints ptxas's wgmma-serialization lines
(C75xx) and each kernel's registers and spills, whether its dq, dk and dv
equal the ``_v1`` pair's bits (the kernels round where the first pair
rounds), and both passes' device times
in turns with the ``_v1`` pair (v1, build, build, v1; CUDA-graph replay of
10 launches) at the bench LM's training shape: B 8, 16 heads, T 2048, D 64,
causal.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops.fused import attention_kernels as ak
from .flash_bwd_ab import _graph_ms

__all__ = ["builds", "main"]

_SOURCE = "flash_bwd_bf16_sm90.cu"
_HELPERS = ("using namespace mxtpu;\n", """using namespace mxtpu;

template <int N>
__device__ __forceinline__ void bits_frags(const float* x, unsigned (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = __float_as_uint(x[8 * kk + 2 * j]);
}

__device__ __forceinline__ void consume(const unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[kk][j]));
}

__device__ __forceinline__ void fake(float* x, int seed) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = __int_as_float(0x3c000000 | ((seed * 31 + i * 7) & 0xffff));
}
""")


def _copy(name, src):
    return ("      float %s[kBS / 2];\n#pragma unroll\n      for (int i = 0; i < kBS / 2; "
            "++i) %s[i] = %s[i];\n" % (name, name, src))


_PRODUCTS_ONLY = [
    _HELPERS,
    ("      wgmma_wait_group<1>();  // S^T\n      reg_fence(st);\n",
     "      wgmma_wait_group<1>();  // S^T\n      reg_fence(st);\n" + _copy("raw_s", "st")),
    ("      wgmma_wait_group<0>();  // dP^T\n      reg_fence(dpt);\n",
     "      wgmma_wait_group<0>();  // dP^T\n      reg_fence(dpt);\n" + _copy("raw_d", "dpt")),
    ("      to_frags<kBS>(st, pa);\n", "      bits_frags<kBS>(raw_s, pa);\n"),
    ("      to_frags<kBS>(dpt, da);\n", "      bits_frags<kBS>(raw_d, da);\n"),
    ("      wgmma_wait_group<0>();  // dP\n      reg_fence(dp);\n",
     "      wgmma_wait_group<0>();  // dP\n      reg_fence(dp);\n" + _copy("raw_d", "dp")),
    ("      to_frags<kBS>(dp, da);\n", "      bits_frags<kBS>(raw_d, da);\n")]
_ELEMENTWISE_ONLY = [
    _HELPERS,
    ("      product_ss<kW, kBS>(st, kres, kRes, cw * 64, qs);\n      wgmma_commit();\n"
     "      product_ss<kW, kBS>(dpt, vres, kRes, cw * 64, dos);\n      wgmma_commit();\n",
     "      fake(st, tid + it);\n      fake(dpt, tid * 3 + it);\n"),
    ("      product_rs<D, kBS>(dva, pa, dos);\n      product_rs<D, kBS>(dka, da, qs);\n",
     "      consume(pa);\n      consume(da);\n"),
    ("      product_ss<kW, kBS>(st, qres, kRes, cw * 64, ks);\n      wgmma_commit();\n"
     "      product_ss<kW, kBS>(dp, dores, kRes, cw * 64, vst + s * kTile);\n"
     "      wgmma_commit();\n",
     "      fake(st, tid + it);\n      fake(dp, tid * 3 + it);\n"),
    ("      product_rs<D, kBS>(dqa, da, ks);\n", "      consume(da);\n")]


def _patched(src, patches, name=_SOURCE):
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError("patch does not apply to %s: %r" % (name, old[:60]))
        src = src.replace(old, new)
    return src


def builds(other=None):
    """``{label: source text}`` of the builds the tool times."""
    with open(os.path.join(_build.CSRC_DIR, _SOURCE)) as f:
        src = f.read()
    out = {"as is": src, "products only": _patched(src, _PRODUCTS_ONLY),
           "elementwise only": _patched(src, _ELEMENTWISE_ONLY)}
    if other:
        with open(os.path.join(other, "mxnet_tpu_torch", "csrc", _SOURCE)) as f:
            out["other"] = f.read()
    return out


def _compile(sources, out_name="flash_bwd_bf16_ab", kernels=r"flash_bwd_\w+?_kernel"):
    """Build each source into its own library at once, under
    ``build/<out_name>/``; print ptxas's C75xx lines and the registers and
    spills of each kernel whose name matches ``kernels``; return ``{label:
    ctypes library}``."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), out_name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (label, src) in enumerate(sources.items()):
        path = os.path.join(out_dir, "build%d.cu" % i)
        with open(path, "w") as f:
            f.write(src)
        procs[label] = (path[:-3] + ".so", subprocess.Popen(
            [_build._nvcc()] + _build._NVCC_FLAGS + ["-I", _build.CSRC_DIR, "-o",
                                                     path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on the %s build:\n%s" % (label, log[-4000:]))
        warnings = [re.sub(r" in the function.*", "", line.strip())
                    for line in log.splitlines() if re.search(r"\(C75\d\d\)", line)]
        print("  [%s] ptxas: %s" % (label, "; ".join(sorted(set(warnings)))
                                    or "no wgmma serialization"))
        kernel = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '\w*?(%s)(?:ILi(\d+)E)?"
                              % kernels, line)
            if entry:
                kernel = entry.group(1) + ("<%s>" % entry.group(2)
                                           if entry.group(2) else "")
            elif kernel and ("spill" in line or "registers" in line):
                print("    %s: %s" % (kernel, line.split(":", 1)[-1].strip()))
        libs[label] = ctypes.CDLL(so)
    return libs


def _pair(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    kv, q = lib.mxtpu_flash_bwd_dkdv_bf16, lib.mxtpu_flash_bwd_dq_bf16
    kv.argtypes = [p] * 8 + [i] * 6 + [f, p]
    q.argtypes = [p] * 7 + [i] * 6 + [f, p]
    kv.restype = q.restype = ctypes.c_int
    return kv, q


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="root of another checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_bf16_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    print("device %s" % torch.cuda.get_device_name(0))
    libs = _compile(builds(args.other))

    b, h, t, d = 8, 16, 2048, 64
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(
        dev).to(torch.bfloat16) for _ in range(4))
    o, lse = ak.fused_flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    dims = (b, h, t, t, d, 1, 1.0 / d ** 0.5)
    grads = [torch.empty_like(q) for _ in range(3)]   # dq, dk, dv

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def launcher(fn, n_out):
        outs = [g.data_ptr() for g in (grads[1:] if n_out == 2 else grads[:1])]

        def run(_i=0):
            rc = fn(*ptrs, *outs, *dims, stream())
            if rc:
                raise RuntimeError("launch failed: %d" % rc)
        return run

    def v1_launcher(kern, n_out):
        outs = [g.data_ptr() for g in (grads[1:] if n_out == 2 else grads[:1])]
        return lambda _i=0: kern.launch(dev, *ptrs, *outs, *dims)

    v1_kv = v1_launcher(ak.FLASH_BWD_DKDV_BF16_V1, 2)
    v1_q = v1_launcher(ak.FLASH_BWD_DQ_BF16_V1, 1)
    v1_kv()
    v1_q()
    want = [g.clone() for g in grads]
    for label, lib in libs.items():
        kv_fn, q_fn = _pair(lib)
        kv, qq = launcher(kv_fn, 2), launcher(q_fn, 1)
        kv()
        qq()
        torch.cuda.synchronize()
        same = [bool(torch.equal(g, w)) for g, w in zip(grads, want)]
        kv_old, kv_new = _graph_ms(v1_kv), _graph_ms(kv)
        kv_new, kv_old = (kv_new + _graph_ms(kv)) / 2, (kv_old + _graph_ms(v1_kv)) / 2
        q_old, q_new = _graph_ms(v1_q), _graph_ms(qq)
        q_new, q_old = (q_new + _graph_ms(qq)) / 2, (q_old + _graph_ms(v1_q)) / 2
        print("  [%s] dK/dV %.4f ms (v1 %.4f), dQ %.4f ms (v1 %.4f), pair %.4f ms "
              "(v1 %.4f); dq, dk, dv equal v1's bits: %s"
              % (label, kv_new, kv_old, q_new, q_old, kv_new + q_new, kv_old + q_old, same))


if __name__ == "__main__":
    main()
