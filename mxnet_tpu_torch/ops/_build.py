"""Build and load the port's CUDA kernels at first use.

Each ``mxnet_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` alone into
its own shared library with a plain C interface, loaded with
:mod:`ctypes`.  No PyTorch header is involved, so a build takes seconds.
The libraries go to ``build/mxnet_tpu_torch/`` beside the package, named
by a hash of the sources and flags, so an edited source never loads a
stale binary and an unchanged one is not rebuilt.  All missing libraries
compile at once, one ``nvcc`` process each; a library is written under a
temporary name and renamed into place, so an interrupted build leaves
nothing half written.

:class:`Kernel` is one C entry point: it binds the ctypes signature,
launches on the caller's current CUDA stream, raises on a non-zero
``cudaGetLastError()`` and counts its launches.  :func:`device_kind` and
:func:`require` are the wrappers' shared dispatch and input checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ..base import MXNetError

__all__ = ["ARCH_FLAGS", "BUILD_DIR", "CSRC_DIR", "Kernel", "build_all",
           "build_log", "device_kind", "launch_counts", "load", "require",
           "reset_launch_counts"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mxnet_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-lineinfo", "-Xptxas=-v"] + ARCH_FLAGS

# Process-wide caches: one loaded library per source, built once.
_lock = threading.Lock()
_libs = {}
_KERNELS = []


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise MXNetError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                     "mxnet_tpu_torch are compiled at first use")


def _sources():
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _digest(name):
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == name + ".cu" or fname.endswith(".h"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(name):
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, _digest(name)))


def build_log(name):
    """``nvcc``'s output (``-Xptxas=-v``: registers, shared memory, spills
    per kernel) from the build of library ``name``, or '' if it was not
    built by this checkout."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _compile_missing(names):
    """Start one nvcc per missing library, all at once; wait for all."""
    todo = [(n, _lib_path(n)) for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = "%s.tmp%d" % (path, os.getpid())
        cmd = [nvcc] + _NVCC_FLAGS + ["-I", CSRC_DIR, "-o", tmp,
                                      os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("%s.cu:\n%s" % (name, out[-4000:]))
            continue
        with open(path + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, path)
    if errors:
        raise MXNetError("nvcc failed:\n" + "\n".join(errors))


def build_all():
    """Build (if needed) and load every kernel library; returns the seconds
    it took.  Entry points call this when they are constructed for a CUDA
    device, so no kernel compiles on a serving thread."""
    t0 = time.perf_counter()
    names = _sources()
    with _lock:
        _compile_missing([n for n in names if n not in _libs])
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_lib_path(name))
    return time.perf_counter() - t0


def load(name):
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile_missing([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib


class Kernel(object):
    """One C entry point of a kernel library plus its launch count.

    ``argtypes`` lists the entry's arguments before the trailing stream
    (pointers as ``ctypes.c_void_p``, so 64-bit addresses are not cut).
    ``launches`` counts the launches this process made, and nothing else
    adds to it.
    """

    def __init__(self, name, lib, symbol, argtypes):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()
        _KERNELS.append(self)

    def _resolve(self):
        lib = load(self.lib)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        errstr = lib.mxtpu_error_string
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        self._errstr = errstr
        self._fn = fn
        return fn

    def launch(self, device, *args):
        """Launch on ``device``'s current stream; raise if CUDA refused it."""
        fn = self._fn or self._resolve()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise MXNetError("CUDA kernel %s failed to launch: %s (%d)"
                             % (self.name, self._errstr(rc).decode(), rc))
        with self._count_lock:
            self.launches += 1


def device_kind(tensors):
    """``"cuda"`` when every tensor lies on one CUDA device (the wrapper
    launches its kernel), ``"cpu"`` when all lie on the CPU (the wrapper
    runs the plain version); anything else raises."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devices) == 1:
        return "cuda"
    raise MXNetError("tensors on %s: the port runs on one CUDA device or "
                     "on the CPU" % sorted(str(d) for d in devices))


def require(name, t, dtype, shape=None, align=4):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor, its address a
    multiple of ``align`` bytes and (when given) its shape ``shape``."""
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % align:
        raise MXNetError("%s kernel takes contiguous, %d-byte aligned %s "
                         "tensors, got %s contiguous=%s"
                         % (name, align, dtype, t.dtype, t.is_contiguous()))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise MXNetError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))


def launch_counts():
    """``{kernel name: launches}`` for every kernel of the port."""
    return {k.name: k.launches for k in _KERNELS}


def reset_launch_counts():
    for k in _KERNELS:
        with k._count_lock:
            k.launches = 0
