"""Build the package's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). One ``nvcc`` process per source, all started together.
The libraries land in ``mxnet_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one is reused; the directory is listed in ``.gitignore``. Each build
also keeps ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) beside its library as ``<name>.log``.

Nothing is built when the package is imported: only a kernel's first
launch, or `build_all()`, runs the compiler.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..base import MXNetError

__all__ = ["build_all", "build_dir", "check_launch", "dtype_code", "load",
           "stream_of"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def build_dir():
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16])


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found on PATH or under %s; the CUDA "
                         "kernels cannot be built" % cuda_home)
    return path


def build_all():
    """Compile every source that has no library yet, all in parallel.
    Returns {name: path of the .so}. Raises `MXNetError` with the
    compiler's output when a build fails."""
    with _lock:
        out = build_dir()
        os.makedirs(out, exist_ok=True)
        pending = []
        libs = {}
        for src in _sources():
            name = os.path.splitext(os.path.basename(src))[0]
            so = os.path.join(out, name + ".so")
            libs[name] = so
            if os.path.exists(so):
                continue
            tmp = "%s.%d.tmp" % (so, os.getpid())
            cmd = [_nvcc(), *_FLAGS, "-o", tmp, src]
            pending.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, so, tmp, proc in pending:
            log = proc.communicate()[0].decode(errors="replace")
            with open(os.path.join(out, name + ".log"), "w") as f:
                f.write(log)
            if proc.returncode:
                failed.append("%s (nvcc exit %d):\n%s"
                              % (name, proc.returncode, log))
            else:
                os.replace(tmp, so)   # atomic: readers never see a half file
        if failed:
            raise MXNetError("CUDA kernel build failed: "
                             + "\n".join(failed))
        return libs


def dtype_code(t):
    """The kernels' dtype argument: 0 = float32, 1 = bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise MXNetError("the CUDA kernels take float32 or bfloat16, got %s"
                     % t.dtype)


def stream_of(t):
    """PyTorch's current stream on `t`'s device, as an int that ctypes
    passes as a pointer (the raw pointer, without building a
    torch.cuda.Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_launch(rc, what):
    """Raise on a launch that returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc:
        raise MXNetError("%s: kernel launch failed with CUDA error %d"
                         % (what, rc))


def load(name):
    """The loaded ctypes library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all().get(name)
        if path is None:
            raise MXNetError("no CUDA source csrc/%s.cu" % name)
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(path)
    return lib
