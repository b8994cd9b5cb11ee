"""ctypes bindings for the native record loader (counterpart of
mxnet_tpu/_native.py; reference: python/mxnet/base.py's _load_lib).

The library is built from the backend-neutral C++ sources in ``src/``
(``engine.cc``, ``recordio.cc``, ``image_decode.cc``; read, never
written) with the flags of ``src/Makefile``:
``g++ -O2 -std=c++17 -fPIC -Wall -pthread -shared ... -ljpeg``. It lands
in the git-ignored ``mxnet_tpu_torch/_build/native-<hash>/libmxtpu.so``,
keyed by a hash of the sources and flags, as ``ops/_build.py`` keys the
kernels. Nothing is built at import: the first `ensure_built()` builds.

The build runs under an exclusive ``fcntl.flock`` on a lock file beside
the library, into a temporary file that is renamed over the final name
when the compiler is done: two processes (or xdist workers) never
compile at once, and none can load a half-written library (the JAX
package's ``make -C src`` has no lock). Where the compiler finds no
``jpeglib.h`` the library is built without ``image_decode.cc``: the
record reader, writer and prefetch loader stay native and JPEG decoding
falls back to PIL (`imdecode_jpeg` returns None).

``MXTPU_LIBRARY_PATH`` (or the reference's ``MXNET_LIBRARY_PATH``), when
it names an existing file, wins over the build. Everything degrades
gracefully: without a compiler `ensure_built` returns None and callers
take their pure-Python paths. The engine's symbols are bound too; the
`NativeEngine` class waits for the port's ``engine.py`` (ROADMAP A10).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["LIB", "NativeError", "PrefetchLoader", "RecordReader",
           "RecordWriter", "build_dir", "ensure_built", "has_jpeg",
           "imdecode_jpeg", "library_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "src")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_SOURCES = ("engine.cc", "recordio.cc")
_JPEG_SOURCE = "image_decode.cc"
# src/Makefile:4-6
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread")
_LDFLAGS = ("-shared", "-pthread")
_LDLIBS = ("-ljpeg",)
_LIB_NAME = "libmxtpu.so"

LIB = None
_LIB_FROM = None
# whether this process ran the compiler (the build-lock test reads it)
built_here = False
_lock = threading.Lock()
_build_failed = False


class NativeError(RuntimeError):
    pass


def _bind(lib):
    lib.MXTGetLastError.restype = ctypes.c_char_p
    lib.MXTEngineCreate.restype = ctypes.c_void_p
    lib.MXTEngineCreate.argtypes = [ctypes.c_int]
    lib.MXTEngineFree.argtypes = [ctypes.c_void_p]
    lib.MXTEngineNewVar.restype = ctypes.c_int64
    lib.MXTEngineNewVar.argtypes = [ctypes.c_void_p]
    lib.MXTEnginePush.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.MXTEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.MXTEngineWaitForAll.argtypes = [ctypes.c_void_p]
    lib.MXTEngineSetCallbackError.argtypes = [ctypes.c_char_p]

    lib.MXTRecordIOGetLastError.restype = ctypes.c_char_p
    lib.MXTRecordReaderCreate.restype = ctypes.c_void_p
    lib.MXTRecordReaderCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordReaderFree.argtypes = [ctypes.c_void_p]
    lib.MXTRecordReaderNext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.MXTRecordReaderReset.argtypes = [ctypes.c_void_p]
    lib.MXTRecordReaderTell.restype = ctypes.c_int64
    lib.MXTRecordReaderTell.argtypes = [ctypes.c_void_p]
    lib.MXTRecordReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.MXTRecordWriterCreate.restype = ctypes.c_void_p
    lib.MXTRecordWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordWriterFree.argtypes = [ctypes.c_void_p]
    lib.MXTRecordWriterTell.restype = ctypes.c_int64
    lib.MXTRecordWriterTell.argtypes = [ctypes.c_void_p]
    lib.MXTRecordWriterWrite.restype = ctypes.c_int64
    lib.MXTRecordWriterWrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int64]
    lib.MXTPrefetchLoaderCreate.restype = ctypes.c_void_p
    lib.MXTPrefetchLoaderCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.MXTPrefetchLoaderFree.argtypes = [ctypes.c_void_p]
    lib.MXTPrefetchLoaderNext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.MXTPrefetchBatchFree.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "MXTPUImdecodeJPEG"):  # absent without libjpeg
        lib.MXTPUImdecodeJPEG.restype = ctypes.c_int
        lib.MXTPUImdecodeJPEG.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.MXTPUFreeBuf.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    return lib


def build_dir():
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS + _LDLIBS).encode())
    for name in _SOURCES + (_JPEG_SOURCE,):
        h.update(name.encode())
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, "native-" + h.hexdigest()[:16])


def _env_path():
    for cand in (os.environ.get("MXTPU_LIBRARY_PATH"),
                 os.environ.get("MXNET_LIBRARY_PATH")):
        if cand and os.path.exists(cand):
            return cand
    return None


def library_path():
    """Where the library is loaded from: the env override when it names
    an existing file, else the build directory's library."""
    return _env_path() or os.path.join(build_dir(), _LIB_NAME)


def _compile(out):
    """Compile into `out`: with the JPEG decoder, or without it where the
    first command fails (no jpeglib.h or libjpeg). Returns (built, the
    compiler's output of the failed tries)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    logs = []
    for extra_src, libs in (([os.path.join(_SRC_DIR, _JPEG_SOURCE)],
                             list(_LDLIBS)), ([], [])):
        cmd = ([cxx] + list(_CXXFLAGS) + list(_LDFLAGS) + ["-o", out]
               + srcs + extra_src + libs)
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            logs.append("%s: %s" % (" ".join(cmd), e))
            break
        if proc.returncode == 0:
            return True, "\n".join(logs)
        logs.append(" ".join(cmd) + "\n" + proc.stdout.decode(
            errors="replace"))
    return False, "\n".join(logs)


def _build():
    """Build the library once for this build directory, under an exclusive
    file lock; returns its path, or None when it cannot be built."""
    global built_here
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    final = os.path.join(out_dir, _LIB_NAME)
    with open(os.path.join(out_dir, "build.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(final):       # another process built it
                try:
                    ctypes.CDLL(final)
                    return final
                except OSError:   # built elsewhere (its libjpeg missing)
                    pass
            tmp = "%s.%d.tmp" % (final, os.getpid())
            built, log = _compile(tmp)
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(log)
            if not built:
                if os.path.exists(tmp):
                    os.remove(tmp)
                return None
            os.replace(tmp, final)      # atomic: no reader sees half a file
            built_here = True
            return final
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _load(path):
    global LIB, _LIB_FROM
    try:
        LIB = _bind(ctypes.CDLL(path))
        _LIB_FROM = path
    except (OSError, AttributeError):
        LIB = None
    return LIB


def _try_load():
    """The library if it is loaded or can be loaded without a build."""
    if LIB is not None:
        return LIB
    path = library_path()
    if os.path.exists(path):
        with _lock:
            if LIB is None:
                _load(path)
    return LIB


def ensure_built(quiet=True):
    """Load the library, building it first where it is missing; returns
    LIB or None (no compiler, or the build failed: see ``build.log``).
    `quiet` is accepted for the JAX package's signature."""
    global _build_failed
    if _try_load() is not None:
        return LIB
    with _lock:
        if LIB is not None:
            return LIB
        if _build_failed:
            return None
        path = _build()
        if path is None:
            _build_failed = True
            return None
        return _load(path)


def has_jpeg():
    """Whether the loaded (or buildable) library decodes JPEG."""
    lib = ensure_built()
    return lib is not None and hasattr(lib, "MXTPUImdecodeJPEG")


def imdecode_jpeg(data, short_side=0):
    """Native libjpeg decode to an RGB uint8 HWC array (src/
    image_decode.cc; reference: the OpenCV decode in src/io/image_io.cc).

    short_side > 0 decodes at the best DCT scale and bilinear-resizes so
    min(h, w) == short_side. Returns None when the native decoder is
    unavailable or the buffer is not decodable (the caller falls
    back)."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "MXTPUImdecodeJPEG"):
        return None
    import numpy as np
    out = ctypes.POINTER(ctypes.c_ubyte)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.MXTPUImdecodeJPEG(data, len(data), int(short_side),
                               ctypes.byref(out), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.MXTPUFreeBuf(out)
    return arr.reshape(h.value, w.value, c.value)


def _need():
    lib = ensure_built()
    if lib is None:
        raise NativeError("the native record library is not built (no "
                          "C++ compiler, or see %s/build.log)" % build_dir())
    return lib


class RecordReader:
    """Sequential native RecordIO reader (src/recordio.cc)."""

    def __init__(self, path):
        lib = _need()
        self._lib = lib
        self._h = lib.MXTRecordReaderCreate(path.encode())
        if not self._h:
            raise NativeError(lib.MXTRecordIOGetLastError().decode())

    def read(self):
        out = ctypes.c_char_p()
        size = ctypes.c_int64()
        ret = self._lib.MXTRecordReaderNext(self._h, ctypes.byref(out),
                                            ctypes.byref(size))
        if ret == 1:
            return None
        if ret != 0:
            raise NativeError(
                self._lib.MXTRecordIOGetLastError().decode())
        return ctypes.string_at(out, size.value)

    def reset(self):
        self._lib.MXTRecordReaderReset(self._h)

    def tell(self):
        return self._lib.MXTRecordReaderTell(self._h)

    def seek(self, pos):
        self._lib.MXTRecordReaderSeek(self._h, pos)

    def close(self):
        if self._h:
            self._lib.MXTRecordReaderFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordWriter:
    """Native RecordIO writer (src/recordio.cc)."""

    def __init__(self, path):
        lib = _need()
        self._lib = lib
        self._h = lib.MXTRecordWriterCreate(path.encode())
        if not self._h:
            raise NativeError(lib.MXTRecordIOGetLastError().decode())

    def write(self, buf):
        pos = self._lib.MXTRecordWriterWrite(self._h, bytes(buf),
                                             len(buf))
        if pos < 0:
            raise NativeError(
                self._lib.MXTRecordIOGetLastError().decode())
        return pos

    def tell(self):
        return self._lib.MXTRecordWriterTell(self._h)

    def close(self):
        if self._h:
            self._lib.MXTRecordWriterFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchLoader:
    """Background-threaded record batch loader (src/recordio.cc
    PrefetchLoader; the iter_prefetcher.h role): a C++ thread reads and
    frames `batch_records` records at a time into a queue of
    `queue_cap`."""

    def __init__(self, path, batch_records, queue_cap=4, loop=False):
        lib = _need()
        self._lib = lib
        self._h = lib.MXTPrefetchLoaderCreate(path.encode(),
                                              batch_records, queue_cap,
                                              1 if loop else 0)
        if not self._h:
            raise NativeError(lib.MXTRecordIOGetLastError().decode())

    def next(self):
        """A list of record byte strings, or None at the end."""
        bh = ctypes.c_void_p()
        by = ctypes.c_char_p()
        nb = ctypes.c_int64()
        offs = ctypes.POINTER(ctypes.c_int64)()
        nr = ctypes.c_int64()
        ret = self._lib.MXTPrefetchLoaderNext(
            self._h, ctypes.byref(bh), ctypes.byref(by),
            ctypes.byref(nb), ctypes.byref(offs), ctypes.byref(nr))
        if ret == 1:
            return None
        if ret < 0:
            raise NativeError(
                self._lib.MXTRecordIOGetLastError().decode())
        raw = ctypes.string_at(by, nb.value)
        offsets = [offs[i] for i in range(nr.value + 1)]
        self._lib.MXTPrefetchBatchFree(bh)
        return [raw[offsets[i]:offsets[i + 1]]
                for i in range(nr.value)]

    def __iter__(self):
        while True:
            batch = self.next()
            if batch is None:
                return
            yield batch

    def close(self):
        if self._h:
            self._lib.MXTPrefetchLoaderFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
