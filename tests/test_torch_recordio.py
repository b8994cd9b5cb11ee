"""Parity of the port's RecordIO (mxnet_tpu_torch/recordio.py) and native
record library (mxnet_tpu_torch/_native.py) with the JAX package's, on
the CPU.

A .rec and its .idx written by each package are byte-identical and read
back in the other, through the native and the Python framing; the
IRHeader packing, the image decode chain (NPY0, native JPEG with the
component check, PIL) and the native JPEG decoder (full size and a
DCT-scaled short side) give the same bits; the corrupt-input budget,
the resync and the torn tail behave as tests/test_resilience.py:265-328
pins them for the JAX package. The native library's build runs under a
file lock: four processes that build it at once on an empty directory
compile it once, and every one loads a whole library."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mxnet_tpu import recordio as jrio
from mxnet_tpu import _native as jnative
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch.resilience import metrics as tmetrics

from torch_record_parity import (no_persistent_compile_cache,  # noqa: F401
                                 port_native_library, smooth_image,
                                 write_rec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(no_persistent_compile_cache, port_native_library):  # noqa: F811
    yield


def _python_framing(monkeypatch, *mods):
    for m in mods:
        monkeypatch.setattr(m, "_native_lib", lambda: None)


@pytest.mark.parametrize("framing", ["native", "python"])
@pytest.mark.parametrize("img_fmt", [".jpg", ".png"])
def test_rec_and_idx_byte_identical_and_cross_readable(
        tmp_path, monkeypatch, framing, img_fmt):
    if framing == "python":
        _python_framing(monkeypatch, jrio, trio)
    pj = write_rec(jrio, tmp_path / "j.rec", 9, img_fmt=img_fmt)
    pt = write_rec(trio, tmp_path / "t.rec", 9, img_fmt=img_fmt)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    with open(pj[:-4] + ".idx") as a, open(pt[:-4] + ".idx") as b:
        assert a.read() == b.read()
    # each package reads the other's file, by key and in sequence
    tr = trio.MXIndexedRecordIO(pj[:-4] + ".idx", pj, "r")
    jr = jrio.MXIndexedRecordIO(pt[:-4] + ".idx", pt, "r")
    assert tr.keys == jr.keys == list(range(9))
    for k in (4, 0, 8):
        a, b = tr.read_idx(k), jr.read_idx(k)
        assert a == b
        ht, it = trio.unpack_img(a)
        hj, ij = jrio.unpack_img(b)
        assert ht == hj and ht.id == k
        np.testing.assert_array_equal(it, ij)
    tr.close()
    jr.close()
    seq_t, seq_j = trio.MXRecordIO(pj, "r"), jrio.MXRecordIO(pt, "r")
    n = 0
    while True:
        a, b = seq_t.read(), seq_j.read()
        assert a == b
        if a is None:
            break
        n += 1
    assert n == 9


def test_native_and_python_framing_write_the_same_bytes(tmp_path,
                                                         monkeypatch):
    if tnative.ensure_built() is None:
        pytest.skip("no C++ compiler: the native framing is not built")
    native = write_rec(trio, tmp_path / "n.rec", 5, indexed=False)
    _python_framing(monkeypatch, trio)
    python = write_rec(trio, tmp_path / "p.rec", 5, indexed=False)
    with open(native, "rb") as a, open(python, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(6.0)])
def test_pack_unpack_equal_jax(label):
    payload = b"payload\x00\x01"
    hdr = (0, label, 7, 9)
    packed = trio.pack(trio.IRHeader(*hdr), payload)
    assert packed == jrio.pack(jrio.IRHeader(*hdr), payload)
    ht, st = trio.unpack(packed)
    hj, sj = jrio.unpack(packed)
    assert st == sj == payload
    assert (ht.flag, ht.id, ht.id2) == (hj.flag, hj.id, hj.id2)
    np.testing.assert_array_equal(np.asarray(ht.label),
                                  np.asarray(hj.label))


def _encoded(fmt, gray=False, h=37, w=51):
    from PIL import Image
    import io
    img = smooth_image(np.random.RandomState(3), h, w, 5)
    if gray:
        img = img[:, :, 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("iscolor", [-1, 0, 1])
@pytest.mark.parametrize("src", ["jpeg", "jpeg_gray", "png", "npy"])
def test_imdecode_chain_equals_jax(src, iscolor):
    if src == "npy":
        import io
        buf = io.BytesIO()
        np.save(buf, smooth_image(np.random.RandomState(1), 9, 7, 2))
        data = b"NPY0" + buf.getvalue()
    else:
        data = _encoded("PNG" if src == "png" else "JPEG",
                        gray=src == "jpeg_gray")
    got = trio._imdecode(data, iscolor)
    want = jrio._imdecode(data, iscolor)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    img, how = trio._imdecode_how(data, iscolor)
    np.testing.assert_array_equal(img, got)
    expect = {"npy": "npy", "png": "pil"}.get(src)
    if expect is None:  # JPEG: native unless a colour source goes to gray
        native = tnative.has_jpeg() and not (src == "jpeg" and iscolor == 0)
        expect = "libjpeg" if native else "pil"
    assert how == expect


@pytest.mark.parametrize("short_side", [0, 16, 40])
def test_native_jpeg_decode_bit_identical(short_side):
    if not tnative.has_jpeg():
        pytest.skip("the native library was built without libjpeg")
    data = _encoded("JPEG", h=120, w=160)
    got = tnative.imdecode_jpeg(data, short_side)
    want = jnative.imdecode_jpeg(data, short_side)
    assert want is not None
    assert got.shape == want.shape and got.dtype == np.uint8
    if short_side:
        assert min(got.shape[:2]) == short_side
    else:
        assert got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)
    assert tnative.imdecode_jpeg(b"\xff\xd8garbage", short_side) is None


def _write_plain(mod, path, payloads):
    w = mod.MXRecordIO(path, "w")
    offsets = [w.write(p) for p in payloads]
    w.close()
    return offsets


def test_bad_magic_resync_within_budget_as_jax(tmp_path, monkeypatch):
    _python_framing(monkeypatch, jrio, trio)
    path = str(tmp_path / "x.rec")
    payloads = [b"rec-%d-" % i + bytes(range(8)) for i in range(5)]
    offsets = _write_plain(trio, path, payloads)
    with open(path, "r+b") as f:      # corrupt record 3's magic word
        f.seek(offsets[3])
        f.write(b"\xde\xad\xbe\xef")
    before = tmetrics.get("io.bad_records")
    got = {}
    for name, mod in (("port", trio), ("jax", jrio)):
        r = mod.MXRecordIO(path, "r", bad_record_budget=2)
        got[name] = []
        while True:
            rec = r.read()
            if rec is None:
                break
            got[name].append(rec)
        r.close()
        assert r.bad_records == 1
    assert got["port"] == got["jax"] == [payloads[0], payloads[1],
                                         payloads[2], payloads[4]]
    assert tmetrics.get("io.bad_records") == before + 1
    for mod in (trio, jrio):          # default budget 0: the reference's
        strict = mod.MXRecordIO(path, "r")
        assert [strict.read() for _ in range(3)] == payloads[:3]
        with pytest.raises(IOError, match="Invalid RecordIO magic"):
            strict.read()
        strict.close()


@pytest.mark.parametrize("cut", [20, 46])
def test_torn_tail_reads_as_eof_at_budget_zero_as_jax(tmp_path, monkeypatch,
                                                      cut):
    """cut 20 tears the last payload, 46 leaves a partial header."""
    _python_framing(monkeypatch, jrio, trio)
    path = str(tmp_path / "t.rec")
    payloads = [b"a" * 40, b"b" * 40]
    _write_plain(trio, path, payloads)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - cut)
    for mod in (trio, jrio):
        r = mod.MXRecordIO(path, "r")
        assert r.read() == payloads[0]
        assert r.read() is None
        assert r.bad_records == 1
        r.close()


def test_bad_record_budget_from_env(tmp_path, monkeypatch):
    _python_framing(monkeypatch, trio)
    path = str(tmp_path / "e.rec")
    offsets = _write_plain(trio, path, [b"x" * 12, b"y" * 12, b"z" * 12])
    with open(path, "r+b") as f:
        f.seek(offsets[1])
        f.write(b"\x00\x00\x00\x00")
    monkeypatch.setenv("MXTPU_BAD_RECORD_BUDGET", "1")
    r = trio.MXRecordIO(path, "r")
    assert [r.read(), r.read(), r.read()] == [b"x" * 12, b"z" * 12, None]
    r.close()


def test_io_read_site_is_retried_on_the_python_reader(tmp_path, monkeypatch):
    from mxnet_tpu_torch.resilience import chaos
    _python_framing(monkeypatch, trio)
    path = str(tmp_path / "c.rec")
    _write_plain(trio, path, [b"one!", b"two!"])
    monkeypatch.setenv("MXTPU_RETRY_BASE_DELAY_S", "0.001")
    chaos.configure("io.read:p=1,n=2")
    try:
        r = trio.MXRecordIO(path, "r")
        assert [r.read(), r.read(), r.read()] == [b"one!", b"two!", None]
        r.close()
    finally:
        chaos.configure("")


def test_indexed_reader_pickles_and_reopens(tmp_path):
    """Pickling closes the reader (as the JAX package's and MXNet's
    __getstate__ do); the copy reopens and reads."""
    import pickle
    p = write_rec(trio, tmp_path / "k.rec", 4)
    r = trio.MXIndexedRecordIO(p[:-4] + ".idx", p, "r")
    want = r.read_idx(2)
    r2 = pickle.loads(pickle.dumps(r))
    assert not r.is_open and r2.is_open
    assert r2.read_idx(2) == want and r2.keys == [0, 1, 2, 3]
    r2.close()


def test_native_library_path_and_build_dir():
    path = tnative.library_path()
    assert os.path.exists(path)
    build = tnative.build_dir()
    assert build.startswith(os.path.join(ROOT, "mxnet_tpu_torch", "_build"))
    src = os.path.join(ROOT, "src")      # the build never writes there
    assert os.path.commonpath([build, src]) != src


_BUILD_SCRIPT = textwrap.dedent(r"""
    import json, os, sys, tempfile, time
    sys.path.insert(0, sys.argv[1])
    from mxnet_tpu_torch import _native
    _native._BUILD_ROOT = sys.argv[2]
    for k in ("MXTPU_LIBRARY_PATH", "MXNET_LIBRARY_PATH"):
        os.environ.pop(k, None)
    open(os.path.join(sys.argv[3], "ready.%d" % os.getpid()), "w").close()
    go = os.path.join(sys.argv[3], "go")
    while not os.path.exists(go):
        time.sleep(0.005)
    lib = _native.ensure_built()
    ok = lib is not None
    if ok:
        rec = os.path.join(tempfile.mkdtemp(), "r.rec")
        w = _native.RecordWriter(rec)
        w.write(b"whole library")
        w.close()
        r = _native.RecordReader(rec)
        ok = r.read() == b"whole library"
        r.close()
    print(json.dumps({"loaded": ok, "built": _native.built_here,
                      "path": _native._LIB_FROM,
                      "jpeg": hasattr(lib, "MXTPUImdecodeJPEG")}))
""")


def test_concurrent_builds_take_the_lock_and_load_a_whole_library(tmp_path):
    """Four processes call ensure_built() at once on an empty build
    directory: one compiles, the others wait on the lock and load the
    renamed library; each writes and reads a record through it."""
    import json
    import shutil
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler")
    build_root = tmp_path / "build"
    sync = tmp_path / "sync"
    sync.mkdir()
    env = dict(os.environ)
    env.pop("MXTPU_LIBRARY_PATH", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, ROOT, str(build_root), str(sync)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for _ in range(4)]
    try:
        import time
        deadline = time.monotonic() + 120
        while len([f for f in os.listdir(sync) if f.startswith("ready")]) \
                < 4:
            assert time.monotonic() < deadline, "the build processes did not start"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        (sync / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()
        results.append(json.loads(out.decode().strip().splitlines()[-1]))
    assert all(r["loaded"] for r in results), results
    assert sum(r["built"] for r in results) == 1, results
    assert len({r["path"] for r in results}) == 1
    assert len({r["jpeg"] for r in results}) == 1
    # nothing half-written is left beside the library
    (lib_dir,) = [d for d in build_root.iterdir() if d.is_dir()]
    assert not [f for f in os.listdir(lib_dir) if f.endswith(".tmp")]
