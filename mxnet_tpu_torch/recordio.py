"""RecordIO, the reference's record-packed dataset container (counterpart
of mxnet_tpu/recordio.py; reference: python/mxnet/recordio.py over
dmlc-core's recordio format).

`MXRecordIO`, `MXIndexedRecordIO`, `IRHeader`, `pack`/`unpack`,
`pack_img`/`unpack_img`. Records are magic-framed and 4-byte aligned,
with the image-record IRHeader prefix, so a .rec and its .idx written
here are byte-identical to the JAX package's and the reference's. Local
files go through the native reader and writer (`_native`, built from
``src/recordio.cc``) where the library is loaded, else through the
Python framing, which carries the ``io.read`` injection site, the
corrupt-input budget (``MXTPU_BAD_RECORD_BUDGET``: mid-stream framing
errors resync to the next aligned magic word while it lasts) and the
torn-tail rule (a truncated trailing record reads as EOF, warned and
counted in ``io.bad_records``).

Image payloads decode as the JAX package's do (`_imdecode`): NPY0
records through numpy, JPEG through the native libjpeg decoder where the
library has it (with the component check that keeps the output's shape
independent of that), else PIL.
"""
from __future__ import annotations

import io as _pyio
import numbers
import struct
from collections import namedtuple

import numpy as np

from .base import getenv
from .resilience import metrics as _metrics
from .resilience.chaos import chaos_point
from .resilience.retry import RetryPolicy, TransientError, retry_call

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a
_LENGTH_MASK = (1 << 29) - 1


def _native_lib():
    """The native library if it is loaded or built (no build here)."""
    try:
        from . import _native
        return _native.LIB if _native.LIB is not None \
            else _native._try_load()
    except Exception:
        return None


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: recordio.py:37).

    Uses the native C++ reader/writer (src/recordio.cc) when
    libmxtpu.so is built, mirroring the reference's C++ RecordIO with a
    python fallback."""

    def __init__(self, uri, flag, bad_record_budget=None):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.is_open = False
        self._nat = None
        # corrupt-input budget (docs/fault_tolerance.md): up to this
        # many MID-STREAM framing errors (bad magic) are skipped — the
        # reader resyncs to the next 4-aligned magic word — before
        # failing; a torn TRAILING record (crashed writer) is always
        # treated as EOF, matching the pre-budget reader. Cumulative
        # across reset(); surfaced in `bad_records` for monitoring.
        # Default 0 keeps the reference's fail-on-first-corruption
        # behavior for mid-stream damage.
        if bad_record_budget is None:
            bad_record_budget = getenv("MXTPU_BAD_RECORD_BUDGET", 0)
        self._bad_budget = int(bad_record_budget)
        self.bad_records = 0
        self.open()

    def open(self):
        from .filesystem import open_uri, scheme_of, _strip_file
        # the C++ reader takes local paths; remote uris go through the
        # filesystem layer's buffered python path (dmlc Stream::Create
        # dispatch, SURVEY N17)
        local = scheme_of(self.uri) in ("", "file")
        path = _strip_file(self.uri) if local else self.uri
        lib = _native_lib() if local else None
        if self.flag == "w":
            self.writable = True
            if lib is not None:
                from . import _native
                self._nat = _native.RecordWriter(path)
            else:
                self.handle = open_uri(self.uri, "wb")
        elif self.flag == "r":
            self.writable = False
            if lib is not None:
                from . import _native
                self._nat = _native.RecordReader(path)
            else:
                self.handle = open_uri(self.uri, "rb")
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        d.pop("_nat", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d.get("is_open", False)
        self.is_open = False
        self.handle = None
        self._nat = None
        if is_open:
            self.open()

    def close(self):
        if not self.is_open:
            return
        if self._nat is not None:
            self._nat.close()
            self._nat = None
        if self.handle is not None:
            self.handle.close()
            self.handle = None
        self.is_open = False

    def reset(self):
        """Resets read head to the beginning."""
        self.close()
        self.open()

    def tell(self):
        """Current position of the file head."""
        if self._nat is not None:
            return self._nat.tell()
        return self.handle.tell()

    def write(self, buf):
        """Appends one record (reference: recordio.py:154)."""
        assert self.writable
        data = bytes(buf)
        if self._nat is not None:
            return self._nat.write(data)
        upper = 0  # cflag 0: complete record (no multi-part split)
        lrec = (upper << 29) | (len(data) & _LENGTH_MASK)
        pos = self.handle.tell()
        self.handle.write(struct.pack("<II", _kMagic, lrec))
        self.handle.write(data)
        pad = (4 - (len(data) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)
        return pos

    def read(self):
        """Reads the next record; None at EOF
        (reference: recordio.py:180).

        The python path carries the `io.read` injection site (retried:
        the site precedes any stream consumption) and the corrupt-input
        budget: framing errors resync to the next magic word while the
        budget lasts."""
        assert not self.writable
        if self._nat is not None:
            return self._nat.read()
        # `io.read` injection site: only the gate is retried — the
        # framing read below is not replayed (it consumes the stream)
        retry_call(chaos_point, "io.read", policy=self._io_retry_policy())
        return self._read_py()

    def _io_retry_policy(self):
        pol = getattr(self, "_io_retry_pol", None)
        if pol is None:  # cached per reader: no env parse per record
            pol = self._io_retry_pol = RetryPolicy(
                max_attempts=getenv("MXTPU_IO_RETRIES", 8),
                base_delay=getenv("MXTPU_RETRY_BASE_DELAY_S", 0.01),
                max_delay=0.5, retry_on=(TransientError,), what="io.read")
        return pol

    def _read_py(self):
        while True:
            hdr_pos = self.handle.tell()
            hdr = self.handle.read(8)
            if len(hdr) == 0:
                return None
            if len(hdr) < 8:
                # trailing garbage shorter than a header: a torn append
                self._note_torn_tail("truncated header at byte %d"
                                     % hdr_pos)
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _kMagic:
                self._count_bad("invalid magic at byte %d" % hdr_pos)
                self._resync(hdr_pos + 1)
                continue
            length = lrec & _LENGTH_MASK
            data = self.handle.read(length)
            if len(data) < length:
                # payload ran into EOF: a torn final record
                self._note_torn_tail(
                    "truncated record at byte %d (%d of %d payload "
                    "bytes)" % (hdr_pos, len(data), length))
                return None
            pad = (4 - (length % 4)) % 4
            if pad:
                self.handle.read(pad)
            return data

    def _note_torn_tail(self, what):
        """A torn trailing record reads as EOF whatever the budget —
        the pre-budget reader ended cleanly here too; the count and
        warning just make the damage visible."""
        self.bad_records += 1
        _metrics.bump("io.bad_records")
        import logging
        logging.getLogger("mxnet_tpu_torch.io").warning(
            "%s: %s — treating as EOF (torn trailing record)",
            self.uri, what)

    def _count_bad(self, what):
        """Account one mid-stream framing error against the budget;
        raise when exhausted (the reference's behavior is budget 0)."""
        self.bad_records += 1
        _metrics.bump("io.bad_records")
        if self.bad_records > self._bad_budget:
            raise IOError(
                "Invalid RecordIO magic in %s: %s (bad record %d "
                "exceeds MXTPU_BAD_RECORD_BUDGET=%d)"
                % (self.uri, what, self.bad_records, self._bad_budget))
        import logging
        logging.getLogger("mxnet_tpu_torch.io").warning(
            "%s: skipping corrupt record (%s), %d/%d budget used",
            self.uri, what, self.bad_records, self._bad_budget)

    def _resync(self, start):
        """Scan forward from byte `start` for the next 4-aligned magic
        word and position the handle there (records are 4-byte aligned
        by the writer); lands at EOF when none is left."""
        magic_bytes = struct.pack("<I", _kMagic)
        pos = start
        self.handle.seek(pos)
        tail = b""
        while True:
            chunk = self.handle.read(65536)
            if not chunk:
                return
            data = tail + chunk
            base = pos - len(tail)
            i = data.find(magic_bytes)
            while i != -1:
                if (base + i) % 4 == 0:
                    self.handle.seek(base + i)
                    return
                i = data.find(magic_bytes, i + 1)
            tail = data[-3:]
            pos += len(chunk)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a .idx sidecar
    (reference: recordio.py:211)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, self.flag)
        if not self.writable:
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                if len(line) < 2:
                    continue
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        """Sets read head to the record with the given key."""
        assert not self.writable
        pos = self.idx[idx]
        if self._nat is not None:
            self._nat.seek(pos)
        else:
            self.handle.seek(pos)

    def read_idx(self, idx):
        """Reads the record with the given key."""
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        """Writes a record keyed by idx."""
        key = self.key_type(idx)
        pos = self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# image-record header (reference: recordio.py:302)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Packs a string byte sequence into an image record
    (reference: recordio.py:309)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(label=float(header.label))
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Unpacks a record into header and payload
    (reference: recordio.py:349)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpacks a record into header and decoded image
    (reference: recordio.py:377)."""
    header, s = unpack(s)
    img = _imdecode(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Packs an image into a record (reference: recordio.py:410).

    Uses PIL (OpenCV's role in the reference) when available; raw numpy
    fallback encodes lossless .npy."""
    try:
        from PIL import Image
        buf = _pyio.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(np.asarray(img).astype(np.uint8)).save(
            buf, format=fmt, quality=quality)
        return pack(header, buf.getvalue())
    except ImportError:
        buf = _pyio.BytesIO()
        np.save(buf, np.asarray(img))
        return pack(header, b"NPY0" + buf.getvalue())


def _jpeg_components(s):
    """Component count (1=grayscale, 3=YCbCr/RGB) from the JPEG SOF
    marker; 0 if no SOF is found before the scan data."""
    i = 2
    n = len(s)
    while i + 9 < n:
        if s[i] != 0xFF:
            i += 1
            continue
        marker = s[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                      0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            return s[i + 9]
        if marker == 0xDA:  # start of scan — SOF must precede it
            return 0
        if marker == 0xFF:  # fill byte: stay on the 0xFF run
            i += 1
            continue
        if 0xD0 <= marker <= 0xD9 or marker == 0x01:
            i += 2
            continue
        seg_len = (s[i + 2] << 8) | s[i + 3]
        i += 2 + seg_len
    return 0


def _imdecode(s, iscolor=-1):
    return _imdecode_how(s, iscolor)[0]


def _imdecode_how(s, iscolor=-1):
    """The decoded image and the decoder that made it: "npy", "libjpeg"
    (the native decoder) or "pil"."""
    if s[:4] == b"NPY0":
        return np.load(_pyio.BytesIO(s[4:])), "npy"
    # native fast path: the C decoder always emits (H, W, 3), so for
    # iscolor=-1 ("as stored") a grayscale source must collapse back to
    # 2-D (all three channels are identical by construction) to keep the
    # output shape independent of whether the lib is built
    if s[:2] == b"\xff\xd8":
        from ._native import imdecode_jpeg
        ncomp = _jpeg_components(s)
        if iscolor == 1 or ncomp == 1 or (iscolor == -1 and ncomp == 3):
            img = imdecode_jpeg(bytes(s))
            if img is not None:
                if iscolor == 1:
                    return img, "libjpeg"
                if ncomp == 1:           # grayscale source
                    return img[:, :, 0], "libjpeg"  # -1: as stored
                return img, "libjpeg"
        # remaining case (iscolor=0 on a color JPEG) needs a luma
        # conversion matching PIL's — fall through
    try:
        from PIL import Image
        img = Image.open(_pyio.BytesIO(s))
        if iscolor == 0:
            img = img.convert("L")
        elif iscolor == 1:
            img = img.convert("RGB")
        return np.asarray(img), "pil"
    except ImportError as e:
        raise RuntimeError(
            "Decoding compressed images requires PIL, which is "
            "unavailable; use .npy-packed records (pack_img fallback)."
        ) from e
