"""RecordIO files (counterpart of ``mxnet_tpu/recordio.py``): the sequential
``MXRecordIO`` and the indexed ``MXIndexedRecordIO`` reader and writer,
``IRHeader`` with ``pack``/``unpack``, and ``pack_img``/``unpack_img``.

Files are byte for byte the reference's (dmlc-core's format): each record
is the magic ``0xced7230a``, a length word whose top three bits are the
continuation flags (always 0 here: a record is written whole), the
payload, and zero padding to 4 bytes; the ``.idx`` sidecar holds one
``key<TAB>offset`` line a record.  Images are encoded and decoded on the
host by ``cv2``, else ``PIL``, as there.  Only the reference's pure-Python
reader and writer is ported (its native arm is its C API).
"""
from __future__ import annotations

import io as _io
import numbers
import os
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29
_LEN_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential reader (``flag="r"``) or writer (``flag="w"``) of a
    ``.rec`` file (``recordio.py:27``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise MXNetError("invalid flag %r" % self.flag)
        self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.pid = os.getpid()

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None          # reopened by __setstate__
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        """Back to the first record (a writer starts the file anew)."""
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def _seek(self, pos):
        if self.writable:
            raise MXNetError("seek on a writer")
        self.handle.seek(pos)

    def write(self, buf: bytes):
        """Append one record."""
        if not self.writable:
            raise MXNetError("write on a reader")
        n = len(buf)
        self.handle.write(struct.pack("<II", _MAGIC, n & _LEN_MASK))
        self.handle.write(buf)
        pad = (4 - (n & 3)) & 3
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        if self.writable:
            raise MXNetError("read on a writer")
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("invalid RecordIO magic in %s" % self.uri)
        n = lrec & _LEN_MASK
        data = self.handle.read(n)
        if len(data) < n:
            raise MXNetError("truncated record in %s" % self.uri)
        pad = (4 - (n & 3)) & 3
        if pad:
            self.handle.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random access through the ``.idx`` sidecar (``recordio.py:150``):
    ``write_idx(key, buf)``, ``read_idx(key)``; ``keys`` in file order."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._read_lock = threading.RLock()
        super().__init__(uri, flag)

    def __getstate__(self):
        d = super().__getstate__()
        d["_read_lock"] = None
        d["fidx"] = None
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        self._read_lock = threading.RLock()

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = None
            if os.path.exists(self.idx_path):
                with open(self.idx_path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) >= 2:
                            key = self.key_type(parts[0])
                            self.idx[key] = int(parts[1])
                            self.keys.append(key)

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        self._seek(self.idx[idx])

    def read_idx(self, idx):
        """The record of key ``idx``.  The seek and the read are one step
        under a lock: ``ImageRecordIter``'s reader thread shares the
        handle with the caller's own random access."""
        with self._read_lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
IRHeader.__doc__ = """An image record's header: ``flag`` (the length of a
vector label, else 0), ``label`` (a number or a vector), ``id``, ``id2``."""
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s: bytes) -> bytes:
    """One record from a header and a payload (``recordio.py:219``); a
    vector label is written after the header as float32 and its length
    stored in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        head = struct.pack(_IR_FORMAT, header.flag, header.label,
                           header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        head = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
        head += label.tobytes()
    return head + s


def unpack(s: bytes):
    """``(header, payload)`` of a record; a vector label comes back as a
    float32 array with ``flag`` 0."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        s = s[header.flag * 4:]
        header = header._replace(label=label, flag=0)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode ``img`` (HWC, BGR, uint8) and pack it with ``header``."""
    return pack(header, _encode_img(img, quality, img_fmt))


def unpack_img(s, iscolor=-1):
    """``(header, image)``: the payload decoded to a BGR uint8 array."""
    header, img_bytes = unpack(s)
    return header, _decode_img(img_bytes, iscolor)


def _encode_img(img, quality, img_fmt):
    try:
        import cv2
    except ImportError:
        from PIL import Image
        im = Image.fromarray(img[..., ::-1] if img.ndim == 3 else img)
        bio = _io.BytesIO()
        im.save(bio, format="JPEG", quality=quality)
        return bio.getvalue()
    ext = img_fmt if img_fmt.startswith(".") else "." + img_fmt
    params = [int(cv2.IMWRITE_JPEG_QUALITY), quality] if "jp" in ext else []
    ok, buf = cv2.imencode(ext, img, params)
    if not ok:
        raise MXNetError("image encode failed")
    return buf.tobytes()


def _decode_img(img_bytes, iscolor=-1):
    try:
        import cv2
    except ImportError:
        from PIL import Image
        a = np.asarray(Image.open(_io.BytesIO(img_bytes)))
        return a[..., ::-1] if a.ndim == 3 else a
    return cv2.imdecode(np.frombuffer(img_bytes, dtype=np.uint8), iscolor)
