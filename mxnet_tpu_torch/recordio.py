"""RecordIO: length-delimited binary record files with an optional index.

Counterpart of ``mxnet_tpu/recordio.py``, in the same on-disk format both
ways: each record is a little-endian header (magic ``0x54524543``, the
payload's CRC-32, its length as a uint64), the payload, and zeros to the
next 8-byte boundary. ``IRHeader`` packs a label (or a float32 label vector
of length ``flag``) and two ids in front of an image payload.
``pack_img`` / ``unpack_img`` encode and decode the image with the port's
own PNG codec (``io/_imaging.py``); a JPEG goes through PIL, and raises an
``MXNetError`` that names PIL where it cannot be imported.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .filesystem import open_uri

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "read_record_at", "scan_offsets",
           "RECORD_MAGIC"]

RECORD_MAGIC = 0x54524543  # 'CREC'
_HEADER = struct.Struct("<IIQ")  # magic, crc32(data), length


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri: str, flag: str):
        if flag not in ("r", "w"):
            raise MXNetError("flag must be 'r' or 'w'")
        self.uri = uri
        self.flag = flag
        self.open()

    def open(self):
        self._f = open_uri(self.uri, "rb" if self.flag == "r" else "wb")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self._f.tell()

    def write(self, buf: bytes) -> int:
        """Append one record; returns its file offset."""
        if self.flag != "w":
            raise MXNetError("recordio not opened for writing")
        pos = self._f.tell()
        self._f.write(_HEADER.pack(RECORD_MAGIC, zlib.crc32(buf), len(buf)))
        self._f.write(buf)
        pad = (-len(buf)) % 8
        if pad:
            self._f.write(b"\x00" * pad)
        return pos

    def read(self) -> bytes | None:
        """The next record, or None at the end of the file."""
        if self.flag != "r":
            raise MXNetError("recordio not opened for reading")
        header = self._f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            return None
        magic, crc, length = _HEADER.unpack(header)
        if magic != RECORD_MAGIC:
            raise MXNetError(f"corrupt record file {self.uri!r}: bad magic")
        buf = self._f.read(length)
        if len(buf) < length:
            raise MXNetError(f"truncated record in {self.uri!r}")
        if zlib.crc32(buf) != crc:
            raise MXNetError(f"crc mismatch in {self.uri!r}")
        pad = (-length) % 8
        if pad:
            self._f.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random access through a sidecar ``.idx`` file of ``key\\toffset``
    lines."""

    def __init__(self, idx_path: str, uri: str, flag: str):
        self.idx_path = idx_path
        self.idx: dict[int, int] = {}
        self.keys: list[int] = []
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    key, off = line.strip().split("\t")
                    self.idx[int(key)] = int(off)
                    self.keys.append(int(key))

    def close(self):
        if self.flag == "w" and getattr(self, "_f", None):
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def write_idx(self, idx: int, buf: bytes):
        self.idx[idx] = self.write(buf)
        self.keys.append(idx)

    def read_idx(self, idx: int) -> bytes:
        self._f.seek(self.idx[idx])
        return self.read()


def read_record_at(f, offset: int) -> bytes:
    """One record's payload from an open binary file at ``offset`` (an
    entry of :func:`scan_offsets`), CRC-checked."""
    f.seek(offset)
    header = f.read(_HEADER.size)
    if len(header) < _HEADER.size:
        raise MXNetError("truncated record header")
    magic, crc, length = _HEADER.unpack(header)
    if magic != RECORD_MAGIC:
        raise MXNetError("bad record magic at offset %d" % offset)
    buf = f.read(length)
    if len(buf) < length or zlib.crc32(buf) != crc:
        raise MXNetError("corrupt record at offset %d" % offset)
    return buf


def scan_offsets(uri: str) -> list[int]:
    """Every record's offset, by seeking from header to header (no payload
    read, no CRC check)."""
    offsets = []
    with open_uri(uri, "rb") as f:
        pos = 0
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break
            magic, _crc, length = _HEADER.unpack(header)
            if magic != RECORD_MAGIC:
                raise MXNetError(f"corrupt record file {uri!r}: bad magic")
            offsets.append(pos)
            pos += _HEADER.size + length + ((-length) % 8)
            f.seek(pos)
    return offsets


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR = struct.Struct("<IfQQ")


def pack(header: IRHeader, s: bytes) -> bytes:
    """An ``IRHeader`` and a payload as one record; ``flag > 0`` stores the
    label as a float32 vector of that length after the header."""
    header = IRHeader(*header)
    if header.flag > 0:
        label = np.asarray(header.label, dtype=np.float32)
        if label.size != header.flag:
            raise MXNetError("label length != flag")
        return _IR.pack(header.flag, 0.0, header.id, header.id2) \
            + label.tobytes() + s
    return _IR.pack(0, float(header.label), header.id, header.id2) + s


def unpack(s: bytes):
    """``(IRHeader, payload)`` of a record."""
    flag, label, id_, id2 = _IR.unpack(s[: _IR.size])
    s = s[_IR.size:]
    if flag > 0:
        vec = np.frombuffer(s[: flag * 4], dtype=np.float32)
        return IRHeader(flag, vec, id_, id2), s[flag * 4:]
    return IRHeader(0, label, id_, id2), s


def pack_img(header: IRHeader, img: np.ndarray, quality=95,
             img_fmt=".jpg") -> bytes:
    """Encode an HWC uint8 image and pack it: PNG by the port's codec, JPEG
    through PIL, or where PIL cannot be imported through the native
    library's encoder, which writes PIL's bytes."""
    from .io import _imaging

    return pack(header, _imaging.encode(img, img_fmt, quality))


def unpack_img(s: bytes):
    """A packed image record as ``(IRHeader, HWC uint8 RGB array)``."""
    from .io import _imaging

    header, img_bytes = unpack(s)
    return header, _imaging.decode(img_bytes)
