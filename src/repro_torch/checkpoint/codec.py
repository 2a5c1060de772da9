"""A small MessagePack codec for the checkpoint file, streamed.

It covers the subset the checkpoints use (maps, arrays, bin, str, int,
float, bool, nil) and encodes each value as ``msgpack.packb`` does by
default (``use_bin_type=True``, the smallest integer form, float64), so
a file the port writes is byte for byte the file ``repro.checkpoint``
writes for the same tree.  The writer takes large binary payloads as
buffers written straight to the file; the reader reads large ``bin``
values into a writable ``bytearray`` in place, so neither side ever
builds one ``bytes`` object the size of a checkpoint.

Decoding follows ``msgpack.unpackb(raw=False)``: ``str`` comes back as
``str``, ``bin`` as ``bytes`` (``bytearray`` from ``LARGE_BIN`` bytes
up), arrays as lists.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO

LARGE_BIN = 1 << 16


def _int_header(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """The header of a sized value: fix form below ``fix_max``, then 8-
    (if ``codes`` has three), 16- and 32-bit lengths."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    fmts = (">B", ">H", ">I")[-len(codes):]
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit in 32 bits")


def bin_header(n: int) -> bytes:
    """The header of a ``bin`` of ``n`` bytes (its payload follows)."""
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, (0xDE, 0xDF))


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, (0xDC, 0xDD))


def packb(obj: Any) -> bytes:
    """``obj`` encoded (small values: the file's headers and metadata)."""
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        return _int_header(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _sized(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        return bin_header(len(data)) + data
    if isinstance(obj, (list, tuple)):
        return array_header(len(obj)) + b"".join(packb(v) for v in obj)
    if isinstance(obj, dict):
        return map_header(len(obj)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"can not serialize {type(obj).__name__!r} object")


class Reader:
    """Decodes one value at a time from a binary file."""

    def __init__(self, f: BinaryIO) -> None:
        self.f = f

    def _read(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise EOFError("truncated checkpoint")
        return data

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]

    def _bin(self, n: int) -> Any:
        if n < LARGE_BIN:
            return self._read(n)
        buf = bytearray(n)
        if self.f.readinto(buf) != n:
            raise EOFError("truncated checkpoint")
        return buf

    def read(self) -> Any:
        b = self._read(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._read(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return self._bin(self._unpack(lengths[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._read(self._unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


__all__ = ["LARGE_BIN", "Reader", "array_header", "bin_header",
           "map_header", "packb"]
