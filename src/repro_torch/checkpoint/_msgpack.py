"""The subset of MessagePack that checkpoint manifests and leaf headers use.

Maps (str keys), arrays (lists and tuples), str, int, float, bool and nil,
encoded byte for byte as ``msgpack.packb`` encodes them with its defaults
(the smallest integer format, floats as float64, str8 for strings of
32-255 bytes), so that a checkpoint written here reads in the reference and
back, without a dependency on the ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["packb", "unpackb", "unpack"]


_UINT = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
         (0xCF, ">Q", 1 << 64))
_NEG = ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
        (0xD3, ">q", 1 << 63))


def _pack_int(n: int, out: bytearray):
    if -32 <= n < 0x80:                 # positive and negative fixint
        out.append(n & 0xFF)
        return
    for code, fmt, top in (_UINT if n >= 0 else _NEG):
        if (n < top if n >= 0 else -n <= top):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"int {n} does not fit msgpack's 64-bit formats")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray):
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit), ...) whose limit exceeds n."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj: Any, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, _STR, out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: only str keys are packed")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} ({obj!r})")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_LENGTH = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
           0xDC: (">H", "array"), 0xDD: (">I", "array"),
           0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpack(buf, off: int = 0) -> Tuple[Any, int]:
    """Decode one object from ``buf`` at ``off``: (object, offset after)."""
    b = buf[off]
    off += 1
    if b < 0x80:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], off
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, off)[0], off + \
            struct.calcsize(fmt)
    if b & 0xE0 == 0xA0:
        kind, n = "str", b & 0x1F
    elif b & 0xF0 == 0x90:
        kind, n = "array", b & 0x0F
    elif b & 0xF0 == 0x80:
        kind, n = "map", b & 0x0F
    elif b in _LENGTH:
        fmt, kind = _LENGTH[b]
        n = struct.unpack_from(fmt, buf, off)[0]
        off += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} at {off - 1} is "
                         f"outside the subset checkpoints use")
    if kind == "str":
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, off = unpack(buf, off)
            out.append(x)
        return out, off
    d = {}
    for _ in range(n):
        k, off = unpack(buf, off)
        d[k], off = unpack(buf, off)
    return d, off


def unpackb(buf) -> Any:
    """Decode a buffer that holds exactly one object."""
    obj, off = unpack(buf, 0)
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes after the object")
    return obj
