"""A MessagePack codec for the metadata of a checkpoint, in plain Python.

:func:`packb` writes the subset of MessagePack that a checkpoint's
``tree.msgpack`` holds, byte for byte as ``msgpack.packb`` writes it with
its defaults: maps and arrays (fix, 16 and 32 bit lengths; tuples are
arrays), str (fixstr, str8, str16, str32; UTF-8), int in its smallest
encoding (positive and negative fixint, uint8-64 for values >= 0, int8-64
for negatives), float as float64, bool and nil.  :func:`unpackb` reads
that subset back (maps as dicts with str keys, arrays as lists, as
``msgpack.unpackb`` does by default).  Anything else (bin, ext, float32,
a numpy scalar, an int past 64 bits, a non-str map key on reading) raises:
the codec never guesses.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        elif n < 1 << 32:
            out.append(b"\xdb" + struct.pack(">I", n))
        else:
            raise ValueError(f"str of {n} bytes is too long for MessagePack")
        out.append(data)
    elif type(obj) in (list, tuple):
        out.append(_header(len(obj), 0x90, b"\xdc", b"\xdd", "array"))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        out.append(_header(len(obj), 0x80, b"\xde", b"\xdf", "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(obj).__name__} {obj!r}: "
                        "only dict, list, tuple, str, int, float, bool and None")


def _header(n: int, fix: int, b16: bytes, b32: bytes, kind: str) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return b16 + struct.pack(">H", n)
    if n < 1 << 32:
        return b32 + struct.pack(">I", n)
    raise ValueError(f"{kind} of {n} entries is too long for MessagePack")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, limit in ((b"\xcc", ">B", 1 << 8), (b"\xcd", ">H", 1 << 16),
                                 (b"\xce", ">I", 1 << 32), (b"\xcf", ">Q", 1 << 64)):
            if x < limit:
                return code + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((b"\xd0", ">b", 1 << 7), (b"\xd1", ">h", 1 << 15),
                                 (b"\xd2", ">i", 1 << 31), (b"\xd3", ">q", 1 << 63)):
            if x >= -limit:
                return code + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit 64 bits")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# (format byte) -> (struct format, size) of the fixed-width scalars
_SCALARS = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
            0xCB: (">d", 8)}
_STR = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}
_ARRAY = {0xDC: (">H", 2), 0xDD: (">I", 4)}
_MAP = {0xDE: (">H", 2), 0xDF: (">I", 4)}


def _unpack(data: bytes, i: int) -> Tuple[Any, int]:
    if i >= len(data):
        raise ValueError("truncated MessagePack data")
    b = data[i]
    i += 1

    def take(fmt: str, size: int):
        if i + size > len(data):
            raise ValueError("truncated MessagePack data")
        return struct.unpack_from(fmt, data, i)[0]

    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        return _str(data, i, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(data, i, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(data, i, b & 0x0F)
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in _SCALARS:
        fmt, size = _SCALARS[b]
        return take(fmt, size), i + size
    if b in _STR:
        fmt, size = _STR[b]
        return _str(data, i + size, take(fmt, size))
    if b in _ARRAY:
        fmt, size = _ARRAY[b]
        return _array(data, i + size, take(fmt, size))
    if b in _MAP:
        fmt, size = _MAP[b]
        return _map(data, i + size, take(fmt, size))
    raise ValueError(f"msgpack_lite does not read format byte 0x{b:02x} (bin, ext and "
                     f"float32 are outside a checkpoint's metadata)")


def _str(data: bytes, i: int, n: int) -> Tuple[str, int]:
    if i + n > len(data):
        raise ValueError("truncated MessagePack data")
    return data[i:i + n].decode("utf-8"), i + n


def _array(data: bytes, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, i = _unpack(data, i)
        out.append(item)
    return out, i


def _map(data: bytes, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        if type(k) is not str:
            raise ValueError(f"map key {k!r} is not a str")
        out[k], i = _unpack(data, i)
    return out, i


def unpackb(data: bytes) -> Any:
    """The object of one MessagePack message (the whole of ``data``)."""
    obj, i = _unpack(bytes(data), 0)
    if i != len(data):
        raise ValueError(f"{len(data) - i} bytes left after the MessagePack message")
    return obj
