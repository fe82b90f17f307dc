"""Restricted wire codec for host-side collectives (the port of the JAX
package's ``parallel/wire.py``, byte for byte the same format).

The reference's federated plugin deliberately moves only protobuf messages
between mutually-distrusting parties (``plugin/federated/federated.proto``).
The analogue here: a self-describing binary codec whose decoder can ONLY
construct ``None``/``bool``/``int``/``float``/``str``/``bytes``,
numeric ``numpy`` arrays, and lists/tuples/dicts of those — never arbitrary
objects, so a malicious peer's payload cannot execute code the way a pickle
can.

Format: one tag byte per value, little-endian fixed-width lengths.
Arrays serialize as ``(dtype-str, shape, C-order raw bytes)``; object dtypes
are rejected on both encode and decode.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_MAX_DEPTH = 64

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class WireError(ValueError):
    pass


def _enc_u32(out: list, n: int) -> None:
    if not 0 <= n < 2**32:
        raise WireError(f"length {n} out of range")
    out.append(_U32.pack(n))


def _encode(obj: Any, out: list, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep")
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        i = int(obj)
        if -(2**63) <= i < 2**63:
            out.append(b"i")
            out.append(_I64.pack(i))
        else:  # arbitrary-precision int as decimal text
            s = str(i).encode()
            out.append(b"I")
            _enc_u32(out, len(s))
            out.append(s)
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f")
        out.append(_F64.pack(float(obj)))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"s")
        _enc_u32(out, len(b))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b"b")
        _enc_u32(out, len(obj))
        out.append(bytes(obj))
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise WireError("object-dtype arrays are not wire-safe")
        dt = obj.dtype.str.encode()  # e.g. b'<f4' — byte order explicit
        raw = np.ascontiguousarray(obj).tobytes()
        out.append(b"a")
        _enc_u32(out, len(dt))
        out.append(dt)
        _enc_u32(out, obj.ndim)
        for d in obj.shape:
            _enc_u32(out, d)
        _enc_u32(out, len(raw))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(b"l" if isinstance(obj, list) else b"t")
        _enc_u32(out, len(obj))
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(b"d")
        _enc_u32(out, len(obj))
        for k, v in obj.items():
            _encode(k, out, depth + 1)
            _encode(v, out, depth + 1)
    else:
        raise WireError(
            f"type {type(obj).__name__} is not wire-safe; allowed: None, "
            "bool, int, float, str, bytes, numeric ndarray, list/tuple/dict")


def encode(obj: Any) -> bytes:
    out: list = []
    _encode(obj, out, 0)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise WireError("truncated payload")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _decode(r: _Reader, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep")
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _I64.unpack(r.take(8))[0]
    if tag == b"I":
        return int(r.take(r.u32()).decode())
    if tag == b"f":
        return _F64.unpack(r.take(8))[0]
    if tag == b"s":
        return r.take(r.u32()).decode("utf-8")
    if tag == b"b":
        return bytes(r.take(r.u32()))
    if tag == b"a":
        dt = np.dtype(r.take(r.u32()).decode("ascii"))
        if dt.hasobject:
            raise WireError("object-dtype arrays are not wire-safe")
        shape = tuple(r.u32() for _ in range(r.u32()))
        raw = r.take(r.u32())
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if n * dt.itemsize != len(raw):
            raise WireError("array byte count mismatch")
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag in (b"l", b"t"):
        items = [_decode(r, depth + 1) for _ in range(r.u32())]
        return items if tag == b"l" else tuple(items)
    if tag == b"d":
        n = r.u32()
        out = {}
        for _ in range(n):
            k = _decode(r, depth + 1)
            out[k] = _decode(r, depth + 1)
        return out
    raise WireError(f"unknown tag {tag!r}")


def decode(buf: bytes) -> Any:
    r = _Reader(bytes(buf))
    obj = _decode(r, 0)
    if r.pos != len(r.buf):
        raise WireError("trailing bytes after payload")
    return obj
