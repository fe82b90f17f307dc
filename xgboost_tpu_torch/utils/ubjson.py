"""Minimal UBJSON codec (draft-12 subset).

The reference serializes models to UBJSON via ``UBJReader``/``UBJWriter``
(``include/xgboost/json_io.h:203,245``). This implements the subset needed for
model round-trips: objects, arrays, strings, bools, null, int8/16/32/64,
float32/64, with sized containers on write for compactness.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO


def dump_ubjson(obj: Any, fh: BinaryIO) -> None:
    fh.write(dumps_ubjson(obj))


def dumps_ubjson(obj: Any) -> bytes:
    out = io.BytesIO()
    _write(obj, out)
    return out.getvalue()


def load_ubjson(fh: BinaryIO) -> Any:
    return loads_ubjson(fh.read())


def loads_ubjson(raw: bytes) -> Any:
    val, _ = _read(raw, 0)
    return val


def _write_int(n: int, out: io.BytesIO) -> None:
    if -(2 ** 7) <= n < 2 ** 7:
        out.write(b"i" + struct.pack(">b", n))
    elif 0 <= n < 2 ** 8:
        out.write(b"U" + struct.pack(">B", n))
    elif -(2 ** 15) <= n < 2 ** 15:
        out.write(b"I" + struct.pack(">h", n))
    elif -(2 ** 31) <= n < 2 ** 31:
        out.write(b"l" + struct.pack(">i", n))
    else:
        out.write(b"L" + struct.pack(">q", n))


def _write_str_payload(s: str, out: io.BytesIO) -> None:
    b = s.encode("utf-8")
    _write_int(len(b), out)
    out.write(b)


def _write(obj: Any, out: io.BytesIO) -> None:
    if obj is None:
        out.write(b"Z")
    elif obj is True:
        out.write(b"T")
    elif obj is False:
        out.write(b"F")
    elif isinstance(obj, int):
        _write_int(obj, out)
    elif isinstance(obj, float):
        out.write(b"D" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        out.write(b"S")
        _write_str_payload(obj, out)
    elif isinstance(obj, dict):
        out.write(b"{")
        for k, v in obj.items():
            _write_str_payload(str(k), out)
            _write(v, out)
        out.write(b"}")
    elif isinstance(obj, (list, tuple)):
        out.write(b"[")
        for v in obj:
            _write(v, out)
        out.write(b"]")
    else:
        import numpy as np
        if isinstance(obj, np.integer):
            _write_int(int(obj), out)
        elif isinstance(obj, np.floating):
            out.write(b"D" + struct.pack(">d", float(obj)))
        elif isinstance(obj, np.ndarray):
            tag = _TYPED_TAG.get(obj.dtype.str.lstrip("<>=|"))
            if obj.ndim == 1 and tag is not None:
                # strongly-typed sized array ("[$<t>#<n><payload>"): the
                # reference UBJWriter emits these for model arrays and our
                # reader already decodes them — 1 byte/element for u8
                # (snapshot payloads) vs 9 for element-wise D tags
                out.write(b"[$" + tag + b"#")
                _write_int(obj.shape[0], out)
                out.write(np.ascontiguousarray(
                    obj, obj.dtype.newbyteorder(">")).tobytes())
            else:
                _write(obj.tolist(), out)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            import numpy as np

            _write(np.frombuffer(bytes(obj), np.uint8), out)
        else:
            raise TypeError(f"cannot UBJSON-encode {type(obj)}")


_INT_FMT = {b"i": (">b", 1), b"U": (">B", 1), b"I": (">h", 2),
            b"l": (">i", 4), b"L": (">q", 8)}

# strongly-typed array payload dtypes (big-endian per the UBJSON spec)
_TYPED_DTYPE = {b"i": ">i1", b"U": ">u1", b"I": ">i2", b"l": ">i4",
                b"L": ">i8", b"d": ">f4", b"D": ">f8"}

# inverse map for the writer (numpy dtype.str without byte order -> tag)
_TYPED_TAG = {"i1": b"i", "u1": b"U", "i2": b"I", "i4": b"l", "i8": b"L",
              "f4": b"d", "f8": b"D"}


def _read_int(raw: bytes, pos: int):
    tag = raw[pos:pos + 1]
    fmt, size = _INT_FMT[tag]
    return struct.unpack_from(fmt, raw, pos + 1)[0], pos + 1 + size


def _read_str_payload(raw: bytes, pos: int):
    n, pos = _read_int(raw, pos)
    return raw[pos:pos + n].decode("utf-8"), pos + n


def _read(raw: bytes, pos: int):
    tag = raw[pos:pos + 1]
    if tag == b"Z":
        return None, pos + 1
    if tag == b"T":
        return True, pos + 1
    if tag == b"F":
        return False, pos + 1
    if tag in _INT_FMT:
        return _read_int(raw, pos)
    if tag == b"d":
        return struct.unpack_from(">f", raw, pos + 1)[0], pos + 5
    if tag == b"D":
        return struct.unpack_from(">d", raw, pos + 1)[0], pos + 9
    if tag == b"S":
        return _read_str_payload(raw, pos + 1)
    if tag == b"{":
        pos += 1
        count = None
        if raw[pos:pos + 1] == b"#":  # sized object
            count, pos = _read_int(raw, pos + 1)
        obj = {}
        while (len(obj) < count) if count is not None \
                else (raw[pos:pos + 1] != b"}"):
            key, pos = _read_str_payload(raw, pos)
            val, pos = _read(raw, pos)
            obj[key] = val
        return obj, pos + (count is None)
    if tag == b"[":
        pos += 1
        typ = None
        count = None
        if raw[pos:pos + 1] == b"$":  # strongly-typed array (reference
            typ = raw[pos + 1:pos + 2]  # UBJWriter writes these for model
            pos += 2                    # arrays, include/xgboost/json_io.h)
            if raw[pos:pos + 1] != b"#":
                raise ValueError("typed UBJSON array missing count")
        if raw[pos:pos + 1] == b"#":
            count, pos = _read_int(raw, pos + 1)
        if typ is not None:
            if typ in _TYPED_DTYPE:
                import numpy as np

                dt = np.dtype(_TYPED_DTYPE[typ])
                end = pos + count * dt.itemsize
                arr = np.frombuffer(raw, dt, count, pos)
                return arr.astype(dt.newbyteorder("=")), end
            if typ == b"S":
                out = []
                for _ in range(count):
                    s, pos = _read_str_payload(raw, pos)
                    out.append(s)
                return out, pos
            if typ in (b"T", b"F", b"Z"):
                return [{b"T": True, b"F": False, b"Z": None}[typ]] * count, pos
            if typ == b"C":
                return [chr(c) for c in raw[pos:pos + count]], pos + count
            raise ValueError(f"unsupported typed-array tag {typ!r}")
        arr = []
        while (len(arr) < count) if count is not None \
                else (raw[pos:pos + 1] != b"]"):
            val, pos = _read(raw, pos)
            arr.append(val)
        return arr, pos + (count is None)
    raise ValueError(f"bad UBJSON tag {tag!r} at {pos}")
