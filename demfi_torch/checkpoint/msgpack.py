"""MessagePack, the subset that flax's checkpoints use, in the standard
library.

``flax.serialization.to_bytes`` writes a parameter tree as one msgpack
object: nested maps with string keys, in the order the tree's dicts were
built, whose leaves are numpy arrays packed as extension type 1. The
payload of that extension is itself msgpack, the array
``(shape, dtype name, bytes in C order)``. flax packs with
``strict_types=True``: only an exact ``bool``, ``int``, ``float``,
``str``, ``bytes``, ``list``, ``tuple`` or ``dict`` packs as itself, and
anything else goes through its hook (a numpy scalar becomes extension
type 3, an array of its own; flax's complex numbers, type 2, are not
read or written here). Python floats pack as float64. Every
header takes its smallest form (fixext 1/2/4/8/16 where the payload's
length matches one exactly, else ext 8/16/32), so :func:`packb` of a tree
gives the bytes flax gives for it.

flax splits a leaf above 2^30 bytes into chunks
(``__msgpack_chunked_array__``); a parameter of DeMFI-Net is far below
that, and this codec refuses the chunked form on both sides rather than
misread it.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_LEAF_BYTES = 2 ** 30          # flax's MAX_CHUNK_SIZE
CHUNKED_KEY = "__msgpack_chunked_array__"

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0 <= n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < 0:
        return struct.pack(">Bh", 0xD1, n)
    if 0 <= n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < 0:
        return struct.pack(">Bi", 0xD2, n)
    if 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < 0:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, h8: int, h16: int,
            h32: int) -> bytes:
    """A length header: the fix form up to fix_max, else 8/16/32 bits
    (h8 None: no 8-bit form)."""
    if n <= fix_max:
        return struct.pack("B", fix | n)
    if h8 is not None and n <= 0xFF:
        return struct.pack("BB", h8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", h16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", h32, n)
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _bin(b: bytes) -> bytes:
    n = len(b)
    if n <= 0xFF:
        head = struct.pack("BB", 0xC4, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC5, n)
    elif n <= 0xFFFFFFFF:
        head = struct.pack(">BI", 0xC6, n)
    else:
        raise ValueError(f"bin of {n} bytes is too large for msgpack")
    return head + bytes(b)


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in _FIXEXT:
        head = struct.pack("Bb", _FIXEXT[n], code)
    elif n <= 0xFF:
        head = struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        head = struct.pack(">BHb", 0xC8, n, code)
    elif n <= 0xFFFFFFFF:
        head = struct.pack(">BIb", 0xC9, n, code)
    else:
        raise ValueError(f"ext of {n} bytes is too large for msgpack")
    return head + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes
    in C order)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return packb((tuple(int(s) for s in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _pack(obj: Any, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t in (bytes, bytearray):
        out.append(_bin(bytes(obj)))
    elif t is str:
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 0x1F, 0xD9, 0xDA, 0xDB) + b)
    elif t in (list, tuple):
        out.append(_header(len(obj), 0x90, 0x0F, None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif t is dict:
        out.append(_header(len(obj), 0x80, 0x0F, None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_LEAF_BYTES:
            raise ValueError(
                f"an array of {obj.nbytes} bytes: flax would write it in "
                f"its chunked form ({CHUNKED_KEY}), which this codec does "
                f"not write")
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj))))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` as ``flax.serialization.msgpack_serialize``
    writes them (``strict_types=True``, bin type on)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _dtype(name: bytes) -> np.dtype:
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"array of dtype {name!r}: not a numpy dtype (a "
                         f"bfloat16 leaf needs JAX's ml_dtypes), which "
                         f"this codec does not read") from None


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = _unpack_all(data, raw=True)
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape, order="C")


def _from_ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"msgpack extension type {code}: not a numpy array or "
                     f"scalar, which this codec does not read")


def _obj(r: _Reader, raw: bool) -> Any:
    (b,) = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_obj(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        (n,) = r.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n, code = r.unpack({0xC7: ">Bb", 0xC8: ">Hb", 0xC9: ">Ib"}[b])
        return _from_ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")[0]
    if b == 0xCB:
        return r.unpack(">d")[0]
    fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}.get(b)
    if fmt:
        return r.unpack(fmt)[0]
    if 0xD4 <= b <= 0xD8:
        (code,) = r.unpack("b")
        return _from_ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):
        (n,) = r.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r, n, raw)
    if b in (0xDC, 0xDD):
        (n,) = r.unpack(">H" if b == 0xDC else ">I")
        return [_obj(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        (n,) = r.unpack(">H" if b == 0xDE else ">I")
        return _map(r, n, raw)
    raise ValueError(f"byte 0x{b:02x} at {r.pos - 1} starts no msgpack object")


def _str(r: _Reader, n: int, raw: bool):
    b = bytes(r.take(n))
    return b if raw else b.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _obj(r, raw)
        out[k] = _obj(r, raw)
    if CHUNKED_KEY in out:
        raise ValueError(
            f"a leaf in flax's chunked-array form ({CHUNKED_KEY}, for "
            f"arrays above {MAX_LEAF_BYTES} bytes): this codec does not "
            f"read it")
    return out


def _unpack_all(data: bytes, raw: bool) -> Any:
    r = _Reader(data)
    obj = _obj(r, raw)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         f"object")
    return obj


def unpackb(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: dicts, lists, str, bytes, numbers, None and numpy arrays
    (read-only views of ``data``; copy one to write to it)."""
    return _unpack_all(bytes(data), raw=False)
