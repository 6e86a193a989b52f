"""PNG files in and out, as BGR uint8 [H, W, 3] arrays.

``cv2`` does the work when it imports (users who installed the
reference's requirements have it). Without it, 8-bit non-interlaced PNGs
(gray, RGB, and either with an alpha channel, which is dropped) are read
and written with ``zlib`` and numpy alone. Both routes return and take
the same arrays, so everything above this module is the same on either.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, for the types read here
_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imread(path: str) -> np.ndarray:
    """Read an image file as BGR uint8 [H, W, 3] (a gray file is
    repeated over the three channels, alpha is dropped)."""
    cv2 = _cv2()
    if cv2 is None:
        return read_png(path)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def imwrite(path: str, bgr_u8: np.ndarray) -> None:
    """Write BGR uint8 [H, W, 3] (or gray [H, W]) as an 8-bit PNG."""
    img = np.ascontiguousarray(bgr_u8)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"imwrite: expected uint8 [H,W] or [H,W,3], got "
                         f"{img.dtype} {img.shape}")
    cv2 = _cv2()
    if cv2 is None:
        write_png(path, img)
    elif not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")


# ------------------------------------------------------------ numpy route
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, bgr_u8: np.ndarray) -> None:
    """The numpy route of :func:`imwrite`: every row with filter 0 (none),
    deflate level 1."""
    h, w = bgr_u8.shape[:2]
    gray = bgr_u8.ndim == 2
    rows = (bgr_u8 if gray else bgr_u8[:, :, ::-1]).reshape(h, -1)
    raw = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              0 if gray else 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo PNG's per-row filters. ftype [H] in 0..4, data [H, W, S] uint8
    as stored; returns the pixels.

    Each pixel's predictor reads its left, upper and upper-left
    neighbours, so the pixels of one anti-diagonal are independent: the
    image is rebuilt in H + W - 1 steps, each one numpy expression over a
    whole diagonal and all S samples, whatever the mix of filters (Sub,
    Up, Average, Paeth). A file whose rows all use filter 0, which is
    what :func:`write_png` writes, returns at once. At 720p a file with
    other filters takes 1,999 steps, about 0.1 s; a per-pixel loop would
    take 921,600."""
    if not ftype.any():
        return data
    if ftype.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    h, w, s = data.shape
    # one zero row above and one zero column left of the image
    rec = np.zeros((h + 1, w + 1, s), np.int32)
    stored = data.astype(np.int32)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        c = k - r
        a = rec[r + 1, c]                     # left
        b = rec[r, c + 1]                     # up
        ul = rec[r, c]                        # upper left
        p = a + b - ul
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.choose(ftype[r][:, None],
                         [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        rec[r + 1, c + 1] = (stored[r, c] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The numpy route of :func:`imread`."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(blob):
        (length,), kind = struct.unpack(">I", blob[pos:pos + 4]), \
            blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _SAMPLES or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB PNGs are read "
            f"without cv2 (depth {depth}, colour type {ctype}, interlace "
            f"{interlace})")
    s = _SAMPLES[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * s):
        raise ValueError(f"{path}: PNG data of the wrong length")
    raw = raw.reshape(h, 1 + w * s)
    px = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, s))
    if s in (2, 4):                       # drop alpha
        px = px[:, :, :s - 1]
    if px.shape[2] == 1:
        px = np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, ::-1])
