"""A small PNG reader and writer on ``zlib`` and numpy, and a PPM reader.

The port reads and writes images without ``imageio``, ``cv2`` or PIL (the
JAX package's codecs), which the GPU machine does not have. PNG: 8- and
16-bit samples, gray, RGB and RGBA, non-interlaced; reading undoes all five
row filters, writing uses filter 0. Other PNGs (palette, gray + alpha,
interlaced) raise. Arrays are (H, W) for gray and (H, W, channels)
otherwise, uint8 or uint16. PPM: binary (P6), 8-bit, read and written.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> channels.
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before IEND")


def _unfilter_slow(kind: int, raw: bytes, prev: bytearray,
                   bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on its left
    neighbour's decoded value, so they are decoded byte by byte."""
    cur = bytearray(raw)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _unfilter(buf: bytes, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    if len(buf) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {len(buf)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: a running sum over each byte lane, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = raw + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_slow(kind, raw.tobytes(),
                                               bytearray(prev.tobytes()),
                                               bpp), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> uint8 or uint16 (H, W[, channels])."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG color type {color} at {depth} bits "
                         "is not supported (8/16-bit gray, RGB, RGBA)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch, nbytes = _CHANNELS[color], depth // 8
    bpp = ch * nbytes
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp,
                       path)
    img = pixels.view(">u2").astype(np.uint16) if nbytes == 2 else pixels
    return img.reshape(h, w, ch)[..., 0] if ch == 1 else \
        img.reshape(h, w, ch)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode uint8 or uint16 (H, W) / (H, W, 1|3|4) as a PNG file."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"image must be (H, W) or (H, W, 1|3|4), got "
                         f"{img.shape}")
    h, w, ch = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_ppm(path: str) -> np.ndarray:
    """Decode a binary 8-bit PPM (P6) -> uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], *map(int, fields[1:])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"{path}: not a binary 8-bit PPM ({magic!r}, "
                         f"maxval {maxval})")
    return np.frombuffer(data, np.uint8, count=h * w * 3,
                         offset=pos + 1).reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Encode uint8 (H, W, 3) as a binary 8-bit PPM (P6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"PPM takes uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
            img).tobytes())
