"""PNG decode/encode with zlib and numpy.

The JAX package decodes and encodes PNGs in its native host library
(native/gr_native.cpp) with PIL as a fallback; the port needs neither. The
decoder covers what that library covers: non-interlaced, bit depth 8, color
types 0 (gray), 2 (RGB), 3 (palette, with tRNS), 4 (gray+alpha) and 6
(RGBA). Output is always RGBA8.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_sequential(kind: int, line: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) depend on the reconstructed left byte."""
    out = bytearray(line)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        up = prev[i]
        if kind == 3:
            out[i] = (out[i] + ((left + up) >> 1)) & 0xFF
        else:
            up_left = prev[i - bpp] if i >= bpp else 0
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else up_left)
            out[i] = (out[i] + pred) & 0xFF
    return out


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 RGBA; raises ValueError on a format
    outside the supported set."""
    if data[: len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat, plte, trns = None, [], None, b""
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, bit_depth, color_type, _, _, interlace = header
    if bit_depth != 8 or interlace != 0 or color_type not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {bit_depth}, color type {color_type}, "
            f"interlace {interlace})"
        )
    bpp = _CHANNELS[color_type]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.int64) & 0xFF)
            cur = cur.astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            cur = np.frombuffer(
                _unfilter_sequential(kind, line.tobytes(), prev.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        img[y] = cur
        prev = img[y]
    px = img.reshape(h, w, bpp)
    out = np.empty((h, w, 4), np.uint8)
    if color_type == 0:
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 2:
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 3:
        if plte is None or int(px.max(initial=0)) >= len(plte):
            raise ValueError("PNG palette index out of range")
        idx = px[..., 0]
        out[..., :3] = plte[idx]
        alpha = np.full(256, 255, np.uint8)
        alpha[: len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        out[..., 3] = alpha[idx]
    elif color_type == 4:
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    else:
        out[...] = px
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def png_encode(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (color type 2, filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
