"""PNG decoding and bilinear resizing with zlib and numpy only.

Replaces ``Image.open(p).convert("RGB").resize((n, n), Image.BILINEAR)``
(miniworld_tpu/render/textures.py:_load_tile) so that the port builds
the same texture atlas without Pillow:

  * ``read_png_rgb`` decodes 8-bit, non-interlaced PNGs of colour type
    0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) to
    (H, W, 3) uint8, dropping alpha the way ``convert("RGB")`` does.
  * ``resize_bilinear`` reproduces Pillow's fixed-point BILINEAR
    resample byte for byte: triangle filter with support
    ``max(in/out, 1)``, weights normalised to sum 1 and rounded to
    22-bit fixed point, the horizontal pass first into uint8, then the
    vertical pass.
  * ``resize_bicubic`` does the same with Pillow's default BICUBIC
    filter: ``Image.resize((n, n))`` as the JAX package's mesh colours
    call it (miniworld_tpu/scene/entities.py:_face_colors_areas).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c


def _chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def png_size(path: str) -> tuple:
    """(width, height) from the IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _unfilter(raw: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters.

    Pixel (y, x) depends on its left, upper and upper-left neighbours,
    so every anti-diagonal y + x = d depends only on diagonals d-1 and
    d-2: each diagonal is one vectorised step over all rows.
    """
    h, w = raw.shape[:2]
    # out[y + 1, x + 1] = pixel (y, x); row 0 and column 0 are zero
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    filt = raw.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]  # left
        b = out[ys, xs + 1]  # up
        c = out[ys, xs]  # up-left
        ft = ftypes[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of an 8-bit non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    idat, palette, ihdr = [], None, None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace})"
        )
    bpp = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0], bpp)
    if ctype == 3:
        return palette[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _bilinear(x: np.ndarray) -> np.ndarray:
    """Pillow's triangle filter, support 1."""
    return np.maximum(0.0, 1.0 - np.abs(x))


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (Keys, a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
    )


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _weights(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """(out, in) int64 fixed-point weights of Pillow's resample filter
    ``kind`` (Resample.c precompute_coeffs / normalize_coeffs_8bpc):
    negative lobes round half away from zero."""
    filt, filt_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filt_support * filterscale
    ss = 1.0 / filterscale
    wts = np.zeros((out_size, in_size), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        # Pillow truncates toward zero after adding 0.5
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = filt((np.arange(xmax) + xmin - center + 0.5) * ss)
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        wts[i, xmin:xmin + xmax] = np.where(
            w < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5)
        ).astype(np.int64)
    return wts


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    wts = _weights(img.shape[axis], out_size, kind)
    moved = np.moveaxis(img, axis, -1).astype(np.float64)  # (..., in)
    # float64 BLAS is exact here: every product and partial sum is an
    # integer of magnitude below 2**35, so the sum order cannot change
    # the result
    acc = (moved @ wts.T.astype(np.float64)).astype(np.int64)
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def _resize(img: np.ndarray, width: int, height: int, kind: str) -> np.ndarray:
    out = img
    if out.shape[1] != width:
        out = _resample_axis(out, width, axis=1, kind=kind)
    if out.shape[0] != height:
        out = _resample_axis(out, height, axis=0, kind=kind)
    return np.ascontiguousarray(out)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow ``resize((width, height), BILINEAR)`` of (H, W, C) uint8."""
    return _resize(img, width, height, "bilinear")


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow ``resize((width, height))`` of (H, W, C) uint8: its default
    BICUBIC filter, same fixed point and pass order as BILINEAR."""
    return _resize(img, width, height, "bicubic")
