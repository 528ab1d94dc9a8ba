"""Image files and the bilinear resize, in numpy and the standard library.

The card's machine has neither PIL nor OpenCV, so the port decodes PNG
itself (``zlib`` + numpy: 8-bit gray, RGB and RGBA, non-interlaced, all
five row filters) and writes it (``write_png``, the synthetic dataset's
writer).  JPEG is read through PIL only where PIL happens to be
installed; without it ``read_image`` raises, naming the file and the
missing decoder.  ``resize_linear`` is the one bilinear resize of the
port (the dataset's /8 snapping and the serve path's ``prepare_image``).

Row filters 0 (None), 1 (Sub) and 2 (Up) decode as whole-row numpy
operations; 3 (Average) and 4 (Paeth) depend on the decoded left
neighbour and run a Python loop over the row's bytes — correct, but
about a second for a 576 x 768 RGB image: PNGs written by
``write_png`` (filter 0) never take that path.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types the decoder takes
_COLOR_CHANNELS = {0: 1, 2: 3, 6: 4}
_CHANNEL_COLOR = {v: k for k, v in _COLOR_CHANNELS.items()}


class ImageDecodeError(ValueError):
    """The file is not an image this package can decode (names the file)."""


# -- PNG -----------------------------------------------------------------
def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ImageDecodeError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ImageDecodeError(f"{path}: truncated PNG (no IEND chunk)")


def _ihdr(body: bytes, path: str) -> Tuple[int, int, int]:
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or color not in _COLOR_CHANNELS or comp or filt or interlace:
        raise ImageDecodeError(
            f"{path}: PNG with bit depth {depth}, colour type {color}, "
            f"interlace {interlace} — this decoder takes 8-bit gray (0), "
            f"RGB (2) or RGBA (6), non-interlaced")
    return h, w, _COLOR_CHANNELS[color]


def png_shape(path: str) -> Tuple[int, int]:
    """(H, W) from the PNG header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ImageDecodeError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _unfilter_sequential(kind: int, cur: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4): each byte needs the decoded byte bpp to
    its left, so the row decodes byte by byte, in place."""
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


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit gray/RGB/RGBA non-interlaced PNG -> uint8 (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ImageDecodeError(f"{path}: not a PNG file")
    shape = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            shape = _ihdr(body, path)
        elif kind == b"IDAT":
            idat.append(body)
    if shape is None or not idat:
        raise ImageDecodeError(f"{path}: PNG without IHDR or IDAT")
    h, w, ch = shape
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ImageDecodeError(f"{path}: PNG image data is {raw.size} bytes, "
                               f"want {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, x = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = x
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(x.reshape(w, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = x + prev
        elif kind in (3, 4):
            buf = bytearray(x.tobytes())
            _unfilter_sequential(kind, buf, prev.tobytes(), ch)
            cur = np.frombuffer(buf, np.uint8)
        else:
            raise ImageDecodeError(f"{path}: row {y} has PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, ch)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, image: np.ndarray, *, filter_type: int = 0,
              level: int = 6) -> None:
    """Encode uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) as PNG, every
    row with ``filter_type`` (0-4; the encoder's filters are computed from
    raw bytes, so all five vectorise)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _CHANNEL_COLOR:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {ch}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter types are 0-4, got {filter_type}")
    x = img.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(x)
    left[:, ch:] = x[:, :-ch]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, ch:] = x[:-1, :-ch]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}[filter_type]
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _CHANNEL_COLOR[ch], 0, 0, 0)
    blob = (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


# -- any image -----------------------------------------------------------
def _pil(path: str):
    try:
        from PIL import Image
    except ImportError:
        raise ImageDecodeError(
            f"{path}: not a PNG, and PIL (the only other decoder this "
            f"package uses, for JPEG) is not installed") from None
    return Image


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def image_shape(path: str) -> Tuple[int, int]:
    """(H, W) from the file's header."""
    if _is_png(path):
        return png_shape(path)
    with _pil(path).open(path) as im:
        w, h = im.size
    return h, w


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3): gray expanded to 3 channels, alpha dropped."""
    if _is_png(path):
        arr = read_png(path)
    else:
        with _pil(path).open(path) as im:
            if im.mode not in ("RGB", "RGBA", "L"):
                im = im.convert("RGB")
            arr = np.asarray(im)
        if arr.dtype != np.uint8:
            raise ImageDecodeError(f"{path}: {arr.dtype} pixels, want 8-bit")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


# -- bilinear resize -----------------------------------------------------
def _linear_taps(src: int, dst: int):
    """Source rows and weights of a half-pixel-centre bilinear resize
    (OpenCV's INTER_LINEAR rule: clamp at both edges)."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    low = i0 < 0
    frac[low], i0[low] = 0.0, 0
    high = i0 >= src - 1
    frac[high], i0[high] = 0.0, src - 1
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear (H, W) or (H, W, C) resize with half-pixel centres,
    computed in f32; u8 input is rounded back to u8 (within one level of
    ``cv2.resize``), float input keeps its dtype."""
    h, w = image.shape[:2]
    y0, y1, fy = _linear_taps(h, out_h)
    x0, x1, fx = _linear_taps(w, out_w)
    img = image.astype(np.float32)
    tail = (1,) * (img.ndim - 2)
    fy = fy.reshape((-1, 1) + tail)
    rows = img[y0] * (1.0 - fy) + img[y1] * fy
    fx = fx.reshape((1, -1) + tail)
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    if image.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)
