"""Image files and the bilinear resize, in numpy and the standard library.

The card's machine has neither PIL nor OpenCV, so the port decodes PNG
itself (``zlib`` + numpy: 8-bit gray, RGB and RGBA, non-interlaced, all
five row filters) and writes it (``write_png``, the synthetic dataset's
writer).  JPEG pixels are read through PIL only where PIL happens to be
installed; without it ``read_image`` raises, naming the file and the
missing decoder.  Sizes need no decoder: ``image_size`` reads a PNG's
IHDR chunk or a JPEG's start-of-frame marker.  ``resize_linear`` is the one bilinear resize of the
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


# JPEG start-of-frame markers that carry the frame size: baseline (SOF0),
# extended (SOF1), progressive (SOF2) and the rarer lossless and
# arithmetic-coded ones; 0xC4 (DHT), 0xC8 (JPG) and 0xCC (DAC) share the
# range but are not frames
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
             0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _jpeg_size(f, path: str) -> Tuple[int, int]:
    """(W, H) from the first start-of-frame segment of a JPEG whose SOI
    marker has been read."""
    while True:
        byte = f.read(1)
        while byte == b"\xff":  # fill bytes before a marker
            byte = f.read(1)
        if not byte:
            break
        marker = byte[0]
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue  # standalone markers: no length
        head = f.read(2)
        if len(head) < 2:
            break
        (length,) = struct.unpack(">H", head)
        if marker in _JPEG_SOF:
            body = f.read(5)
            if len(body) < 5:
                break
            _, h, w = struct.unpack(">BHH", body)
            return w, h
        if marker == 0xD9 or length < 2:
            break
        f.seek(length - 2, os.SEEK_CUR)
        # the byte after a segment must start the next marker
        if f.read(1) != b"\xff":
            break
        f.seek(-1, os.SEEK_CUR)
    raise ImageDecodeError(f"{path}: JPEG with no start-of-frame marker")


def image_size(path: str) -> Tuple[int, int]:
    """(W, H) — PIL's ``Image.size`` — from the file's header alone: the
    IHDR chunk of a PNG, the first start-of-frame marker (SOF0, SOF2, ...)
    of a JPEG.  No pixel is decoded and no PIL is needed."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
        if head == PNG_SIGNATURE:
            f.read(4)  # IHDR's length
            if f.read(4) != b"IHDR":
                raise ImageDecodeError(f"{path}: PNG without a leading IHDR")
            w, h = struct.unpack(">II", f.read(8))
            return w, h
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            return _jpeg_size(f, path)
    raise ImageDecodeError(f"{path}: neither PNG nor JPEG (by its first bytes)")


def image_shape(path: str) -> Tuple[int, int]:
    """(H, W) from the file's header (``image_size``)."""
    w, h = image_size(path)
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
