"""Images in and out of the eval protocol, without PIL.

The port of the image handling of `aqualora_tpu/eval/utils_eval.py`: the
device-side quantization `_to_uint8_device` and `images_to_pil` (`:129-156`)
and the decoder's preprocess `process` (`:409-416`), which opens a file,
converts it to RGB, resizes it with PIL's bicubic filter and maps it to
[-1, 1].  The card's machine may have no PIL, so this module writes and
reads PNG files itself (stdlib `zlib`) and computes PIL's bicubic resize
itself, bit for bit:

- `images_to_uint8`: round((x + 1) * 127.5) clipped to 0..255, on the
  images' device (ties to even, as `jnp.round`), then fetched as uint8;
- `save_png` / `load_png`: PNG.  The writer writes 8-bit RGB rows with
  filter 0 (None); the reader takes every PNG the JAX package's native
  loader reads through libpng (`native/imageloader.cpp:68-99`) and gives
  its pixels: any colour type and bit depth, palettes (a tRNS chunk
  ignored, as the stripped alpha), grey at 1, 2 or 4 bits scaled to 8
  (`png_set_expand_gray_1_2_4_to_8`), 16-bit samples cut to their high
  byte (`png_set_strip_16`), grey replicated and alpha dropped, Adam7
  interlacing, any number of IDAT chunks and all five row filters.  That
  is PIL's `convert("RGB")` too, but for 16-bit grey, which PIL opens as
  `I;16` and clips to 255: `pil=True` takes PIL's rule;
- `resize_bicubic_pil`: Pillow's `Image.resize(size, BICUBIC)` on RGB, as
  `src/libImaging/Resample.c` computes it (below);
- `preprocess`: RGB, the resize, then / 127.5 - 1.

Inputs may be paths, uint8 arrays or tensors, or anything `np.asarray` turns
into an HWC (or HW grey) uint8 array, PIL images included.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Pillow's decompression-bomb limit, 2 * Image.MAX_IMAGE_PIXELS
_MAX_PIXELS = 178956970


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def images_to_uint8(images) -> np.ndarray:
    """[-1, 1] NHWC -> uint8 NHWC on the host.  A tensor is quantized on its
    own device before the fetch (`_to_uint8_device`: 2x less traffic for
    bf16, 4x for float32); an array takes the JAX package's numpy rule."""
    if isinstance(images, torch.Tensor):
        q = torch.clamp(torch.round((images.float() + 1.0) * 127.5), 0, 255)
        return q.to(torch.uint8).cpu().numpy()
    return (((np.asarray(images) + 1) * 127.5).round()
            .clip(0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, image) -> None:
    """Write an HWC uint8 RGB image as an 8-bit RGB PNG, every row with
    filter 0, zlib level 6 (Pillow's default)."""
    arr = np.ascontiguousarray(np.asarray(image))
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png takes HWC uint8 RGB, got {arr.dtype} "
                         f"{arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters of `h` rows of `stride` bytes -> [h,
    stride] uint8; `bpp` is the filters' byte distance (bytes a pixel, at
    least 1).  None, Sub and Up run on whole rows in numpy; Average and
    Paeth, whose bytes depend on their left neighbour's result, byte by
    byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG image data has {len(raw)} bytes, want "
                         f"{h * (stride + 1)}")
    data = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, filt = int(data[y, 0]), data[y, 1:]
        if kind == 0:                                   # None
            row = filt
        elif kind == 1:                                 # Sub: a running sum
            row = np.cumsum(filt.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                                 # Up
            row = filt + prior
        elif kind == 3:                                 # Average
            row = np.frombuffer(_average_row(filt.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:                                 # Paeth
            row = np.frombuffer(_paeth_row(filt.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


# colour type -> the bit depths the PNG specification allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels]: uint8
    for depths up to 8 (unscaled), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows[:, :2 * width * channels].reshape(h, width, channels, 2)
        return (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    # 1, 2 or 4 bits, one channel: the samples of a byte from its top bits
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _decode_passes(raw: bytes, w: int, h: int, channels: int, depth: int,
                   interlace: int) -> np.ndarray:
    """The inflated image data -> samples [h, w, channels], through the
    seven Adam7 passes when `interlace`."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = None
    pos = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue                      # an empty pass has no scanlines
        stride = -(-pw * bits // 8)
        rows = _unfilter(raw[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        samples = _samples(rows, pw, channels, depth)
        if not interlace:
            return samples
        if out is None:
            out = np.empty((h, w, channels), samples.dtype)
        out[y0::dy, x0::dx] = samples
    return out


def _read_chunks(path: str, blob: bytes):
    """-> (IHDR fields, PLTE bytes or None, the joined IDAT data)."""
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        crc = blob[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4:
            raise ValueError(f"{path}: chunk {kind!r} runs past the file")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise ValueError(f"{path}: chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"{path}: IHDR has {n} bytes, want 13")
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = data
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    return header, palette, b"".join(idat)


def load_png(path: str, pil: bool = False) -> np.ndarray:
    """Read a PNG -> HWC uint8 RGB, libpng's pixels under the JAX native
    loader's transforms (see the module docstring); `pil=True` clips
    16-bit grey to 255 as PIL's `I;16` -> RGB conversion does."""
    with open(path, "rb") as f:
        blob = f.read()
    (w, h, depth, ctype, comp, filt, interlace), palette, data = \
        _read_chunks(path, blob)
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         "is not a PNG kind")
    if comp != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"{path}: compression {comp}, filter {filt} or "
                         f"interlace {interlace} method is not PNG's")
    if w < 1 or h < 1 or w * h > _MAX_PIXELS:
        raise ValueError(f"{path}: {w}x{h} pixels (at most {_MAX_PIXELS})")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    try:
        raw = zlib.decompress(data)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    pix = _decode_passes(raw, w, h, channels, depth, interlace)
    if ctype == 3:
        if palette is None or len(palette) % 3 or not palette:
            raise ValueError(f"{path}: a palette image without a valid PLTE")
        lut = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        idx = pix[:, :, 0]
        if idx.max() >= len(lut):
            raise ValueError(f"{path}: a palette index beyond the "
                             f"{len(lut)} PLTE entries")
        return np.ascontiguousarray(lut[idx])
    if depth == 16:
        if pil and ctype == 0:
            pix = np.minimum(pix, 255)
        else:
            pix = pix >> 8
        pix = pix.astype(np.uint8)
    elif depth < 8:                   # grey only: 1, 2, 4 bits -> 8
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    return _to_rgb(pix)


def _to_rgb(arr: np.ndarray) -> np.ndarray:
    """HW or HWC with 1-4 channels -> HWC RGB: grey replicated, alpha
    dropped (PIL's convert("RGB") for L, LA, RGB, RGBA)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"want an HW or HWC image with 1-4 channels, got "
                         f"{arr.shape}")
    if arr.shape[2] <= 2:
        return np.ascontiguousarray(np.repeat(arr[:, :, :1], 3, axis=2))
    return np.ascontiguousarray(arr[:, :, :3])


def as_rgb_uint8(img) -> np.ndarray:
    """A path, a tensor or anything `np.asarray` takes -> HWC uint8 RGB."""
    if isinstance(img, str) or hasattr(img, "__fspath__"):
        return load_png(str(img))
    if getattr(img, "mode", None) in ("P", "PA", "1", "I", "F", "CMYK",
                                      "YCbCr", "LAB", "HSV"):
        raise ValueError(f"image mode {img.mode}: convert it to RGB first")
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"want uint8 pixels, got {arr.dtype}")
    return _to_rgb(arr)


# ---------------------------------------------------------------------------
# PIL's bicubic resize (src/libImaging/Resample.c)
# ---------------------------------------------------------------------------
# The cubic convolution filter with a = -0.5 and support 2, widened by the
# scale when downsampling.  For each output position: the window of input
# positions [xmin, xmin + xmax), weights filter((x + xmin - center + 0.5) *
# ss) summed in order and divided by their sum, in double; then rounded to
# 22-bit fixed point away from zero (`normalize_coeffs_8bpc`).  Each pass
# accumulates integers from 1 << 21 and keeps bits 22 and up, clipped to
# 0..255 (`clip8`).  The horizontal pass runs first; each pass runs only
# where its size changes.

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, ...]:
    """(xmin [out], xmax [out], integer coefficients [out, ksize]) of
    `precompute_coeffs` and `normalize_coeffs_8bpc`."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero; below zero both clamp to 0
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = (np.minimum(np.trunc(center + support + 0.5), in_size)
            .astype(np.int64) - xmin)
    w = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):                 # the weights' sum in C's order
        live = x < xmax
        wx = np.where(live, _bicubic(((x + xmin) - center + 0.5) * ss), 0.0)
        w[:, x] = wx
        ww = ww + wx
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    k[np.arange(ksize)[None, :] >= xmax[:, None]] = 0
    return xmin, xmax, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of `ImagingResampleHorizontal_8bpc` (axis 1) or
    `..._Vertical_8bpc` (axis 0) on HWC uint8."""
    in_size = img.shape[axis]
    xmin, _, k = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                     in_size - 1)                         # [out, ksize]
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        acc += src[idx[:, j]] * k[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_pil(image: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Pillow's `Image.resize(size, Image.BICUBIC)` on an HWC uint8 RGB
    array, bit for bit; `size` is (width, height), as PIL's."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"want HWC uint8, got {img.dtype} {img.shape}")
    w, h = size
    if w < 1 or h < 1:
        raise ValueError(f"size {size} must be positive")
    if (h, w) == img.shape[:2]:
        return img.copy()                   # Image.resize copies
    if w != img.shape[1]:
        img = _resample_axis(img, w, axis=1)
    if h != img.shape[0]:
        img = _resample_axis(img, h, axis=0)
    return img


def preprocess(img, resolution: int) -> np.ndarray:
    """The decoder's input from one image (`process`, `:409-416`): RGB,
    PIL's bicubic resize to resolution^2, then / 127.5 - 1 -> float32
    HWC in [-1, 1]."""
    arr = resize_bicubic_pil(as_rgb_uint8(img), (resolution, resolution))
    return arr.astype(np.float32) / 127.5 - 1.0
