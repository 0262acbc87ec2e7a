"""Image files -> pixels for the training data, without PIL or libjpeg.

The port of the JAX package's native loader (`aqualora_tpu/core/
native_loader.py` over `native/imageloader.cpp`), which decodes with libjpeg
and libpng and resizes with its own float32 bicubic.  The card's machine has
neither library's headers, so:

- JPEG is `csrc/jpeg_decode.cpp`, written to give libjpeg-turbo 2.1's pixels
  bit for bit for every file the loader's libjpeg reads: baseline, extended
  and progressive, Huffman or arithmetic coding, the block smoothing of
  progressive files whose scans leave coefficients unfinished, and files
  cut short or damaged, which libjpeg reads on with a warning (`WARNINGS`;
  TRUNCATED for a file that ends before its EOI).  It is built with g++ on
  first use into `aqualora_torch/_build/` (`ops/_build.py`) and called
  through ctypes, which releases the GIL for the call.  Refused with the
  feature's name, as libjpeg refuses them: lossless (SOF3, SOF11) and
  hierarchical JPEG, 12-bit precision, two components, fractional sampling
  ratios, and a file with no scan before its end;
- PNG is `eval/image_io.load_png` (stdlib `zlib`), libpng's pixels under the
  loader's transforms;
- `decode_batch` is the loader's rule: every file decoded to RGB, then its
  float32 bicubic to resolution^2 and / 127.5 - 1 (`resize_normalize`, the
  same C++ code), JPEG files on `nthreads` threads (0: the host's count).

A four-component JPEG (Adobe CMYK or YCCK) is one that the JAX loader's
libjpeg cannot turn into RGB; the JAX dataset then reads the whole batch
with PIL, and `needs_pil_rule` tells the port's dataset when to do the
same.  On PIL's rule (`decode_file(pil=True)`) a JPEG file cut short
raises, as PIL does.  A file is dispatched on its first bytes, as
`imageloader.cpp:101-114` does.  A file this module cannot read raises
`ValueError` with its path and the reason; nothing falls back to another
decoder.  `jpeg_coefficients` returns a JPEG's quantized blocks and its
progression (`JpegProgress`) for `eval/jpeg.decode_from_coefficients`, the
decoder's plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aqualora_torch.eval.image_io import PNG_SIGNATURE, load_png
from aqualora_torch.ops import _build

JPEG_MAGIC = b"\xff\xd8"
COLORS = ("grey", "ycbcr", "rgb", "cmyk", "ycck")
_ERR = 512
_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "decode_header": [ctypes.c_char_p, ctypes.c_size_t, _P, ctypes.c_char_p,
                      ctypes.c_int],
    "decode_coefficients": [ctypes.c_char_p, ctypes.c_size_t, _P, _P,
                            ctypes.c_size_t, _P, ctypes.c_char_p,
                            ctypes.c_int],
    "decode_rgb": [ctypes.c_char_p, ctypes.c_size_t, _P, ctypes.c_size_t, _P,
                   ctypes.c_char_p, ctypes.c_int],
    "resize_normalize": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                         ctypes.c_char_p, ctypes.c_int],
    "decode_batch": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                     ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_char_p,
                     ctypes.c_int],
}


def _fn(name: str) -> ctypes._CFuncPtr:
    """The C function `name` of csrc/jpeg_decode.cpp, built on first use."""
    with _lock:
        if not _fns:
            lib = _build.build("jpeg_decode")
            for sym, argtypes in _SIGNATURES.items():
                _fns[sym] = _build.bind(lib, sym, argtypes)
    return _fns[name]


def _call(name: str, what: str, *args) -> None:
    err = ctypes.create_string_buffer(_ERR)
    if _fn(name)(*args, err, _ERR) != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")


# libjpeg's warnings (jerror.h), on which it goes on decoding; bit i of a
# decode's warnings is WARNINGS[i]
WARNINGS = ("premature end of JPEG file",          # JWRN_JPEG_EOF
            "premature end of data segment",       # JWRN_HIT_MARKER
            "bad Huffman code",                    # JWRN_HUFF_BAD_CODE
            "bad arithmetic code",                 # JWRN_ARITH_BAD_CODE
            "extraneous bytes before a marker",    # JWRN_EXTRANEOUS_DATA
            "missing or wrong restart marker",     # JWRN_MUST_RESYNC
            "sequential scan parameters out of range",  # JWRN_NOT_SEQUENTIAL
            "progression out of order",            # JWRN_BOGUS_PROGRESSION
            "unknown Adobe transform")             # JWRN_ADOBE_XFORM
TRUNCATED = WARNINGS[0]


def _warnings(bits: int) -> Tuple[str, ...]:
    return tuple(w for i, w in enumerate(WARNINGS) if bits >> i & 1)


@dataclasses.dataclass
class JpegHeader:
    """A JPEG's geometry: `color` is one of COLORS; each of
    `components` is (h, v, blocks across, blocks down, samples across,
    samples down), the blocks the MCU grid's."""

    width: int
    height: int
    color: str
    progressive: bool
    hmax: int
    vmax: int
    components: List[Tuple[int, int, int, int, int, int]]
    arithmetic: bool = False


@dataclasses.dataclass
class JpegProgress:
    """How far a file's scans took each coefficient, as libjpeg's
    `coef_bits` keeps it: `coef_bits[c, k]` is the lowest bit known of
    component c's coefficient k (zigzag order; -1: none, 0: finished),
    `prev_bits` the same before the component's latest scan; `last_row`
    the last iMCU row of the last scan begun with data (the rows after it
    take `prev_bits`); `smooth`, whether libjpeg smooths the blocks (a
    progressive file with unfinished low coefficients,
    `eval/jpeg.smooth_coefficients`); `warnings`, libjpeg's warnings the
    decode met."""

    coef_bits: np.ndarray
    prev_bits: np.ndarray
    last_row: int
    smooth: bool
    warnings: Tuple[str, ...]


def jpeg_header(data: bytes, what: str = "JPEG") -> JpegHeader:
    info = np.zeros(32, np.int32)
    _call("decode_header", what, data, len(data), info.ctypes.data)
    n = int(info[2])
    return JpegHeader(int(info[0]), int(info[1]),
                      COLORS[int(info[3])], bool(info[4]),
                      int(info[5]), int(info[6]),
                      [tuple(int(x) for x in info[8 + 6 * c:14 + 6 * c])
                       for c in range(n)], bool(info[7]))


def jpeg_coefficients(data: bytes, what: str = "JPEG"
                      ) -> Tuple[JpegHeader, np.ndarray, List[np.ndarray],
                                 JpegProgress]:
    """-> (header, quantization tables [components, 8, 8] int32 as each
    component latched it, quantized blocks [blocks down, blocks across, 8,
    8] int16 per component, natural (row-major) order; the progression)."""
    head = jpeg_header(data, what)
    sizes = [c[2] * c[3] * 64 for c in head.components]
    n = len(sizes)
    quant = np.zeros((n, 8, 8), np.int32)
    coef = np.zeros(sum(sizes), np.int16)
    progress = np.zeros(n * 128 + 3, np.int32)
    _call("decode_coefficients", what, data, len(data), quant.ctypes.data,
          coef.ctypes.data, coef.size, progress.ctypes.data)
    blocks, off = [], 0
    for c, size in zip(head.components, sizes):
        blocks.append(coef[off:off + size].reshape(c[3], c[2], 8, 8))
        off += size
    bits = progress[:n * 128].reshape(n, 2, 64)
    last_row, smooth, warned = (int(x) for x in progress[n * 128:])
    return head, quant, blocks, JpegProgress(
        bits[:, 0].copy(), bits[:, 1].copy(), last_row, bool(smooth),
        _warnings(warned))


def decode_jpeg(data: bytes, what: str = "JPEG",
                warnings: Optional[List[str]] = None) -> np.ndarray:
    """JPEG bytes -> HWC uint8 RGB, libjpeg-turbo's pixels (grey
    replicated; CMYK and YCCK as PIL's `convert("RGB")` turns libjpeg's
    CMYK into RGB).  The names of the warnings libjpeg would give (a file
    cut short is TRUNCATED) go into `warnings` when one is given."""
    head = jpeg_header(data, what)
    out = np.empty((head.height, head.width, 3), np.uint8)
    warned = np.zeros(1, np.uint32)
    _call("decode_rgb", what, data, len(data), out.ctypes.data, out.size,
          warned.ctypes.data)
    if warnings is not None:
        warnings.extend(_warnings(int(warned[0])))
    return out


def _kind(path: str, head: bytes) -> str:
    if head.startswith(JPEG_MAGIC):
        return "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    raise ValueError(f"{path}: not a JPEG or PNG file")


def decode_file(path: str, pil: bool = False) -> np.ndarray:
    """An image file -> HWC uint8 RGB, dispatched on its first bytes.
    `pil=True` reads as PIL does: 16-bit grey PNG as `load_png` does, and
    a JPEG file cut short raises (PIL's "image file is truncated"), where
    the JAX native loader's libjpeg decodes it."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if _kind(path, data[:8]) == "jpeg":
        warned: List[str] = []
        img = decode_jpeg(data, path, warned)
        if pil and TRUNCATED in warned:
            raise ValueError(f"{path}: image file is truncated ({TRUNCATED}"
                             "), which PIL refuses")
        return img
    return load_png(path, pil=pil)


def needs_pil_rule(path: str) -> bool:
    """Whether the JAX native loader refuses `path` where the port's
    decoders read it (a four-component JPEG), so that the JAX dataset reads
    its batch with PIL.  A file the port refuses raises, as `decode_file`
    does."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if _kind(path, data[:8]) != "jpeg":
        return False
    return jpeg_header(data, path).color in ("cmyk", "ycck")


def resize_normalize(image: np.ndarray, resolution: int) -> np.ndarray:
    """HWC uint8 RGB -> [resolution, resolution, 3] float32 in [-1, 1] by
    the JAX native loader's float32 bicubic (`imageloader.cpp:117-190`)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want HWC uint8 RGB, got {img.dtype} {img.shape}")
    out = np.empty((resolution, resolution, 3), np.float32)
    _call("resize_normalize", "resize", img.ctypes.data, img.shape[0],
          img.shape[1], resolution, out.ctypes.data)
    return out


def decode_batch(paths: Sequence[str], resolution: int,
                 nthreads: int = 0) -> np.ndarray:
    """Files -> [N, resolution, resolution, 3] float32 in [-1, 1] under the
    JAX native loader's rule: JPEG files decoded and resized in C++ on
    `nthreads` threads (0: the host's count), PNG files read by `load_png`
    and resized by the same C++ code."""
    paths = [os.fspath(p) for p in paths]
    kinds = []
    for p in paths:
        with open(p, "rb") as f:
            kinds.append(_kind(p, f.read(8)))
    out = np.empty((len(paths), resolution, resolution, 3), np.float32)
    jpegs = [i for i, k in enumerate(kinds) if k == "jpeg"]
    if jpegs:
        part = out if len(jpegs) == len(paths) else np.empty(
            (len(jpegs),) + out.shape[1:], np.float32)
        names = (ctypes.c_char_p * len(jpegs))(
            *[os.fsencode(paths[i]) for i in jpegs])
        status = np.zeros(len(jpegs), np.int32)
        err = ctypes.create_string_buffer(_ERR)
        if _fn("decode_batch")(names, len(jpegs), resolution,
                               part.ctypes.data, nthreads, status.ctypes.data,
                               err, _ERR):
            raise ValueError(err.value.decode(errors="replace"))
        if part is not out:
            out[jpegs] = part
    for i, k in enumerate(kinds):
        if k == "png":
            out[i] = resize_normalize(load_png(paths[i]), resolution)
    return out
