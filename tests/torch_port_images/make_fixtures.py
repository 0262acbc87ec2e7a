"""Write the image fixtures of the port's data path, from a seed.

    python tests/torch_port_images/make_fixtures.py

needs Pillow, a C compiler with the system libjpeg's headers and the JAX
package's native loader (libjpeg, libpng), and writes into this
directory:

- `small/`: one small file of every JPEG and PNG kind the port decodes or
  refuses (`jpeg_kinds`, `libjpeg_kinds`, `png_kinds`).  JPEG files are
  Pillow's, but for the kinds Pillow cannot write: a baseline 4:4:0 file
  (`encode_baseline`, standard tables), a YCCK file (`ycck_jpeg`: Pillow's
  CMYK file of YCCK samples, its Adobe transform set to 2), the files
  libjpeg's own encoder writes (`libjpeg_writer.c`, built with `cc
  -ljpeg` against the library the native loader links: arithmetic
  coding, sequential and progressive, with restart intervals, with
  conditioning values other than the defaults and with no DAC at all;
  progressive scans that leave coefficients unfinished, a DC scan alone),
  files cut short, and refused ones patched from a baseline file
  (lossless, hierarchical, lossless arithmetic, 12-bit).  PNG files are
  written by `write_png` with all five row filters, Adam7 too;
- `realistic/`: smooth seeded images of 512x512 to 1024x768, baseline
  and progressive, 4:2:0 and 4:4:4, arithmetic progressive, and (in
  `realistic/truncated/`, out of the folder's own listing, which PIL's
  rule reads whole) a progressive file cut after its first AC scans: the
  data of the card's folder-fed training run;
- `pixels.npz`: every decodable small file's reference pixels, HWC uint8
  RGB: Pillow's decode of the JPEG files it writes; the JAX native
  loader's (libjpeg-turbo 2.1) of the ones libjpeg writes and the cut
  ones (square, read back at the file's own size, where its resize is
  the identity); for PNG, libpng's under the native loader's transforms
  (Pillow's too, but for 16-bit grey, which PIL clips to 255);
- `manifest.json`: each small file's kind, which library's pixels it
  carries (`pixels`: pillow, native_loader or libpng), how Pillow reads
  it where that differs (`pillow`: raises, a file cut short; smoothing,
  libjpeg-turbo 3's block smoothing within 2 levels) and, for a refused
  one, the feature its error names; each realistic file's shape, coding,
  the native loader's pixels' SHA-256 and a caption.

The card's machine has no PIL: `chip_smoke.py` holds the port's decoders
to these files.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def smooth_image(h: int, w: int, seed: int, noise: float = 2.0) -> np.ndarray:
    """A seeded photo-like RGB image: a vertical gradient, a few sinusoids
    and soft discs per channel, and a little grain."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y, x = y / max(h, w), x / max(h, w)
    img = np.zeros((h, w, 3))
    for c in range(3):
        img[..., c] = r.uniform(0.2, 0.8) + r.uniform(-0.4, 0.4) * y
        for _ in range(3):
            fx, fy = r.uniform(0.5, 5.0), r.uniform(0.5, 5.0)
            ph = r.uniform(0, 6.3)
            img[..., c] += 0.12 * np.sin(2 * np.pi * (fx * x + fy * y) + ph)
    for _ in range(4):
        cy, cx, rad = r.uniform(0, 1, 2).tolist() + [r.uniform(0.05, 0.3)]
        disc = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * rad ** 2))
        img += disc[..., None] * r.uniform(-0.3, 0.3, 3)
    img = img * 255 + r.normal(0, noise, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# a baseline JPEG encoder, for the sampling Pillow cannot write (4:4:0)
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3: (bits[1..16], values)
DC_LUM = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROM = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUM = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROM = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _codes(table):
    bits, vals = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _dct_matrix():
    c = np.array([[np.sqrt(0.5) if u == 0 else 1.0 for _ in range(8)]
                  for u in range(8)])
    n = np.arange(8)
    return 0.5 * c * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)


def encode_baseline(rgb: np.ndarray, sampling, quality: int = 85) -> bytes:
    """A baseline JFIF file of `rgb` with per-component (h, v) sampling
    factors: JFIF's YCbCr, chroma averaged down, a float DCT, the Annex K
    tables scaled to `quality`, standard Huffman tables."""
    from aqualora_torch.eval.jpeg import quant_tables
    h, w = rgb.shape[:2]
    f = rgb.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    lum, chrom = quant_tables(quality)
    tables = [lum, chrom, chrom]
    d = _dct_matrix()
    comps = []
    for c, (hs, vs) in enumerate(sampling):
        plane = ycc[c]
        fy, fx = vmax // vs, hmax // hs
        ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3))
        rows, cols = my * vs * 8, mx * hs * 8
        plane = np.pad(plane, ((0, rows - plane.shape[0]),
                               (0, cols - plane.shape[1])), mode="edge")
        blocks = (plane - 128).reshape(rows // 8, 8, cols // 8, 8).transpose(
            0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", d, blocks, d)
        comps.append(np.round(coef / tables[c]).astype(np.int64))
    dc_codes = [_codes(DC_LUM), _codes(DC_CHROM)]
    ac_codes = [_codes(AC_LUM), _codes(AC_CHROM)]
    bits, pred = _Bits(), [0, 0, 0]
    for by in range(my):
        for bx in range(mx):
            for c, (hs, vs) in enumerate(sampling):
                t = min(c, 1)
                for j in range(vs):
                    for i in range(hs):
                        zz = comps[c][by * vs + j, bx * hs + i].reshape(
                            64)[ZIGZAG]
                        diff = int(zz[0]) - pred[c]
                        pred[c] = int(zz[0])
                        cat = _category(diff)
                        bits.put(*dc_codes[t][cat])
                        bits.put(diff if diff >= 0 else diff + (1 << cat) - 1,
                                 cat)
                        run = 0
                        last = max([k for k in range(1, 64) if zz[k]] or [0])
                        for k in range(1, last + 1):
                            v = int(zz[k])
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(*ac_codes[t][0xF0])
                                run -= 16
                            cat = _category(v)
                            bits.put(*ac_codes[t][(run << 4) | cat])
                            bits.put(v if v >= 0 else v + (1 << cat) - 1, cat)
                            run = 0
                        if last < 63:
                            bits.put(*ac_codes[t][0x00])

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    jfif = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    out = b"\xff\xd8" + seg(0xE0, jfif)
    for t, table in enumerate((lum, chrom)):
        zz = bytes(table.reshape(64)[ZIGZAG].tolist())
        out += seg(0xDB, bytes([t]) + zz)
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([c + 1, (hs << 4) | vs, min(c, 1)])
        for c, (hs, vs) in enumerate(sampling)))
    for cls, t, table in ((0, 0, DC_LUM), (0, 1, DC_CHROM), (1, 0, AC_LUM),
                          (1, 1, AC_CHROM)):
        out += seg(0xC4, bytes([(cls << 4) | t]) + bytes(table[0])
                   + bytes(table[1]))
    out += seg(0xDA, bytes([3]) + b"".join(
        bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in range(3))
        + bytes([0, 63, 0]))
    return out + bits.flush() + b"\xff\xd9"


def patched(data: bytes, marker: int = None, precision: int = None) -> bytes:
    """A copy of a baseline file with its SOF0 marker changed to `marker`
    or its sample precision to `precision` (headers of the processes the
    port refuses)."""
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


def strip_segments(data: bytes, marker: int) -> bytes:
    """A copy of a file without its `marker` segments (before the first
    SOS, and between scans)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            return bytes(out + data[pos:])
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + n
        if m == 0xDA:              # the scan's data runs to the next marker
            while True:
                end = data.index(b"\xff", end)
                if data[end + 1] not in (0x00, *range(0xD0, 0xD8)):
                    break
                end += 2
        if m != marker:
            out += data[pos:end]
        pos = end
    return bytes(out)


# ---------------------------------------------------------------------------
# libjpeg's own encoder and decoder (libjpeg_writer.c)
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _writer() -> str:
    """libjpeg_writer.c built against the system libjpeg, the native
    loader's library, into a temporary directory."""
    exe = os.path.join(tempfile.mkdtemp(), "libjpeg_writer")
    subprocess.run(["cc", "-O2", os.path.join(HERE, "libjpeg_writer.c"),
                    "-o", exe, "-ljpeg"], check=True)
    return exe


def libjpeg_jpeg(img: np.ndarray, quality: int, *options: str) -> bytes:
    """`img` (HWC RGB, or HW grey) through libjpeg's encoder with
    jpeg_set_quality(quality) and the writer's `options`."""
    h, w = img.shape[:2]
    comps = 1 if img.ndim == 2 else 3
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        np.ascontiguousarray(img, np.uint8).tofile(raw)
        subprocess.run([_writer(), raw, out, str(w), str(h), str(comps),
                        str(quality), *options], check=True)
        with open(out, "rb") as f:
            return f.read()


def libjpeg_pixels(path: str) -> np.ndarray:
    """The native loader's decode (libjpeg, JCS_RGB, its defaults) of a
    JPEG file of any shape, as HWC uint8 RGB."""
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "out.raw")
        res = subprocess.run([_writer(), "-decode", path, raw], check=True,
                             capture_output=True, text=True)
        w, h = (int(x) for x in res.stdout.split())
        return np.fromfile(raw, np.uint8).reshape(h, w, 3)


def native_pixels(path: str, size: int) -> np.ndarray:
    """The JAX native loader's pixels of a square file, read back at its
    own size, where the loader's resize is the identity."""
    from aqualora_tpu.core import native_loader
    got = native_loader.decode_batch([path], size)
    assert got is not None, path
    return np.round((got[0] + 1) * 127.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNG, every kind libpng reads
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_row(kind: int, raw: np.ndarray, prior: np.ndarray,
                bpp: int) -> np.ndarray:
    r, p = raw.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        est = a + p - c
        pa, pb, pc = abs(est - a), abs(est - p), abs(est - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, channels] samples -> [h, stride] bytes of `depth` bits."""
    h = samples.shape[0]
    if depth == 16:
        v = samples.astype(">u2")
        return np.frombuffer(v.tobytes(), np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    flat = samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def write_png(path: str, samples: np.ndarray, depth: int, ctype: int,
              palette: bytes = None, trns: bytes = None,
              interlace: bool = False) -> None:
    """Samples [h, w, channels] -> a PNG, the rows' filters cycling
    through all five."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ([(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
               (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)] if interlace
              else [(0, 0, 1, 1)])
    raw, k = bytearray(), 0
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            kind = k % 5
            k += 1
            raw += bytes([kind]) + _filter_row(kind, row, prior, bpp).tobytes()
            prior = row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, int(interlace))))
        if palette is not None:
            f.write(_chunk(b"PLTE", palette))
        if trns is not None:
            f.write(_chunk(b"tRNS", trns))
        data = zlib.compress(bytes(raw), 9)
        for i in range(0, len(data), 1000):       # several IDAT chunks
            f.write(_chunk(b"IDAT", data[i:i + 1000]))
        f.write(_chunk(b"IEND", b""))


def ycck_jpeg(img: np.ndarray) -> bytes:
    """A YCCK JPEG (four components, Adobe transform 2, as Photoshop writes
    CMYK), which Pillow does not write: `img`'s CMY with a varying K, taken
    to YCCK by libjpeg's forward rule (jccolor.c `cmyk_ycck_convert`: Y, Cb,
    Cr of (255 - C, 255 - M, 255 - Y) in 16-bit fixed point, K as is),
    stored by Pillow as a CMYK file (Pillow inverts every byte on the way
    in, the Adobe convention, so it is handed the inverse), the first
    component at 2x2 (`subsampling=2`), then the Adobe marker's transform
    byte set to 2."""
    rgb = img.astype(np.int64)
    k = rgb[..., 1] // 3
    r, g, b = (rgb[..., i] for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    stored = np.stack([y, cb, cr, k], -1).astype(np.uint8)
    h, w = img.shape[:2]
    buf = io.BytesIO()
    Image.frombytes("CMYK", (w, h), (255 - stored).tobytes()).save(
        buf, "JPEG", quality=85, subsampling=2)
    data = bytearray(buf.getvalue())
    at = data.index(b"\xff\xee") + 4          # the segment's payload
    assert data[at:at + 5] == b"Adobe" and data[at + 11] == 0
    data[at + 11] = 2
    return bytes(data)


# ---------------------------------------------------------------------------
# the sets
# ---------------------------------------------------------------------------

# name -> (file bytes maker, refused feature or None)
def jpeg_kinds():
    img = smooth_image(37, 53, 1)

    def pil(arr, mode=None, **kw):
        buf = io.BytesIO()
        im = Image.fromarray(arr)
        if mode:
            im = im.convert(mode)
        im.save(buf, "JPEG", **kw)
        return buf.getvalue()

    base = pil(img, quality=85)
    kinds = {
        "baseline_q50": pil(img, quality=50),
        "baseline_q75": pil(img, quality=75),
        "baseline_q95": pil(img, quality=95),
        "sub444": pil(img, quality=85, subsampling=0),
        "sub422": pil(img, quality=85, subsampling=1),
        "sub420": pil(img, quality=85, subsampling=2),
        "sub440": encode_baseline(img, [(1, 2), (1, 1), (1, 1)]),
        "progressive": pil(img, quality=85, progressive=True),
        "progressive444": pil(img, quality=85, progressive=True,
                              subsampling=0),
        "optimized": pil(img, quality=85, optimize=True),
        "restart_blocks": pil(img, quality=85, restart_marker_blocks=2),
        "restart_rows": pil(img, quality=85, restart_marker_rows=1),
        "restart_progressive": pil(img, quality=85, progressive=True,
                                   restart_marker_blocks=3),
        "grey": pil(img[..., 1], quality=85),
        "grey_progressive": pil(img[..., 1], quality=85, progressive=True),
        "sof1_qtables": pil(img, qtables=[[300 + 3 * i for i in range(64)],
                                          [260 + i for i in range(64)]]),
        "odd_17x9": pil(smooth_image(17, 9, 2), quality=90),
        "odd_1x1": pil(smooth_image(1, 1, 3), quality=90),
        "odd_9x2_422": pil(smooth_image(9, 2, 4), quality=90, subsampling=1),
        "cmyk": pil(img, "CMYK", quality=85),
        "ycck": ycck_jpeg(img),
    }
    refused = {
        "lossless": (patched(base, marker=0xC3), "lossless"),
        "lossless_arithmetic": (patched(base, marker=0xCB), "lossless"),
        "hierarchical": (patched(base, marker=0xC5), "hierarchical"),
        "precision12": (patched(base, precision=12), "12-bit precision"),
    }
    return kinds, refused


# progressive scans that leave AC 1-5 one bit short in every component
UNFINISHED = "0,1,2:0-0:0,0;0:1-5:0,1;1:1-5:0,1;2:1-5:0,1"


def _cut(data: bytes) -> bytes:
    return data[:len(data) * 2 // 3]


def libjpeg_kinds():
    """name -> (bytes, how Pillow reads the file where it differs from the
    native loader: None, "raises" or "smoothing"), all square (40 x 40,
    37 x 37, 64 x 64), so that the native loader at the file's size reads
    them back exactly."""
    img = smooth_image(40, 40, 21)
    wide = smooth_image(64, 64, 9)     # where Pillow's smoothing differs

    def pil(**kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        return buf.getvalue()

    return {
        "arithmetic": (libjpeg_jpeg(smooth_image(37, 37, 1), 85, "-arith"),
                       None),
        "arith420": (libjpeg_jpeg(img, 80, "-arith"), None),
        "arith444": (libjpeg_jpeg(img, 80, "-arith", "-sample",
                                  "1,1;1,1;1,1"), None),
        "arith_grey": (libjpeg_jpeg(img[..., 1], 80, "-arith"), None),
        "arith_progressive_restart": (libjpeg_jpeg(
            img, 80, "-arith", "-progressive", "-restart", "3"), None),
        "arith_dac": (libjpeg_jpeg(img, 80, "-arith", "-dac", "2,5,20"),
                      None),
        "arith_no_dac": (strip_segments(libjpeg_jpeg(
            img, 80, "-arith", "-progressive", "-restart", "4"), 0xCC), None),
        "unfinished": (libjpeg_jpeg(wide, 80, "-scans", UNFINISHED),
                       "smoothing"),
        "arith_unfinished": (libjpeg_jpeg(wide, 80, "-arith", "-scans",
                                          UNFINISHED), "smoothing"),
        "dc_only": (libjpeg_jpeg(img, 80, "-scans", "0,1,2:0-0:0,0"),
                    "smoothing"),
        "truncated_baseline": (_cut(pil(quality=85)), "raises"),
        "truncated_progressive": (_cut(pil(quality=85, progressive=True)),
                                  "raises"),
        "truncated_arith": (_cut(libjpeg_jpeg(img, 80, "-arith")), "raises"),
    }


def png_kinds():
    """name -> (samples, depth, colour type, palette, tRNS, interlace), all
    square (17 x 17), so the native loader at 17 px reads them back
    exactly."""
    n = 17
    r = np.random.default_rng(5)
    rgb = smooth_image(n, n, 6)
    grey = rgb[..., 1:2]
    pal = r.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = (grey.astype(np.int64) * 40 // 256).astype(np.uint8)
    wide = lambda a: (a.astype(np.uint16) << 8) | r.integers(
        0, 256, a.shape, dtype=np.uint16)
    alpha = r.integers(0, 256, (n, n, 1), dtype=np.uint8)
    return {
        "palette_trns": (idx, 8, 3, pal.tobytes(), bytes(range(0, 200, 5)),
                         False),
        "palette_4bit": (idx % 16, 4, 3, pal[:16].tobytes(), None, False),
        "grey_1bit": (grey >> 7, 1, 0, None, None, False),
        "grey_2bit": (grey >> 6, 2, 0, None, None, False),
        "grey_4bit": (grey >> 4, 4, 0, None, None, False),
        "grey_trns": (grey, 8, 0, None, struct.pack(">H", int(grey[0, 0, 0])),
                      False),
        "grey16": (wide(grey), 16, 0, None, None, False),
        "rgb16": (wide(rgb), 16, 2, None, None, False),
        "grey_alpha": (np.concatenate([grey, alpha], 2), 8, 4, None, None,
                       False),
        "rgba": (np.concatenate([rgb, alpha], 2), 8, 6, None, None, False),
        "rgba16_adam7": (wide(np.concatenate([rgb, alpha], 2)), 16, 6, None,
                         None, True),
        "rgb_adam7": (rgb, 8, 2, None, None, True),
        "grey_2bit_adam7": (grey >> 6, 2, 0, None, None, True),
    }


# (height, width, seed, progressive, subsampling, caption): Pillow's
REALISTIC = [
    (512, 512, 11, False, 2, "a sunlit valley under a clear sky"),
    (768, 1024, 12, True, 2, "a harbour at dusk with small boats"),
    (600, 800, 13, False, 0, "a bowl of fruit on a wooden table"),
    (1024, 768, 14, True, 0, "a lighthouse on a rocky coast"),
    (512, 640, 15, False, 2, "a forest path in autumn"),
    (720, 960, 16, True, 2, "a city street after rain"),
    (640, 512, 17, False, 2, "a portrait of a cat by a window"),
    (768, 768, 18, True, 0, "snowy mountains at sunrise"),
]
# (file, height, width, seed, coding, caption): libjpeg's 4:2:0 at q85,
# an arithmetic progressive file and a Huffman progressive file cut after
# its first AC scans (before the fifth SOS), each beside a baseline file
# of the same image
LIBJPEG_REALISTIC = [
    ("photo8.jpg", 768, 1024, 19, "arithmetic progressive",
     "a canal between old houses"),
    ("photo9.jpg", 768, 1024, 19, "baseline", "a canal between old houses"),
    ("truncated/photo10.jpg", 768, 768, 20,
     "progressive, cut after its first AC scans", "a field of sunflowers"),
    ("photo11.jpg", 768, 768, 20, "baseline", "a field of sunflowers"),
]


def _cut_before_scan(data: bytes, n: int) -> bytes:
    """`data` up to its n-th SOS marker (counted from 1)."""
    at = -1
    for _ in range(n):
        at = data.index(b"\xff\xda", at + 1)
    return data[:at]


def _libjpeg_realistic(h: int, w: int, seed: int, coding: str) -> bytes:
    img = smooth_image(h, w, seed, noise=6.0)
    if coding == "baseline":
        return libjpeg_jpeg(img, 85)
    if coding.startswith("arithmetic"):
        return libjpeg_jpeg(img, 85, "-arith", "-progressive")
    return _cut_before_scan(libjpeg_jpeg(img, 85, "-progressive"), 5)


def main():
    from aqualora_tpu.core import native_loader
    from aqualora_torch.train.image_decode import resize_normalize
    small = os.path.join(HERE, "small")
    real = os.path.join(HERE, "realistic")
    os.makedirs(small, exist_ok=True)
    os.makedirs(os.path.join(real, "truncated"), exist_ok=True)
    pixels, manifest = {}, {"small": {}, "realistic": []}
    kinds, refused = jpeg_kinds()
    for name, data in kinds.items():
        path = os.path.join(small, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        pixels[name] = np.asarray(Image.open(path).convert("RGB"))
        manifest["small"][name + ".jpg"] = {"kind": "jpeg", "refused": None,
                                            "pixels": "pillow"}
    for name, (data, pillow) in libjpeg_kinds().items():
        path = os.path.join(small, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        pixels[name] = native_pixels(path, Image.open(path).size[0])
        assert np.array_equal(pixels[name], libjpeg_pixels(path)), name
        entry = {"kind": "jpeg", "refused": None, "pixels": "native_loader"}
        if pillow:
            entry["pillow"] = pillow
        manifest["small"][name + ".jpg"] = entry
    for name, (data, feature) in refused.items():
        with open(os.path.join(small, name + ".jpg"), "wb") as f:
            f.write(data)
        manifest["small"][name + ".jpg"] = {"kind": "jpeg",
                                            "refused": feature}
    for name, (samples, depth, ctype, pal, trns, inter) in png_kinds().items():
        path = os.path.join(small, name + ".png")
        write_png(path, samples, depth, ctype, pal, trns, inter)
        n = samples.shape[0]
        ref = native_pixels(path, n)
        if name != "grey16":
            assert np.array_equal(
                ref, np.asarray(Image.open(path).convert("RGB"))), name
        pixels[name] = ref
        manifest["small"][name + ".png"] = {"kind": "png", "refused": None,
                                            "pixels": "libpng"}
    rows = [(f"photo{i}.jpg", h, w, "progressive" if prog else "baseline",
             ["4:4:4", "4:2:2", "4:2:0"][sub], caption)
            for i, (h, w, seed, prog, sub, caption) in enumerate(REALISTIC)]
    for i, (h, w, seed, prog, sub, caption) in enumerate(REALISTIC):
        Image.fromarray(smooth_image(h, w, seed, noise=6.0)).save(
            os.path.join(real, rows[i][0]), "JPEG", quality=85,
            progressive=prog, subsampling=sub)
    for name, h, w, seed, coding, caption in LIBJPEG_REALISTIC:
        with open(os.path.join(real, name), "wb") as f:
            f.write(_libjpeg_realistic(h, w, seed, coding))
        rows.append((name, h, w, coding, "4:2:0", caption))
    for name, h, w, coding, sampling, caption in rows:
        path = os.path.join(real, name)
        ref = np.ascontiguousarray(libjpeg_pixels(path))
        assert ref.shape == (h, w, 3), name
        # the native loader's own batch, against these pixels through
        # the same float32 resize
        assert np.array_equal(native_loader.decode_batch([path], 512)[0],
                              resize_normalize(ref, 512)), name
        manifest["realistic"].append({
            "file": name, "height": h, "width": w, "coding": coding,
            "progressive": coding != "baseline", "subsampling": sampling,
            "caption": caption, "pixels": "native_loader",
            "pixels_sha256": hashlib.sha256(ref.tobytes()).hexdigest()})
    np.savez_compressed(os.path.join(HERE, "pixels.npz"), **pixels)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
