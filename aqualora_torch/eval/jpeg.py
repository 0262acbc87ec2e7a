"""libjpeg's lossy round trip at a fixed quality, in integer torch ops.

The counterpart of `aqualora_tpu/core/native_loader.py:jpeg_roundtrip_batch`
(libjpeg through ctypes) and of the PIL save and open it falls back to
(`aqualora_tpu/eval/distortions.py:jpeg_compress`): the pixels that libjpeg
(libjpeg-turbo, with libjpeg 6b's arithmetic) gives for an encode with
`jpeg_set_defaults` and `jpeg_set_quality(quality, TRUE)` and a decode with
its defaults.  That is 4:2:0 YCbCr, the accurate integer DCT both ways
(JDCT_ISLOW) and fancy upsampling.  The Huffman stage is lossless and
cannot change a pixel, so it is not written: the quantized coefficients go
straight to the decoder's half.

Every stage is libjpeg's integer arithmetic, file by file:
  - RGB -> YCbCr, 16-bit fixed point (`jccolor.c`, `rgb_ycc_start`);
  - 2x2 chroma downsampling with the alternating bias 1, 2
    (`jcsample.c`, `h2v2_downsample`); the edges replicated as
    `jcprepct.c` and `expand_right_edge` do;
  - the forward DCT (`jfdctint.c`) and the rounding division by the
    quantization table times 8 (`jcdctmgr.c`); the tables of Annex K
    scaled by `jpeg_quality_scaling` and clamped to 1..255 (`jcparam.c`);
  - dequantization and the inverse DCT (`jidctint.c`) as libjpeg-turbo's
    SIMD code computes them (16-bit lanes: on an encoder's coefficients
    the C code's numbers), the output clamped to the sample range;
  - the triangle filter of `h2v2_fancy_upsample` (`jdsample.c`), its
    context rows replicated at the top and bottom (`jdmainct.c`);
  - YCbCr -> RGB (`jdcolor.c`, `build_ycc_rgb_table`).

Integers only, on the images' device, so the CPU and the card give the same
bits.  `tests/test_torch_port_distortion.py` holds it to Pillow bit for bit.

`decode_from_coefficients` is the decoder's half on its own, from a file's
quantized blocks: any quantization tables, grey, three or four components,
every component at sampling factors that divide the largest, upsampled by
`h2v1_fancy_upsample`, `h1v2_fancy_upsample` or `h2v2_fancy_upsample`
(`jdsample.c`; plain replication where libjpeg takes it, boxes at other
ratios), after `smooth_coefficients`, libjpeg-turbo 2.1's block smoothing
of a progressive file's unfinished coefficients, where libjpeg applies it.
It is the plain version of `csrc/jpeg_decode.cpp`, the training data's
JPEG decoder, which `tests/test_torch_port_data.py`,
`tests/test_torch_port_jpeg_kinds.py` and `chip_smoke.py` hold to it.
"""

from __future__ import annotations

import numpy as np
import torch

# jfdctint.c / jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
# jccolor.c / jdcolor.c
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CENTER = 128


def _fix(x: float, bits: int = SCALEBITS) -> int:
    return int(x * (1 << bits) + 0.5)


# the DCTs' constants, FIX(x) at CONST_BITS
F_0_298 = _fix(0.298631336, CONST_BITS)
F_0_390 = _fix(0.390180644, CONST_BITS)
F_0_541 = _fix(0.541196100, CONST_BITS)
F_0_765 = _fix(0.765366865, CONST_BITS)
F_0_899 = _fix(0.899976223, CONST_BITS)
F_1_175 = _fix(1.175875602, CONST_BITS)
F_1_501 = _fix(1.501321110, CONST_BITS)
F_1_847 = _fix(1.847759065, CONST_BITS)
F_1_961 = _fix(1.961570560, CONST_BITS)
F_2_053 = _fix(2.053119869, CONST_BITS)
F_2_562 = _fix(2.562915447, CONST_BITS)
F_3_072 = _fix(3.072711026, CONST_BITS)

# Annex K.1, natural (row-major) order, as jcparam.c holds them
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64).reshape(8, 8)


def quality_scaling(quality: int) -> int:
    """`jpeg_quality_scaling`: a quality of 1..100 -> a percentage."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - 2 * quality


def quant_tables(quality: int) -> tuple:
    """(luminance, chrominance) [8, 8] int64 tables of `jpeg_set_quality(q,
    force_baseline=TRUE)`: (basic * scale + 50) / 100, clamped to 1..255."""
    scale = quality_scaling(quality)
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMINANCE, STD_CHROMINANCE))


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# the DCTs on [..., 8] vectors (one 1-D pass)
# ---------------------------------------------------------------------------

def _fdct_1d(d, first: bool):
    """One pass of `jpeg_fdct_islow` over the 8 tensors `d` (one per
    sample of the row or column): the first pass scales by 2^PASS1_BITS,
    the second removes it."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * F_0_541
    out[2] = _descale(z1 + tmp13 * F_0_765, n)
    out[6] = _descale(z1 - tmp12 * F_1_847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F_1_175
    tmp4, tmp5 = tmp4 * F_0_298, tmp5 * F_2_053
    tmp6, tmp7 = tmp6 * F_3_072, tmp7 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """x modulo 2^16 as a signed 16-bit value (a SIMD lane's wrap)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(z, n: int):
    """One pass of `jpeg_idct_islow` over the 8 dequantized tensors `z`,
    descaled by `n` bits, as libjpeg-turbo's SIMD code computes it
    (jidctint-sse2.asm, jidctint-avx2.asm): the sums z0 + z4, z0 - z4,
    z7 + z3 and z5 + z1 wrap at 16 bits, every product is exact.  On an
    encoder's coefficients nothing wraps and this is the C code's pass."""
    z1 = (z[2] + z[6]) * F_0_541
    tmp2 = z1 - z[6] * F_1_847
    tmp3 = z1 + z[2] * F_0_765
    tmp0 = _wrap16(z[0] + z[4]) << CONST_BITS
    tmp1 = _wrap16(z[0] - z[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = z[7], z[5], z[3], z[1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * F_1_175
    t0, t1 = t0 * F_0_298, t1 * F_2_053
    t2, t3 = t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [_descale(tmp10 + t3, n), _descale(tmp11 + t2, n),
            _descale(tmp12 + t1, n), _descale(tmp13 + t0, n),
            _descale(tmp13 - t0, n), _descale(tmp12 - t1, n),
            _descale(tmp11 - t2, n), _descale(tmp10 - t3, n)]


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """[N, 8h, 8w] -> [N, h, w, 8, 8] (rows, columns of each block)."""
    n, hh, ww = plane.shape
    return plane.reshape(n, hh // 8, 8, ww // 8, 8).permute(0, 1, 3, 2, 4)


def _unblocks(blocks: torch.Tensor) -> torch.Tensor:
    n, h, w = blocks.shape[:3]
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, 8 * h, 8 * w)


def _code_plane(plane: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """One component's samples [N, 8h, 8w] (0..255) -> encode (forward DCT,
    quantization) and decode (dequantization, inverse DCT, range limit) ->
    samples [N, 8h, 8w]."""
    q = torch.from_numpy(table).to(plane.device)
    x = _blocks(plane) - CENTER
    # forward DCT: rows (the last axis), then columns
    x = torch.stack(_fdct_1d(x.unbind(-1), True), -1)
    x = torch.stack(_fdct_1d(x.unbind(-2), False), -2)
    # quantization: the rounding division by table * 8, the sign restored
    div = q * 8
    coef = torch.sign(x) * ((x.abs() + (div >> 1)) // div)
    return _unblocks(_idct_blocks(coef, q))


def _idct_blocks(coef: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quantized blocks [..., 8, 8] (int64) and their table [8, 8] ->
    samples [..., 8, 8] as libjpeg-turbo's SIMD `jpeg_idct_islow` gives
    them: dequantized at 16 bits, the columns (a block whose rows 1-7 are
    zero taking row 0 << PASS1_BITS at 16 bits), saturated to 16 bits, the
    rows, then the output clamped to the sample range (jdmaster.c's
    range-limit table gives the same wherever its 10-bit index does not
    wrap)."""
    z = _wrap16(coef * q)
    cols = torch.stack(_idct_1d(z.unbind(-2), CONST_BITS - PASS1_BITS), -2)
    flat = _wrap16(z[..., :1, :] << PASS1_BITS).expand_as(cols)
    ac_zero = (coef[..., 1:, :] == 0).flatten(-2).all(-1)[..., None, None]
    z = torch.where(ac_zero, flat, cols.clamp(-32768, 32767))
    z = torch.stack(_idct_1d(z.unbind(-1), CONST_BITS + PASS1_BITS + 3), -1)
    return z.clamp(-128, 127) + 128


def _pad_to(plane: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Replicate the last row and column of [N, h, w] out to rows x cols."""
    _, h, w = plane.shape
    if (h, w) == (rows, cols):
        return plane
    ri = torch.arange(rows, device=plane.device).clamp(max=h - 1)
    ci = torch.arange(cols, device=plane.device).clamp(max=w - 1)
    return plane[:, ri][:, :, ci]


def _downsample(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`h2v2_downsample` of a full-resolution chroma plane [N, h, w]: the
    columns replicated out to the component's blocks (ceil(w/16) * 16),
    the rows to an even count; each 2x2 sum plus the bias 1, 2, 1, 2, ...
    along a row, / 4; then the last chroma row replicated out to the
    component's blocks (ceil(h/16) * 8 rows)."""
    cols = -(-w // 16) * 16
    c = _pad_to(c, h + h % 2, cols)
    s = c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2,
                                                                   1::2]
    bias = 1 + torch.arange(s.shape[2], device=c.device) % 2
    s = (s + bias) >> 2
    return _pad_to(s, -(-h // 16) * 8, cols // 2)


def _fancy_upsample(c: torch.Tensor) -> torch.Tensor:
    """`h2v2_fancy_upsample` of [N, h, w] chroma (the component's real rows
    and columns): each output row is 3 x its nearer input row + the farther
    one (rows above the first and below the last replicated), then along a
    row 3 x the nearer column sum + the farther, + 8 or + 7, / 16 (the
    columns beyond either end replicated)."""
    above = torch.cat([c[:, :1], c[:, :-1]], 1)
    below = torch.cat([c[:, 1:], c[:, -1:]], 1)
    rows = torch.stack([3 * c + above, 3 * c + below], 2).flatten(1, 2)
    left = torch.cat([rows[:, :, :1], rows[:, :, :-1]], 2)
    right = torch.cat([rows[:, :, 1:], rows[:, :, -1:]], 2)
    return torch.stack([(3 * rows + left + 8) >> 4,
                        (3 * rows + right + 7) >> 4], 3).flatten(2, 3)


def jpeg_roundtrip(images: torch.Tensor, quality: int = 50) -> torch.Tensor:
    """[N, H, W, 3] uint8 RGB -> the same images after libjpeg's encode at
    `quality` and decode (see the module docstring), uint8 on their
    device.  Anything that is not uint8 is refused, as the JAX binding
    refuses it: a float image in [0, 1] would truncate to black."""
    if images.dtype != torch.uint8:
        raise ValueError(f"jpeg_roundtrip expects uint8 RGB, got "
                         f"{images.dtype}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected [N, H, W, 3], got {tuple(images.shape)}")
    n, h, w, _ = images.shape
    lum, chrom = quant_tables(quality)
    r, g, b = images.to(torch.int64).unbind(-1)
    off = CENTER << SCALEBITS
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b
         + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off + ONE_HALF - 1) >> SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off + ONE_HALF - 1) >> SCALEBITS

    # luminance: blocks of 8, the edges replicated; the decoder crops
    y = _code_plane(_pad_to(y, -(-h // 8) * 8, -(-w // 8) * 8), lum)[:, :h,
                                                                      :w]
    ch, cw = -(-h // 2), -(-w // 2)
    up = []
    for c in (cb, cr):
        c = _code_plane(_downsample(c, h, w), chrom)[:, :ch, :cw]
        if cw > 2:
            c = _fancy_upsample(c)
        else:       # jdsample.c: no triangle filter at 2 columns or fewer
            c = c.repeat_interleave(2, 1).repeat_interleave(2, 2)
        up.append(c[:, :h, :w])
    cb, cr = up

    return _ycc_to_rgb(y, cb, cr)


def _ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                cr: torch.Tensor) -> torch.Tensor:
    """`ycc_rgb_convert` (jdcolor.c) of int64 planes -> [..., 3] uint8."""
    x_cb, x_cr = cb - CENTER, cr - CENTER
    red = y + ((_fix(1.40200) * x_cr + ONE_HALF) >> SCALEBITS)
    blue = y + ((_fix(1.77200) * x_cb + ONE_HALF) >> SCALEBITS)
    green = y + ((-_fix(0.34414) * x_cb + ONE_HALF
                  - _fix(0.71414) * x_cr) >> SCALEBITS)
    out = torch.stack([red, green, blue], -1).clamp(0, 255)
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# the decoder's half from a file's coefficients
# ---------------------------------------------------------------------------

def _rows_above_below(c: torch.Tensor, dim: int):
    """c shifted by one along `dim` both ways, the ends replicated."""
    n = c.shape[dim]
    idx = torch.arange(n, device=c.device)
    return (c.index_select(dim, (idx - 1).clamp(min=0)),
            c.index_select(dim, (idx + 1).clamp(max=n - 1)))


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def upsample_component(c: torch.Tensor, rh: int, rv: int) -> torch.Tensor:
    """One component's real samples [h, w] (int64) -> [h * rv, w * rh] by
    libjpeg's method for the ratio: `h2v1_fancy_upsample` (3 x the nearer
    column + the farther, + 1 or + 2, / 4), `h1v2_fancy_upsample` (the
    same down the rows), `h2v2_fancy_upsample` (`_fancy_upsample`), plain
    replication across where a row has 2 samples or fewer
    (`jinit_upsampler`), and boxes at any other integer ratio
    (`int_upsample`)."""
    if (rh, rv) == (1, 1):
        return c
    w = c.shape[1]
    if rh > 2 or rv > 2 or (rh == 2 and w <= 2):
        return c.repeat_interleave(rh, 1).repeat_interleave(rv, 0)
    if (rh, rv) == (2, 2):
        return _fancy_upsample(c[None])[0]
    dim = 1 if rh == 2 else 0
    before, after = _rows_above_below(c, dim)
    return _interleave((3 * c + before + 1) >> 2, (3 * c + after + 2) >> 2,
                       dim)


# ---------------------------------------------------------------------------
# block smoothing of unfinished progressive coefficients (jdcoefct.c,
# libjpeg-turbo 2.1: `smoothing_ok`, `decompress_smooth_data`)
# ---------------------------------------------------------------------------

def _kernel(*cells) -> np.ndarray:
    """A 5 x 5 weight table over the window's DC values (rows two above
    to two below, columns two left to two right) from (row, col, weight)
    triples."""
    k = np.zeros((5, 5), np.int64)
    for r, c, w in cells:
        k[r, c] = w
    return k


def _rows(*rows) -> np.ndarray:
    return np.array(rows, np.int64)


# (natural position, weights when no AC coefficient is known (the DC too
# is estimated then), weights otherwise (None: not estimated)), zigzag 1-9
_SMOOTH = [
    (1, _rows([-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
              [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]),
     _kernel((2, 0, -7), (2, 1, 50), (2, 3, -50), (2, 4, 7))),
    (8, _rows([-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5,
              [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]),
     _kernel((0, 2, -7), (1, 2, 50), (3, 2, -50), (4, 2, 7))),
    (16, _rows([0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
               [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]),
     _kernel((0, 2, -1), (1, 2, 13), (2, 2, -24), (3, 2, 13), (4, 2, -1))),
    (9, _kernel((0, 0, -1), (0, 4, 1), (1, 1, 9), (1, 3, -9), (3, 1, -9),
                (3, 3, 9), (4, 0, 1), (4, 4, -1)),
     _kernel((1, 4, 1), (3, 0, 1), (3, 1, -10), (3, 3, 10), (0, 1, -1),
             (3, 4, -1), (4, 1, 1), (4, 3, -1), (0, 3, 1), (1, 0, -1),
             (1, 1, 10), (1, 3, -10))),
    (2, _rows([0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
              [0, 2, -5, 2, 0], [0] * 5),
     _kernel((2, 0, -1), (2, 1, 13), (2, 2, -24), (2, 3, 13), (2, 4, -1))),
    (3, _kernel((1, 1, 1), (1, 3, -1), (2, 1, 2), (2, 3, -2), (3, 1, 1),
                (3, 3, -1)), None),
    (10, _kernel((1, 1, 1), (1, 2, -3), (1, 3, 1), (3, 1, -1), (3, 2, 3),
                 (3, 3, -1)), None),
    (17, _kernel((1, 1, 1), (1, 3, -1), (2, 1, -3), (2, 3, 3), (3, 1, 1),
                 (3, 3, -1)), None),
    (24, _kernel((1, 1, 1), (1, 2, 2), (1, 3, 1), (3, 1, -1), (3, 2, -2),
                 (3, 3, -1)), None),
]
_SMOOTH_DC = _rows([-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                   [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                   [-2, -6, -8, -6, -2])


def _window_rows(v: int, cbh: int, total_rows: int) -> np.ndarray:
    """[cbh, 5] the block rows of each row's window as
    `decompress_smooth_data` picks them: a row above or below is taken
    while its block row lies within the iMCU row, or while the iMCU row
    has one (two for the second row) before it or after it, else the
    nearer one repeats; within the last iMCU row only `cbh % v` (or v)
    rows count."""
    out = np.zeros((cbh, 5), np.int64)
    last = total_rows - 1
    for row in range(total_rows):
        block_rows = v if row < last else (cbh % v or v)
        for br in range(block_rows):
            a = row * v + br
            if a >= cbh:
                continue
            prev = a - 1 if br > 0 or row > 0 else a
            nxt = a + 1 if br < block_rows - 1 or row < last else a
            out[a] = (a - 2 if br > 1 or row > 1 else prev, prev, a, nxt,
                      a + 2 if br < block_rows - 2 or row + 1 < last
                      else nxt)
    return out


def _window_cols(cbw: int) -> np.ndarray:
    """[cbw, 5] the block columns of each column's window: the sliding
    registers start at column 0 and take column c + 2 while c + 1 is below
    the last column."""
    out = np.zeros((cbw, 5), np.int64)
    reg = [0] * 5
    for b in range(cbw):
        if b == 0 and cbw > 1:
            reg[3] = 1
        if b + 1 < cbw - 1:
            reg[4] = b + 2
        out[b] = reg
        reg = reg[1:] + reg[-1:]
    return out


def _estimate(num: torch.Tensor, q: int, al) -> torch.Tensor:
    """(q << 7 + |num|) // (q << 8) with num's sign, kept below 1 << al
    where al > 0, wrapped to int16 as libjpeg's JCOEF."""
    pred = ((q << 7) + num.abs()) // (q << 8)
    if al is not None:
        cap = torch.where(al > 0, (1 << al.clamp(min=0)) - 1, pred)
        pred = torch.minimum(pred, cap)
    pred = torch.where(num < 0, -pred, pred)
    return ((pred + 32768) & 0xFFFF) - 32768


def smooth_coefficients(blocks, quant, sampling, size, coef_bits,
                        prev_bits, last_row: int) -> list:
    """libjpeg-turbo 2.1's block smoothing of a progressive file's
    quantized blocks: in every real block, each of the first nine AC
    coefficients that is 0 and not known to full precision is estimated
    from the DC values of the 5 x 5 blocks around it (the window's edges
    as libjpeg picks them: `_window_rows`, `_window_cols`); where no AC
    coefficient of the first nine is known at all, the DC too, by a
    Gaussian-like kernel.  An estimate divides by its quantizer with
    rounding, kept within the bits still unknown.  The rows after
    `last_row` (the last iMCU row of the last scan begun with data) take
    the precision from before the component's latest scan.

    blocks, quant, sampling, size: as `decode_from_coefficients`;
    coef_bits, prev_bits: [components, >= 10] libjpeg's coef_bits (zigzag
    order), now and before the latest scan.  -> the blocks, int64, on
    their device."""
    width, height = size
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    coef_bits = np.asarray(coef_bits)[:, :10]
    prev_bits = np.asarray(prev_bits)[:, :10]
    total_rows = blocks[0].shape[0] // sampling[0][1]      # iMCU rows
    out = []
    for ci, (coef, q, (h, v)) in enumerate(zip(blocks, quant, sampling)):
        coef = torch.as_tensor(coef).to(torch.int64)
        dev = coef.device
        q = np.asarray(torch.as_tensor(q).cpu()).reshape(64).astype(np.int64)
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        cbw, cbh = -(-dw // 8), -(-dh // 8)          # the real blocks
        rows = torch.from_numpy(_window_rows(v, cbh, total_rows)).to(dev)
        cols = torch.from_numpy(_window_cols(cbw)).to(dev)
        dc = coef[..., 0, 0]
        win = dc[rows][:, :, cols].permute(0, 2, 1, 3)  # [cbh, cbw, 5, 5]
        late = torch.arange(cbh, device=dev) // v > last_row
        bits = torch.where(late[:, None],
                           torch.from_numpy(prev_bits[ci]).to(dev),
                           torch.from_numpy(coef_bits[ci]).to(dev))
        change_dc = (bits[:, 1:] == -1).all(1)[:, None]      # [cbh, 1]
        real = coef[:cbh, :cbw].reshape(cbh, cbw, 64)
        new = real.clone()

        def weigh(kernel):
            k = torch.from_numpy(kernel).to(dev)
            return q[0] * (win * k).sum((-2, -1))

        for zz, (pos, k_dc, k_ac) in enumerate(_SMOOTH, 1):
            al = bits[:, zz][:, None]
            num = weigh(k_dc)
            ok = change_dc
            if k_ac is not None:
                num = torch.where(change_dc, num, weigh(k_ac))
                ok = torch.ones_like(change_dc)
            est = _estimate(num, int(q[pos]), al)
            take = ok & (al != 0) & (real[..., pos] == 0)
            new[..., pos] = torch.where(take, est, real[..., pos])
        est = _estimate(weigh(_SMOOTH_DC), int(q[0]), None)
        new[..., 0] = torch.where(change_dc, est, real[..., 0])
        full = coef.clone()
        full[:cbh, :cbw] = new.reshape(cbh, cbw, 8, 8)
        out.append(full)
    return out


def decode_from_coefficients(blocks, quant, sampling, size,
                             color: str = "ycbcr",
                             progress=None) -> torch.Tensor:
    """A JPEG's quantized blocks -> [H, W, 3] uint8 RGB, libjpeg-turbo's
    default decode (JDCT_ISLOW, fancy upsampling, JCS_RGB; grey
    replicated).

    blocks: per component [blocks down, blocks across, 8, 8] (the MCU
    grid's), natural order; quant: [components, 8, 8], each component's
    table; sampling: per component (h, v), dividing the largest; size:
    (width, height); color: "grey", "ycbcr", "rgb", "cmyk" or "ycck" (four
    components, as PIL's `convert("RGB")` gives them: `_pil_cmyk_to_rgb`);
    progress: `image_decode.JpegProgress` of a progressive file, whose
    unfinished coefficients are then smoothed first (`smooth_coefficients`)
    where libjpeg smooths them.  Computed on the device of the first block
    tensor (numpy arrays: the CPU)."""
    width, height = size
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if progress is not None and progress.smooth:
        blocks = smooth_coefficients(blocks, quant, sampling, size,
                                     progress.coef_bits, progress.prev_bits,
                                     progress.last_row)
    planes = []
    for coef, q, (h, v) in zip(blocks, quant, sampling):
        coef = torch.as_tensor(coef).to(torch.int64)
        q = torch.as_tensor(q).to(coef.device, torch.int64)
        dw = -(-width * h // hmax)
        dh = -(-height * v // vmax)
        plane = _unblocks(_idct_blocks(coef, q)[None])[0][:dh, :dw]
        up = upsample_component(plane, hmax // h, vmax // v)
        planes.append(up[:height, :width])
    if color == "grey":
        return planes[0].to(torch.uint8)[..., None].expand(
            height, width, 3).contiguous()
    if color == "rgb":
        return torch.stack(planes, -1).to(torch.uint8)
    if color == "cmyk":
        return _pil_cmyk_to_rgb(255 - torch.stack(planes[:3], -1), planes[3])
    if color == "ycck":
        # libjpeg's ycck_cmyk_convert gives 255 minus the YCbCr tables'
        # clamped RGB, which Pillow's inversion turns back
        return _pil_cmyk_to_rgb(_ycc_to_rgb(*planes[:3]).to(torch.int64),
                                planes[3])
    return _ycc_to_rgb(*planes)


def _pil_cmyk_to_rgb(inverted: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pillow's RGB of libjpeg's CMYK output: Pillow reads it as "CMYK;I"
    (every byte inverted: `inverted` is 255 - C, M, Y, [H, W, 3] int64, and
    its K is 255 - k), then `cmyk2rgb` (Convert.c): with nk = 255 - its K
    = k, each channel nk - MULDIV255(channel, nk), clipped."""
    nk = k[..., None]
    tmp = inverted * nk + 128
    return (nk - (((tmp >> 8) + tmp) >> 8)).clamp(0, 255).to(torch.uint8)
