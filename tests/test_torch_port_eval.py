"""The port's eval protocol (`aqualora_torch/eval/`, `tools/create_wm_lora.py`)
against the JAX package and Pillow, on the CPU at the tiny config.

- PNG: the hand-written writer against Pillow's reader, the reader against
  Pillow's writer (RGB, RGBA, L, LA, with Pillow's adaptive row filters).
- PIL's bicubic resize, computed without PIL, against Pillow bit for bit;
  the quantization against the JAX package's `_to_uint8_device`.
- The fold of `create_wm_lora`, the guards of `resolve_watermark_lora` and
  `run_eval_base`, `simple_decode` on the same PNGs, `simple_sample` on
  both paths (a folded LoRA; one message per image), and the whole
  `run_eval_base --tiny` in both flows, each against the JAX package.

The JAX side runs jitted on the CPU.  Weights cross over through
`jax_params_to_torch`; the JAX decoder tree is written as the JAX package's
orbax directory and as the port's `msgdecoder.pt`.  The JAX pipeline draws
its initial latents from per-image key stacks; the tests hand the port the
same latents (its `batch_randn` replays them), so both sides denoise the
same numbers.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core import io as tio
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.eval import image_io
from aqualora_tpu.core import io as jio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
BITS = jcfg.WatermarkConfig.tiny().msg_bits           # 8
HIDINFO = "10110010"
# float32 images through the same weights and latents: the tolerance of the
# pipeline tests (tests/test_torch_port_artifacts.py)
IMAGE_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host, and a thread pool as wide as the host
    in each of them oversubscribes the cores (the tiny torch ops here then
    run one to two orders of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, seed):
    """Seeded random leaves for an eval_shape tree: norm scales 1, biases 0,
    everything else N(0, 1/fan_in), so every LoRA up weight is non-zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _stats(shapes, seed):
    """BatchNorm statistics: mean N(0, 0.1^2), variance U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _clip_diffusers_key(k):
    if k.startswith(("token_embedding", "position_embedding")):
        return "text_model.embeddings." + k
    if k.startswith("layers."):
        return "text_model.encoder." + k
    return "text_model." + k


def _write_diffusers_dir(root, params):
    """A diffusers-layout checkpoint of JAX weights (the U-Net without its
    LoRA, the VAE, the text encoder under diffusers' CLIP names), which
    both packages' `--model_path` loaders read."""
    unet = {k: v for k, v in jio.flax_params_to_torch_state(
        params["unet"]).items() if ".lora." not in k}
    clip = {_clip_diffusers_key(k): v for k, v in
            jio.flax_params_to_torch_state(params["text_encoder"]).items()}
    clip["text_model.embeddings.position_ids"] = np.arange(
        77, dtype=np.int64)[None]
    for sub, state in (("unet/diffusion_pytorch_model.safetensors", unet),
                       ("vae/diffusion_pytorch_model.safetensors",
                        jio.flax_params_to_torch_state(params["vae"])),
                       ("text_encoder/model.safetensors", clip)):
        os.makedirs(os.path.dirname(os.path.join(root, sub)), exist_ok=True)
        tio.save_safetensors({k: torch.from_numpy(np.array(v)) for k, v in
                              state.items()}, os.path.join(root, sub))


def _torch_params(params):
    return {name: jax_params_to_torch(jax.tree_util.tree_map(
        np.asarray, params[name]))
        for name in ("text_encoder", "unet", "vae", "mapper")}


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Seeded tiny weights and the artifact folder both packages read: the
    U-Net LoRA and the mapper (written by the port's `save_artifacts`), the
    decoder as the port's msgdecoder.pt and as the JAX package's orbax
    directory, and a diffusers-layout base checkpoint."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train import ppft_train as tpt
    from aqualora_tpu.core.checkpoint import save_pytree
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    from aqualora_tpu.models.watermark import SecretDecoder as JDec

    root = tmp_path_factory.mktemp("eval_art")
    jpipe = JPipe(jcfg.PipelineConfig.tiny())
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, 32, 32)), 5)
    params = jax.tree_util.tree_map(np.asarray, params)
    dshapes = jax.eval_shape(lambda: JDec(
        BITS, jcfg.EfficientNetConfig.tiny()).init(
        KEY, jnp.zeros((1, 64, 64, 3))))
    dec = {"params": _fill(dshapes["params"], 6),
           "batch_stats": _stats(dshapes["batch_stats"], 7)}
    save_pytree(str(root / "msgdecoder"), dec)

    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.load_jax_params(params)
    tdec = SecretDecoder(BITS, tcfg.EfficientNetConfig.tiny(), device="cpu")
    tdec.load_state_dict(jax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, dec["params"]),
        jax.tree_util.tree_map(np.asarray, dec["batch_stats"])), strict=True)
    wm = root / "wm"
    tpt.save_artifacts(str(wm), pipe, tdec)
    _write_diffusers_dir(str(root / "sd"), params)
    return {"root": root, "params": params, "wm": str(wm),
            "sd": str(root / "sd"), "jdec": str(root / "msgdecoder"),
            "tdec": str(wm / tpt.MSGDECODER_FILE)}


def _run_main(module, argv):
    """A JAX entry point's `main()` (it reads sys.argv) in this process."""
    old = sys.argv
    sys.argv = ["prog"] + list(argv)
    try:
        return module.main()
    finally:
        sys.argv = old


def _jax_latents(seeds, n_prompts, batch, shape=(16, 16, 4)):
    """The initial latents of the JAX simple_sample loop, call by call:
    `key_stack(PRNGKey(seed), i, batch)`, split, then the per-image
    normal draws (`make_generate`)."""
    from aqualora_tpu.diffusion.samplers import (batch_normal, key_stack,
                                                 split_key)
    out = []
    for seed in seeds:
        for i in range(0, n_prompts, batch):
            _, sub = split_key(key_stack(jax.random.PRNGKey(seed), i, batch))
            out.append(torch.from_numpy(np.array(
                batch_normal(sub, (batch,) + shape, jnp.float32))))
    return out


def _skip_jax_eager_inits(mp, art):
    """Two eager flax inits of the JAX entry points cost about a minute on
    the CPU and produce nothing these tests read: the pipeline's
    `init_params` (every value is then replaced by the --model_path
    checkpoint and the LoRA file, or unused, as the mapper in the folded
    flow) and `load_msgdecoder`'s template (restored over from disk).  The
    pipeline gets a copy of the seeded tree instead, and the decoder's
    template is the shape tree of the same `init`."""
    from aqualora_tpu.core.checkpoint import load_pytree
    from aqualora_tpu.core.config import EfficientNetConfig
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.eval import utils_eval as ju
    from aqualora_tpu.models.watermark import SecretDecoder

    def load_msgdecoder(path, bitnum, backbone=None):
        dec = SecretDecoder(bitnum, backbone or EfficientNetConfig.b1())
        shapes = jax.eval_shape(lambda: dec.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        return dec, load_pytree(path, {
            "params": shapes["params"],
            "batch_stats": shapes.get("batch_stats", {})})

    mp.setattr(StableDiffusionPipeline, "init_params",
               lambda self, *a, **k: jax.tree_util.tree_map(
                   np.array, art["params"]))
    mp.setattr(ju, "load_msgdecoder", load_msgdecoder)


class _Replay:
    """Stands in for the pipeline's `batch_randn`: hands out the JAX
    latents in order, and checks that each call brings one generator an
    image."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, shape, generator, device, dtype=torch.float32):
        assert len(generator) == shape[0]
        d = self.draws[self.calls]
        self.calls += 1
        assert tuple(d.shape) == tuple(shape)
        return d.to(device, dtype)


class _Recorder:
    """Wraps a function and keeps its first argument of each call."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, images, *a, **k):
        self.seen.append(np.array(images, dtype=np.float32))
        return self.fn(images, *a, **k)


# ---------------------------------------------------------------------------
# PNG, the bicubic resize, the quantization
# ---------------------------------------------------------------------------

def _png_filters(path):
    """The set of row filter types in an 8-bit, non-interlaced PNG."""
    blob = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", blob[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(blob[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, ctype, *_ = header
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


def _smooth(rng, h, w, c):
    """Gradients plus noise: images whose rows Pillow's adaptive filter
    encodes with every filter type."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 2)[:, :, None] + np.arange(c) * 40
    return ((base + rng.integers(0, 12, (h, w, c))) % 256).astype(np.uint8)


def test_png_writer_reads_back_in_pillow(tmp_path):
    """Pillow decodes the port's PNG (8-bit RGB, filter 0) to the same
    pixels, and the port's reader does too."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for shape in ((32, 32, 3), (17, 45, 3), (1, 1, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "w.png")
        image_io.save_png(path, img)
        with Image.open(path) as im:
            assert im.mode == "RGB" and im.size == (shape[1], shape[0])
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(image_io.load_png(path), img)
        assert _png_filters(path) == {0}
    with pytest.raises(ValueError, match="HWC uint8 RGB"):
        image_io.save_png(path, np.zeros((4, 4), np.uint8))


def test_png_reader_matches_pillow(tmp_path):
    """PNGs that Pillow writes (RGB, RGBA, L, LA; plain and `optimize`,
    several IDAT chunks) read to `np.asarray(Image.open(p).convert("RGB"))`
    exactly; the files use all five row filters between them."""
    from PIL import Image, PngImagePlugin

    rng = np.random.default_rng(1)
    used = set()
    chunk = PngImagePlugin.ImageFile.MAXBLOCK
    for mode, c in (("RGB", 3), ("RGBA", 4), ("L", 1), ("LA", 2)):
        for optimize in (False, True):
            a = _smooth(rng, 37, 53, c)
            a[5:8] = 0       # all-zero rows, which the encoder leaves unfiltered
            img = Image.fromarray(a[:, :, 0] if c == 1 else a, mode)
            path = str(tmp_path / f"{mode}_{optimize}.png")
            PngImagePlugin.ImageFile.MAXBLOCK = 1024    # many IDAT chunks
            try:
                img.save(path, optimize=optimize)
            finally:
                PngImagePlugin.ImageFile.MAXBLOCK = chunk
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB"))
            got = image_io.load_png(path)
            assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
            np.testing.assert_array_equal(got, want, err_msg=path)
            used |= _png_filters(path)
    assert used == {0, 1, 2, 3, 4}


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    """What the reader used to refuse it now reads as libpng does (16-bit
    cut to its high byte, or clipped to 255 as PIL under `pil=True`;
    palettes; Adam7; the kinds: tests/test_torch_port_data.py).  What
    is not a PNG is refused with a clear error: a colour type at a bit
    depth PNG does not allow, an unknown interlace method, image data
    that does not fill the header's image, a corrupted chunk."""
    from PIL import Image

    rng = np.random.default_rng(2)
    deep = str(tmp_path / "deep.png")
    wide = rng.integers(0, 65535, (8, 8), dtype=np.uint16)
    Image.fromarray(wide).save(deep)
    got = image_io.load_png(deep)
    np.testing.assert_array_equal(got[..., 0], (wide >> 8).astype(np.uint8))
    with Image.open(deep) as im:
        np.testing.assert_array_equal(image_io.load_png(deep, pil=True),
                                      np.asarray(im.convert("RGB")))
    pal = str(tmp_path / "pal.png")
    Image.fromarray(_smooth(rng, 8, 8, 3)).convert("P").save(pal)
    with Image.open(pal) as im:
        np.testing.assert_array_equal(image_io.load_png(pal),
                                      np.asarray(im.convert("RGB")))

    plain = str(tmp_path / "plain.png")
    image_io.save_png(plain, _smooth(rng, 8, 8, 3))
    blob = bytearray(open(plain, "rb").read())

    def patched(offset, value, name):
        b = bytearray(blob)
        b[offset] = value
        b[29:33] = struct.pack(">I", zlib.crc32(bytes(b[12:29])))
        path = str(tmp_path / name)
        open(path, "wb").write(bytes(b))
        return path

    # IHDR's bytes 16-28: width, height, depth, colour type, ..., interlace
    with pytest.raises(ValueError, match="bit depth 4"):
        image_io.load_png(patched(8 + 8 + 8, 4, "depth.png"))
    with pytest.raises(ValueError, match="interlace 2"):
        image_io.load_png(patched(8 + 8 + 12, 2, "method.png"))
    # an Adam7 header over plain rows: the second pass starts mid-row
    with pytest.raises(ValueError, match="filter type|image data has"):
        image_io.load_png(patched(8 + 8 + 12, 1, "inter.png"))
    blob[40] ^= 0xFF
    bad = str(tmp_path / "crc.png")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        image_io.load_png(bad)


@pytest.mark.parametrize("src,size", [
    ((53, 37), (64, 64)),          # up, from a non-square image
    ((300, 300), (512, 512)),      # up
    ((512, 512), (256, 256)),      # down by 2
    ((513, 513), (512, 512)),      # down by one pixel
    ((64, 64), (64, 64)),          # unchanged: a copy
    ((100, 37), (13, 200)),        # down in one axis, up in the other
    ((40, 60), (60, 40)),          # one pass each way
    ((7, 9), (3, 2)),              # tiny, the window at both borders
])
def test_bicubic_matches_pillow(src, size):
    """`resize_bicubic_pil` equals Pillow's `Image.resize(size, BICUBIC)` on
    RGB bit for bit, on uniform noise (which clips) and on smooth images."""
    from PIL import Image

    rng = np.random.default_rng(sum(src) + sum(size))
    for img in (rng.integers(0, 256, src + (3,), dtype=np.uint8),
                _smooth(rng, *src, 3)):
        want = np.asarray(Image.fromarray(img).resize(
            size, Image.Resampling.BICUBIC))
        got = image_io.resize_bicubic_pil(img, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        if tuple(size) == src[::-1]:
            assert got is not img


def test_preprocess_matches_the_jax_process(tmp_path):
    """`preprocess` on a path, an array and a PIL image (RGB, RGBA, L)
    against the JAX package's `process` (PIL open, convert, bicubic, / 127.5
    - 1), bit for bit."""
    from PIL import Image

    rng = np.random.default_rng(3)

    def process(img, res):                       # utils_eval.py:409-416
        if not isinstance(img, Image.Image):
            img = Image.open(img)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img = img.resize((res, res), resample=Image.Resampling.BICUBIC)
        return np.asarray(img, np.uint8).astype(np.float32) / 127.5 - 1.0

    a = _smooth(rng, 40, 33, 3)
    path = str(tmp_path / "a.png")
    image_io.save_png(path, a)
    for res in (32, 48):
        want = process(path, res)
        assert want.dtype == np.float32
        for x in (path, a, torch.from_numpy(a), Image.fromarray(a)):
            np.testing.assert_array_equal(image_io.preprocess(x, res), want)
        for mode in ("RGBA", "L"):
            pil = Image.fromarray(a).convert(mode)
            np.testing.assert_array_equal(image_io.preprocess(pil, res),
                                          process(pil, res))
    with pytest.raises(ValueError, match="mode P"):
        image_io.preprocess(Image.fromarray(a).convert("P"), 32)


def test_images_to_uint8_matches_jax():
    """`images_to_uint8` against `_to_uint8_device`, float32 and bf16, bit
    for bit, on values that land on exact .5 ties (ties to even), outside
    [-1, 1] and at random; numpy input takes the numpy rule."""
    from aqualora_tpu.eval.utils_eval import _to_uint8_device

    rng = np.random.default_rng(4)
    ties = []
    for k in range(255):
        x = np.float32((k + 0.5) / 127.5 - 1)
        for _ in range(6):
            y = (x + np.float32(1.0)) * np.float32(127.5)
            if y == k + 0.5:
                ties.append(x)
            x = np.nextafter(x, np.float32(2))
    assert len(ties) > 100
    x = np.concatenate([np.array(ties, np.float32), [-1.5, -1, 0, 1, 1.5],
                        rng.uniform(-1.1, 1.1, 1000).astype(np.float32)])
    x = x[: len(x) // 3 * 3].reshape(1, -1, 1, 3)
    to_uint8 = jax.jit(_to_uint8_device)
    want = np.asarray(to_uint8(jnp.asarray(x)))
    got = image_io.images_to_uint8(torch.from_numpy(x))
    np.testing.assert_array_equal(got, want)
    halves = np.round((x + np.float32(1)) * np.float32(127.5))
    assert (halves % 2 == 0).sum() > (halves % 2 == 1).sum() // 2
    bf = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        image_io.images_to_uint8(torch.from_numpy(x).bfloat16()),
        np.asarray(to_uint8(bf)))
    np.testing.assert_array_equal(
        image_io.images_to_uint8(x.astype(np.float64)),
        ((((x.astype(np.float64) + 1) * 127.5).round()).clip(0, 255)
         .astype(np.uint8)))


def test_prompts_copy_matches_jax(tmp_path):
    """The port's `eval/prompts.py` gives what the JAX package's gives, and
    refuses what it refuses."""
    from aqualora_torch.eval import prompts as tp
    from aqualora_tpu.eval import prompts as jp

    for n in (1, 7, 100):
        assert tp.builtin_prompts(n) == jp.builtin_prompts(n)
        assert tp.load_prompts(None, n) == jp.load_prompts(None, n)
    f = tmp_path / "p.txt"
    f.write_text("a cat\n\n  a dog  \nan owl\n")
    assert tp.load_prompts(str(f), 3) == jp.load_prompts(str(f), 3)
    for mod in (tp, jp):
        with pytest.raises(ValueError):
            mod.builtin_prompts(101)
        with pytest.raises(ValueError):
            mod.load_prompts(str(f), 4)
        with pytest.raises(FileNotFoundError):
            mod.load_prompts(str(tmp_path / "none.txt"), 1)


# ---------------------------------------------------------------------------
# the fold and the guards
# ---------------------------------------------------------------------------

def _ulp_close(got: torch.Tensor, want: np.ndarray, what: str):
    """got (float32) within one float32 ulp of want (any float type)."""
    g = got.numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
    assert got.dtype == torch.float32, what
    assert np.all(np.abs(g - w) <= ulp), (what, np.abs(g - w).max())


def test_create_watermark_lora_matches_jax(art, tmp_path):
    """The fold against JAX's: the same bitstring for a `hidinfo` and for
    `default_rng(0)`, every tensor within one float32 ulp, text-encoder
    keys dropped, the saved file equal to the returned tensors; the mapper
    diagonal of one message and of a batch equal to JAX's; a mapper.pt
    folder reads as the safetensors one."""
    from aqualora_torch.tools import create_wm_lora as tc
    from aqualora_tpu.tools import create_wm_lora as jc

    folder = tmp_path / "f"
    shutil.copytree(art["wm"], folder)
    lora = tio.load_safetensors(str(folder / tio.LORA_FILE))
    lora["text_encoder.layers.0.q.lora.down.weight"] = torch.ones(2, 2)
    tio.save_safetensors(lora, str(folder / tio.LORA_FILE))
    for how in ("hidinfo", "rng"):
        kw = [{"hidinfo": HIDINFO} if how == "hidinfo" else
              {"rng": np.random.default_rng(0)} for _ in range(2)]
        tbits, tout = tc.create_watermark_lora(str(folder), msg_bits=BITS,
                                               save=False, **kw[0])
        jbits, jout = jc.create_watermark_lora(str(folder), msg_bits=BITS,
                                               save=False, **kw[1])
        assert tbits == jbits and len(tbits) == BITS
        assert set(tout) == set(jout) and not any(
            "text_encoder" in k for k in tout)
        for k in jout:
            _ulp_close(tout[k], jout[k], k)
        downs = [k for k in tout if "down.weight" in k]
        assert any("proj_in" in k for k in downs)
        assert not torch.equal(tout[downs[0]], lora[downs[0]])
    assert tc.main(["--train_folder", str(folder), "--msg_bits", str(BITS),
                    "--hidinfo", HIDINFO]) == HIDINFO
    saved = tio.load_safetensors(str(folder / HIDINFO / tio.LORA_FILE))
    _, again = tc.create_watermark_lora(str(folder), msg_bits=BITS,
                                        hidinfo=HIDINFO, save=False)
    assert set(saved) == set(again)
    assert all(torch.equal(saved[k], again[k]) for k in saved)

    tstate = tc.load_mapper_state(str(folder))
    jstate = jc.load_mapper_state(str(folder))
    msgs = np.random.default_rng(5).integers(0, 2, (3, BITS))
    for m in (msgs[0], msgs):
        np.testing.assert_array_equal(tc.mapper_diag_from_state(tstate, m),
                                      jc.mapper_diag_from_state(jstate, m))
    rank = tstate["bit_embeddings.weight"].shape[1]
    assert tc.mapper_diag_from_state(tstate, msgs[0]).shape == (1, rank)
    assert tc.mapper_diag_from_state(tstate, msgs).shape == (3, rank)
    # the reference's mapper.pt in place of mapper.safetensors
    os.remove(folder / tio.MAPPER_FILE)
    torch.save({"bit_embeddings.weight": tstate["bit_embeddings.weight"]},
               folder / "mapper.pt")
    pt_state = tc.load_mapper_state(str(folder))
    assert torch.equal(pt_state["bit_embeddings.weight"],
                       tstate["bit_embeddings.weight"])
    np.testing.assert_array_equal(
        np.asarray(jc.load_mapper_state(str(folder))["bit_embeddings.weight"]),
        tstate["bit_embeddings.weight"].numpy())


def test_create_watermark_lora_guards_match_jax(art, tmp_path):
    """A `hidinfo` of the wrong length or with other characters, a width
    that is not the mapper's and a key of no known module raise in both."""
    from aqualora_torch.tools import create_wm_lora as tc
    from aqualora_tpu.tools import create_wm_lora as jc

    for mod in (tc, jc):
        for kw, match in (({"hidinfo": "101"}, "hidinfo has 3"),
                          ({"hidinfo": "1011001x"}, "0/1 bitstring"),
                          ({"msg_bits": 16, "hidinfo": "10" * 8},
                           "msg_bits 16")):
            kw = {"msg_bits": BITS, **kw}
            with pytest.raises(ValueError, match=match):
                mod.create_watermark_lora(art["wm"], save=False, **kw)
    folder = tmp_path / "odd"
    shutil.copytree(art["wm"], folder)
    lora = tio.load_safetensors(str(folder / tio.LORA_FILE))
    lora["vae.x.lora.down.weight"] = torch.ones(2, 2)
    tio.save_safetensors(lora, str(folder / tio.LORA_FILE))
    for mod in (tc, jc):
        with pytest.raises(ValueError, match="not recognized"):
            mod.create_watermark_lora(str(folder), msg_bits=BITS,
                                      hidinfo=HIDINFO, save=False)


def test_resolve_watermark_lora_guards(art, tmp_path):
    """`test_resolve_watermark_lora_guards` of tests/test_eval_runners.py for
    the port, beside JAX's: neither or both sources, --lora_scale or
    --msg_gt with a training folder, --hidinfo with a pre-folded file, a
    scale on a layout without '*up.weight'; --lora_scale scales the up
    weights as JAX's does."""
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_torch.tools.create_wm_lora import create_watermark_lora
    from aqualora_tpu.eval import utils_eval as ju

    folder = tmp_path / "g"
    shutil.copytree(art["wm"], folder)
    create_watermark_lora(str(folder), msg_bits=BITS, hidinfo=HIDINFO)
    folded = str(folder / HIDINFO / tio.LORA_FILE)
    alien = str(tmp_path / "peft_layout.safetensors")
    tio.save_safetensors({"x.lora_A.weight": torch.zeros(2, 2),
                          "x.lora_B.weight": torch.zeros(2, 2)}, alien)
    for mod in (tu, ju):
        for args, kw, match in (
                ((None, None, 1.0, None, BITS), {}, "exactly one"),
                ((str(folder), folded, 1.0, None, BITS), {}, "exactly one"),
                ((str(folder), None, 1.2, None, BITS), {}, "lora_scale"),
                ((str(folder), None, 1.0, HIDINFO, BITS), {}, "msg_gt"),
                ((None, folded, 1.0, HIDINFO, BITS), {"hidinfo": HIDINFO},
                 "hidinfo"),
                ((None, alien, 1.2, HIDINFO, BITS), {}, "up.weight")):
            with pytest.raises(SystemExit, match=match):
                mod.resolve_watermark_lora(*args, **kw)
        _, state = mod.resolve_watermark_lora(None, alien, 1.0, HIDINFO, BITS)
        assert "x.lora_A.weight" in state
    tbits, tstate = tu.resolve_watermark_lora(None, folded, 1.2, HIDINFO, BITS)
    jbits, jstate = ju.resolve_watermark_lora(None, folded, 1.2, HIDINFO, BITS)
    assert tbits == jbits == HIDINFO and set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]),
                                      err_msg=k)
    # the training-folder flow folds default_rng(0)'s message, as JAX's
    assert (tu.resolve_watermark_lora(str(folder), None, 1.0, None, BITS)[0]
            == ju.resolve_watermark_lora(str(folder), None, 1.0, None,
                                         BITS)[0])


def test_run_eval_base_flag_validation(art, tmp_path):
    """`test_run_eval_base_flag_validation` and
    `test_run_eval_base_lora_without_msg_gt_fails_before_generation` of
    tests/test_eval_runners.py for the port: no LoRA source, a non-square
    --height/--width, --lora_scale or --msg_gt with --train_folder and
    --lora without --msg_gt all exit before generating; --int8 is refused
    (ROADMAP A.8); --device defaults to cuda."""
    from aqualora_torch.eval import run_eval_base as tr
    from aqualora_torch.tools.create_wm_lora import create_watermark_lora

    dec = ["--msgdecoder_path", art["tdec"], "--device", "cpu", "--tiny"]
    out = str(tmp_path / "out")
    for argv, match in (
            ([], "exactly one"),
            (["--train_folder", art["wm"], "--height", "64", "--width",
              "32"], "non-square"),
            (["--train_folder", art["wm"], "--lora_scale", "1.2"],
             "lora_scale"),
            (["--train_folder", art["wm"], "--msg_gt", HIDINFO], "msg_gt"),
            (["--train_folder", art["wm"], "--int8"], "A.8")):
        with pytest.raises(SystemExit, match=match):
            tr.main(["--output_dir", out] + argv + dec)
    folder = tmp_path / "h"
    shutil.copytree(art["wm"], folder)
    create_watermark_lora(str(folder), msg_bits=BITS, hidinfo=HIDINFO)
    with pytest.raises(SystemExit, match="msg_gt"):
        tr.main(["--lora", str(folder / HIDINFO / tio.LORA_FILE),
                 "--output_dir", out, "--num_prompts", "2", "--num_seeds",
                 "1"] + dec)
    assert not os.path.isdir(os.path.join(out, "images"))
    assert tr.build_argparser().parse_args([]).device == "cuda"


# ---------------------------------------------------------------------------
# the whole runner, decode and sample
# ---------------------------------------------------------------------------

RUNNER = ["--num_prompts", "3", "--num_seeds", "2", "--batch_size", "2",
          "--fpr", "1e-2", "--tiny"]


@pytest.fixture(scope="module")
def runs(art, tmp_path_factory):
    """`run_eval_base --tiny` in both packages and both flows on the same
    base checkpoint and artifact folder, the port fed the JAX latents:
    the one-step flow (--train_folder --hidinfo) and the two-step flow
    (create_wm_lora's CLI, then --lora --msg_gt, each package in its own
    copy of the folder).  Records each run's result, its float images
    before quantization and its PNG paths."""
    from aqualora_torch.diffusion import pipeline as tpl
    from aqualora_torch.eval import run_eval_base as tr
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_torch.tools import create_wm_lora as tc
    from aqualora_tpu.eval import run_eval_base as jr
    from aqualora_tpu.eval import utils_eval as ju
    from aqualora_tpu.tools import create_wm_lora as jc

    root = tmp_path_factory.mktemp("runs")
    folders = {}
    for side in "tj":
        folders[side] = root / f"wm_{side}"
        shutil.copytree(art["wm"], folders[side])
    _run_main(jc, ["--train_folder", str(folders["j"]), "--msg_bits",
                   str(BITS), "--hidinfo", HIDINFO])
    tc.main(["--train_folder", str(folders["t"]), "--msg_bits", str(BITS),
             "--hidinfo", HIDINFO])
    flows = {
        "one_step": lambda side: ["--train_folder", str(folders[side]),
                                  "--hidinfo", HIDINFO],
        "two_step": lambda side: [
            "--lora", str(folders[side] / HIDINFO / tio.LORA_FILE),
            "--msg_gt", HIDINFO, "--height", "32", "--width", "32"]}
    out = {}
    for flow, flags in flows.items():
        common = ["--model_path", art["sd"]] + RUNNER
        jrec = _Recorder(ju.images_to_pil)
        trec = _Recorder(tu.images_to_uint8)
        replay = _Replay(_jax_latents(range(2), 3, 2))
        with pytest.MonkeyPatch.context() as mp:
            _skip_jax_eager_inits(mp, art)
            mp.setattr(ju, "images_to_pil", jrec)
            mp.setattr(tu, "images_to_uint8", trec)
            mp.setattr(tpl, "batch_randn", replay)
            jres = _run_main(jr, common + flags("j") + [
                "--msgdecoder_path", art["jdec"],
                "--output_dir", str(root / f"{flow}_j")])
            tres = tr.main(common + flags("t") + [
                "--msgdecoder_path", art["tdec"], "--device", "cpu",
                "--output_dir", str(root / f"{flow}_t")])
        assert replay.calls == len(replay.draws) == 4
        out[flow] = {
            side: {"result": res, "images": np.concatenate(rec.seen),
                   "json": json.load(open(root / f"{flow}_{side}" /
                                          "eval_base.json")),
                   "pngs": sorted((root / f"{flow}_{side}" / "images")
                                  .glob("*.png"))}
            for side, res, rec in (("j", jres, jrec), ("t", tres, trec))}
    return out


@pytest.mark.parametrize("flow", ["one_step", "two_step"])
def test_run_eval_base_tiny_matches_jax(runs, flow):
    """Both flows of the runner give what JAX's give: the message,
    n_images, bit accuracy and TPR in eval_base.json (and the returned
    result) are equal; the float images before quantization agree within
    IMAGE_TOL and the PNGs within one level; the PNG names are JAX's."""
    j, t = runs[flow]["j"], runs[flow]["t"]
    for key in ("message", "n_images", "bit_acc", "tpr", "sampler", "fpr"):
        assert t["json"][key] == j["json"][key], key
        assert t["result"][key] == j["result"][key], key
    assert t["json"]["message"] == HIDINFO and t["json"]["n_images"] == 6
    assert [p.name for p in t["pngs"]] == [p.name for p in j["pngs"]]
    # 2 seeds x 2 calls of batch 2, the last row of each seed the padding
    assert t["images"].shape == j["images"].shape == (8, 32, 32, 3)
    assert j["images"].std() > 0.1
    np.testing.assert_allclose(t["images"], j["images"], atol=IMAGE_TOL)
    from PIL import Image
    for tp, jp in zip(t["pngs"], j["pngs"]):
        a = image_io.load_png(str(tp)).astype(np.int16)
        with Image.open(jp) as im:
            b = np.asarray(im.convert("RGB")).astype(np.int16)
        assert np.abs(a - b).max() <= 1, tp.name


def test_both_flows_give_the_same_images(runs):
    """The folded file read back (two-step) and the fold in memory
    (one-step) give the same images in the port, bit for bit."""
    one, two = runs["one_step"]["t"], runs["two_step"]["t"]
    np.testing.assert_array_equal(one["images"], two["images"])
    for a, b in zip(one["pngs"], two["pngs"]):
        assert a.name == b.name
        np.testing.assert_array_equal(image_io.load_png(str(a)),
                                      image_io.load_png(str(b)))


def test_simple_decode_matches_jax(art, runs, tmp_path, monkeypatch):
    """`simple_decode` on the same PNG files in both packages (the runner's
    six, twelve of another size through the bicubic resize, two batches of
    16 with the last zero-padded): the same bitstrings, bit accuracy and
    TPR, margins within 1e-4 * max|m| + 1e-5 (float32 sums in other
    orders); the msg_gt length guard of both."""
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_tpu.core.config import EfficientNetConfig
    from aqualora_tpu.eval import utils_eval as ju

    rng = np.random.default_rng(8)
    paths = [str(p) for p in runs["one_step"]["t"]["pngs"]]
    for i in range(12):
        p = str(tmp_path / f"x{i}.png")
        image_io.save_png(p, _smooth(rng, 40, 28, 3) if i % 2 else
                          rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
        paths.append(p)
    _skip_jax_eager_inits(monkeypatch, art)
    tres = tu.simple_decode(BITS, art["tdec"], paths, msg_gt=HIDINFO,
                            resolution=32, tpr_threshold=0.2,
                            backbone=tcfg.EfficientNetConfig.tiny(),
                            return_margins=True, device="cpu")
    jres = ju.simple_decode(BITS, art["jdec"], paths, msg_gt=HIDINFO,
                            resolution=32, tpr_threshold=0.2,
                            backbone=EfficientNetConfig.tiny(),
                            return_margins=True)
    assert tres[2] == jres[2] and len(tres[2]) == 18
    assert len(set(tres[2])) > 1
    assert tres[0] == jres[0] and tres[1] == jres[1]
    m = np.asarray(jres[3])
    assert tres[3].shape == m.shape == (18, BITS)
    np.testing.assert_allclose(tres[3], m,
                               atol=1e-4 * np.abs(m).max() + 1e-5)
    for mod, dec, bb in ((tu, art["tdec"], tcfg.EfficientNetConfig.tiny()),
                         (ju, art["jdec"], EfficientNetConfig.tiny())):
        with pytest.raises(ValueError, match="msg_gt has 3 bits"):
            mod.simple_decode(BITS, dec, paths[:1], msg_gt="101",
                              resolution=32, backbone=bb,
                              **({"device": "cpu"} if mod is tu else {}))


def test_simple_sample_per_image_messages_match_jax(art, tmp_path):
    """`messages` + `train_folder`: one message per image in one batch, the
    unfolded LoRA at run time with mapper(msg_i) * 1.03 as row i's
    diagonal, against JAX's on the same weights and latents, 3 prompts at
    batch 2 (the last chunk padded with the last message): images within
    IMAGE_TOL, PNGs within one level."""
    from aqualora_torch.diffusion import pipeline as tpl
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_tpu.eval import utils_eval as ju

    msgs = ["01" * 4, "1" * 8, "00011011"]
    prompts = ["a cat", "a dog", "an owl"]
    kw = dict(seeds=[3], num_inference_steps=3, batch_size=2,
              resolution=32, messages=msgs, train_folder=art["wm"])
    jrec = _Recorder(ju.images_to_pil)
    trec = _Recorder(tu.images_to_uint8)
    replay = _Replay(_jax_latents([3], 3, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ju, "images_to_pil", jrec)
        mp.setattr(tu, "images_to_uint8", trec)
        mp.setattr(tpl, "batch_randn", replay)
        jimgs = ju.simple_sample(None, "dpms_m", prompts,
                                 config=jcfg.PipelineConfig.tiny(),
                                 params=art["params"],
                                 output_dir=str(tmp_path / "j"), **kw)
        timgs = tu.simple_sample(None, "dpms_m", prompts,
                                 config=tcfg.PipelineConfig.tiny(),
                                 params=_torch_params(art["params"]),
                                 output_dir=str(tmp_path / "t"),
                                 device="cpu", **kw)
    assert replay.calls == 2
    # two calls of batch 2, the last row the padding (the last message)
    jf, tf = np.concatenate(jrec.seen), np.concatenate(trec.seen)
    assert tf.shape == jf.shape == (4, 32, 32, 3) and jf.std() > 0.1
    np.testing.assert_allclose(tf, jf, atol=IMAGE_TOL)
    assert len(timgs) == len(jimgs) == 3
    for a, b in zip(timgs, jimgs):
        assert np.abs(a.astype(np.int16) - np.asarray(b, np.int16)).max() <= 1
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["3_0.png", "3_1.png", "3_2.png"]
    with pytest.raises(ValueError, match="8-char bitstrings"):
        tu.simple_sample(None, "dpms_m", prompts[:1], messages=["0101"],
                         train_folder=art["wm"], device="cpu",
                         config=tcfg.PipelineConfig.tiny(), resolution=32)
    with pytest.raises(ValueError, match="unknown sampler"):
        tu.simple_sample(None, "ddpm", prompts, device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        tu.simple_sample(None, "dpms_m", prompts, int8=True, device="cpu")


def _port_sample(art, prompts, batch_size, **kw):
    """The port's simple_sample on the tiny weights, its own generators,
    -> (uint8 images, float images before quantization)."""
    from aqualora_torch.eval import utils_eval as tu

    rec = _Recorder(tu.images_to_uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tu, "images_to_uint8", rec)
        imgs = tu.simple_sample(None, "dpms_m", prompts, seeds=[7],
                                num_inference_steps=3, batch_size=batch_size,
                                resolution=32, device="cpu",
                                config=tcfg.PipelineConfig.tiny(),
                                params=_torch_params(art["params"]), **kw)
    real = [len(prompts[i:i + batch_size])
            for i in range(0, len(prompts), batch_size)]
    return np.stack(imgs), np.concatenate(
        [s[:n] for s, n in zip(rec.seen, real)])


def test_simple_sample_properties(art):
    """In the port alone, with its own per-image generators: the images of
    a prompt are the same at batch 1 and at batch 3 (the generators depend
    on (seed, index) alone), and each per-image message gives that
    message's folded-LoRA image (tests/test_fold.py: the diagonal commutes
    from the down weights to the activations).  Both readings are stated:
    float images within 1e-4 and uint8 within one level for the batch
    sizes (the same arithmetic on other batch shapes); within IMAGE_TOL
    and two levels for fold against run time (another order of sums)."""
    from aqualora_torch.tools.create_wm_lora import create_watermark_lora

    prompts = ["a cat", "a dog", "an owl"]
    msgs = ["01" * 4, "1" * 8, "00011011"]
    u1, f1 = _port_sample(art, prompts, 1, messages=msgs,
                          train_folder=art["wm"])
    u3, f3 = _port_sample(art, prompts, 3, messages=msgs,
                          train_folder=art["wm"])
    assert np.abs(f1 - f3).max() <= 1e-4
    assert np.abs(u1.astype(np.int16) - u3).max() <= 1
    assert np.abs(f1[0] - f1[1]).max() > 1e-2      # the images differ
    for i, m in enumerate(msgs):
        _, folded = create_watermark_lora(art["wm"], msg_bits=BITS,
                                          hidinfo=m, save=False)
        uf, ff = _port_sample(art, prompts, 3, lora=folded)
        assert np.abs(ff[i] - f3[i]).max() <= IMAGE_TOL, m
        assert np.abs(uf[i].astype(np.int16) - u3[i]).max() <= 2, m
        other = (i + 1) % 3
        assert np.abs(ff[other] - f3[other]).max() > IMAGE_TOL, m


def test_eval_modules_import_no_jax():
    """The eval slice's modules, the robustness and fidelity benchmarks'
    included, import neither jax nor aqualora_tpu, nor PIL, nor
    transformers."""
    mods = ["aqualora_torch.eval.run_eval_base",
            "aqualora_torch.eval.utils_eval", "aqualora_torch.eval.image_io",
            "aqualora_torch.eval.prompts",
            "aqualora_torch.eval.run_eval_distortion",
            "aqualora_torch.eval.distortions", "aqualora_torch.eval.jpeg",
            "aqualora_torch.diffusion.pipeline",
            "aqualora_torch.tools.create_wm_lora",
            "aqualora_torch.diffusion.samplers",
            "aqualora_torch.models.inception", "aqualora_torch.models.vit",
            "aqualora_torch.eval.fid", "aqualora_torch.eval.dreamsim",
            "aqualora_torch.eval.run_fid", "aqualora_torch.eval.run_dreamsim",
            "aqualora_torch.tools.torch_import",
            "aqualora_torch.utils.precision"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m in ('jax', 'PIL', "
              "'transformers') or m.startswith(('jax.', 'aqualora_tpu', "
              "'PIL.', 'transformers.'))]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
