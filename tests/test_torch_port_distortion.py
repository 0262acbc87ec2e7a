"""The port's robustness benchmark against Pillow and the JAX package, on the
CPU at the tiny config.

- `aqualora_torch/eval/jpeg.py`, libjpeg's round trip written in integer
  torch ops, against Pillow's JPEG save and open bit for bit (noise,
  gradients and a generated image; 512^2, 32^2, 37x45 and 33x17; qualities
  50, 10 and 95) and against the JAX package's `jpeg_compress`.
- Each of the seven distortions of `eval/distortions.py` against JAX's
  `distortion_unit` with JAX's draws replayed.
- `run_eval_distortion --tiny --with_sdedit --with_sdedit2` against JAX's
  runner on the same artifacts and base checkpoints, with JAX's latents and
  draws replayed; the refusals.

`make_img2img` itself is held in `tests/test_torch_port_img2img.py`.  The
JAX side runs jitted on the CPU.  Tolerances: one 8-bit level for the
distortions, whose last step rounds floats that the two packages compute in
other orders, and for the PNGs.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.eval import distortions as tdist
from aqualora_torch.eval import image_io
from aqualora_torch.eval.jpeg import jpeg_roundtrip
from test_torch_port_eval import (KEY, _fill, _jax_latents, _Replay,
                                  _run_main, _skip_jax_eager_inits,
                                  _write_diffusers_dir, art)  # noqa: F401

SEVEN = ("color_jitter", "crop", "blur", "noise", "jpeg_compress",
         "rotation", "sharpness")
TINY_VOCAB = jcfg.CLIPTextConfig.tiny().vocab_size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pillow_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    with Image.open(buf) as im:
        return np.asarray(im.convert("RGB"))


def _gradient(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    return np.stack([(np.sin(6 * yy + c) * 0.5 + 0.5) * (0.7 * xx + 0.3)
                     * 255 for c in range(3)], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def generated():
    """One 32^2 image of the port's tiny pipeline (seeded weights, DDIM 4
    steps), uint8."""
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.eval.image_io import images_to_uint8

    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.init_params(3)
    tok = load_tokenizer(None, vocab_size=TINY_VOCAB)
    img = pipe.make_generate(4, "ddim", 32, 32)(
        tok(["a lighthouse"]), tok([""]),
        generator=torch.Generator().manual_seed(3))
    out = images_to_uint8(img)[0]
    assert out.std() > 10
    return out


def _jpeg_inputs(generated, h, w, seed):
    """Noise, a gradient and the generated image (mirrored out to h x w)."""
    rng = np.random.default_rng(seed)
    gen = np.pad(generated, ((0, max(0, h - 32)), (0, max(0, w - 32)),
                             (0, 0)), mode="symmetric")[:h, :w]
    return np.stack([rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                     _gradient(h, w), gen])


# ---------------------------------------------------------------------------
# (a) JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 10, 95])
@pytest.mark.parametrize("h,w", [(512, 512), (32, 32), (37, 45), (33, 17)])
def test_jpeg_roundtrip_matches_pillow(generated, h, w, quality):
    """The round trip equals Pillow's save(format="JPEG", quality=q) then
    open, bit for bit, at sizes that are and are not multiples of the
    16-pixel MCU (the chroma's ceil(w/2) columns, the crop)."""
    images = _jpeg_inputs(generated, h, w, seed=h + w + quality)
    got = jpeg_roundtrip(torch.from_numpy(images), quality)
    assert got.dtype == torch.uint8 and got.shape == images.shape
    want = np.stack([_pillow_roundtrip(im, quality) for im in images])
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want.astype(int) - images).max() > 0     # it is lossy


def test_jpeg_compress_matches_jax(generated):
    """The protocol's `jpeg_compress` on [0, 1] images equals the JAX
    package's (libjpeg through ctypes, else Pillow) at 32^2 and 37x45,
    the truncation to 8 bits included; non-uint8 input is refused, as the
    JAX binding refuses it."""
    from aqualora_tpu.core import native_loader
    from aqualora_tpu.eval import distortions as jd

    for h, w in ((32, 32), (37, 45)):
        u8 = _jpeg_inputs(generated, h, w, seed=5)
        x01 = u8.astype(np.float32) / 255.0
        want = jd.jpeg_compress(x01, None)
        got = tdist.jpeg_compress(torch.from_numpy(x01).permute(0, 3, 1, 2),
                                  {}).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    for bad in (torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 3,
                                                      dtype=torch.int32)):
        with pytest.raises(ValueError, match="uint8"):
            jpeg_roundtrip(bad)
    with pytest.raises(ValueError, match="uint8"):
        native_loader.jpeg_roundtrip_batch(np.zeros((1, 8, 8, 3)), 50)
    with pytest.raises(ValueError, match=r"\[N, H, W, 3\]"):
        jpeg_roundtrip(torch.zeros(8, 8, 3, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# img2img: JAX's programs, shared with tests/test_torch_port_img2img.py
# ---------------------------------------------------------------------------

def _configs(pred: str):
    """The tiny pipeline config of both packages with `pred` prediction."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.PipelineConfig.tiny()
        out.append(dataclasses.replace(
            c, unet=dataclasses.replace(c.unet, prediction_type=pred),
            schedule=dataclasses.replace(c.schedule, prediction_type=pred)))
    return out


@pytest.fixture(scope="module")
def jax_img2img():
    """JAX's jitted img2img of the tiny pipeline, one compile per
    (prediction type, steps, strength) for the module."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline

    cache, make = {}, StableDiffusionPipeline.make_img2img

    def get(pred, steps, strength):
        key = (pred, steps, strength)
        if key not in cache:
            cache[key] = make(StableDiffusionPipeline(_configs(pred)[0]),
                              steps, strength, 32, 32)
        return cache[key]
    return get


def _img2img_draws(key, b, latent=(16, 16, 4)):
    """The posterior and forward-process draws of one JAX img2img call
    (`kvae, knoise = split(key)`), NHWC."""
    kvae, knoise = jax.random.split(key)
    return {"posterior_noise": torch.from_numpy(np.array(jax.random.normal(
                kvae, (b,) + latent, jnp.float32))),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                knoise, (b,) + latent, jnp.float32)))}


# ---------------------------------------------------------------------------
# (c) the seven distortions
# ---------------------------------------------------------------------------

def _jax_draws(kind: str, key, shape) -> dict:
    """The numbers JAX's `distortion_unit(x01, kind, key)` draws for
    [B, H, W, C] images, as the port's params (NCHW where they are
    images)."""
    b = shape[0]
    t = lambda a: torch.from_numpy(np.array(a))
    if kind == "color_jitter":
        ks = jax.random.split(key, 4)
        rng = {"brightness": (0.9, 1.1), "contrast": (0.9, 1.1),
               "saturation": (0.9, 1.1), "hue": (-0.1, 0.1)}
        return {name: t(jax.random.uniform(k, (b, 1, 1, 1), minval=lo,
                                           maxval=hi)).reshape(b)
                for k, (name, (lo, hi)) in zip(ks, rng.items())}
    if kind == "crop":
        ky, kx = jax.random.split(key)
        return {"ty": t(jax.random.randint(ky, (b,), 0, 512 - 460 + 1)),
                "tx": t(jax.random.randint(kx, (b,), 0, 512 - 460 + 1))}
    if kind == "blur":
        return {"sigma": t(jax.random.uniform(key, (b,), minval=4.0 - 1e-6,
                                              maxval=4.0))}
    if kind == "noise":
        _, k2 = jax.random.split(key)
        return {"noise": t(jax.random.normal(k2, shape, jnp.float32))
                .permute(0, 3, 1, 2)}
    if kind == "sharpness":
        return {"factor": t(jax.random.uniform(key, (b, 1, 1, 1),
                                               maxval=10.0)).reshape(b)}
    return {}


def _levels_apart(got: np.ndarray, want: np.ndarray) -> tuple:
    d = np.abs(got.astype(np.float64) - want) * 255
    return d.max(), float(np.mean(d > 0.5))


@pytest.mark.parametrize("kind", SEVEN)
def test_distortion_matches_jax(generated, kind):
    """Each protocol distortion on the same [0, 1] images (8-bit levels, as
    read from PNGs) with JAX's draws: at most one level apart anywhere and
    at most 0.1% of the values differing (the two packages round floats
    computed in other orders); jpeg_compress and rotation equal."""
    from aqualora_tpu.eval import distortions as jd

    rng = np.random.default_rng(7)
    # three images, as the runner's: JAX's eager ops then compile once
    u8 = np.stack([generated, _gradient(32, 32),
                   rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)])
    x01 = u8.astype(np.float32) / 255.0
    key = jax.random.PRNGKey(SEVEN.index(kind) + 20)
    want = np.asarray(jd.distortion_unit(x01, kind, key), np.float32)
    got = tdist.apply(kind, torch.from_numpy(x01).permute(0, 3, 1, 2),
                      _jax_draws(kind, key, x01.shape))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert got.shape[1:3] == ((460, 460) if kind == "crop" else (32, 32))
    if kind != "crop":
        assert np.abs(want - x01).max() > 0
    apart, share = _levels_apart(got, want)
    if kind in ("jpeg_compress", "rotation"):
        np.testing.assert_array_equal(got, want)
    assert apart <= 1.0 + 1e-3 and share <= 1e-3, (apart, share)


# ---------------------------------------------------------------------------
# (d) the runner
# ---------------------------------------------------------------------------

RUNNER = ["--num_prompts", "3", "--batch_size", "2", "--fpr", "1e-2",
          "--tiny", "--with_sdedit", "--with_sdedit2"]
KINDS = SEVEN + ("SDEdit", "SDEdit2")


def _runner_draws(shape, n_chunks, bs, latent=(16, 16, 4)):
    """JAX's runner draws, kind by kind from PRNGKey(0): `key, sub =
    split(key)` a kind; an SDEdit attack splits `sub` once a chunk and
    hands the chunk's key to img2img."""
    key, out = jax.random.PRNGKey(0), {}
    for kind in KINDS:
        key, sub = jax.random.split(key)
        if kind.startswith("SDEdit"):
            chunks = []
            for _ in range(n_chunks):
                sub, k = jax.random.split(sub)
                chunks.append(_img2img_draws(k, bs, latent))
            out[kind] = chunks
        else:
            out[kind] = _jax_draws(kind, sub, shape)
    return out


class _Recorder:
    def __init__(self, fn):
        self.fn, self.results = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.results.append(out[:2])
        return out


@pytest.fixture(scope="module")
def dist_runs(art, jax_img2img, tmp_path_factory):
    """`run_eval_distortion` in both packages on the same base checkpoints
    (SD-1.5's and, for SDEdit2, a second seeded one), the same artifact
    folder and the same draws: the port gets JAX's initial latents and
    JAX's draws of every distortion and attack.  Each stage is held on
    equal inputs: after the port's clean set is written (and kept for its
    own comparison), JAX's clean PNGs take its place, so both runners
    distort the same pixels.  JAX's runner loads its decoder once and
    compiles its decode once for its nine `simple_decode` calls (the same
    program each time)."""
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion import pipeline as tpl
    from aqualora_torch.eval import run_eval_distortion as tr
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_tpu.core import tokenizer as jtok
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.eval import run_eval_distortion as jr
    from aqualora_tpu.eval import utils_eval as ju

    root = tmp_path_factory.mktemp("dist_runs")
    sd2 = str(root / "sd2")
    _write_diffusers_dir(sd2, jax.tree_util.tree_map(np.asarray, _fill(
        jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                              a.dtype),
                               art["params"]), 9)))
    common = RUNNER + ["--model_path", art["sd"], "--sd2_model_path", sd2,
                      "--train_folder", art["wm"]]

    def cached_img2img(self, num_steps=10, strength=0.1, height=512,
                       width=512, jit=True):
        assert self.config == jcfg.PipelineConfig.tiny() and jit
        return jax_img2img("epsilon", num_steps, strength)

    jdec = _Recorder(ju.simple_decode)
    real_jit, decoders, programs = jax.jit, {}, {}

    def load_once(path, bitnum, backbone=None):
        if (path, bitnum) not in decoders:
            decoders[path, bitnum] = skip_init_load(path, bitnum, backbone)
        return decoders[path, bitnum]

    def jit_once(fn=None, **kw):
        # `simple_decode` jits a closure over the decoder module at each
        # call; with the module loaded once, one compile serves all nine
        if fn is None:
            return lambda f: jit_once(f, **kw)
        if (getattr(fn, "__module__", None), getattr(fn, "__name__", None)
                ) != (ju.__name__, "decode"):
            return real_jit(fn, **kw)
        key = tuple(id(c.cell_contents) for c in fn.__closure__)
        if key not in programs:
            programs[key] = real_jit(fn, **kw)
        return programs[key]

    with pytest.MonkeyPatch.context() as mp:
        _skip_jax_eager_inits(mp, art)
        skip_init_load = ju.load_msgdecoder
        mp.setattr(ju, "load_msgdecoder", load_once)
        mp.setattr(jax, "jit", jit_once)
        # the attacks' fast_init_params: every value it makes but the
        # unused LoRA and mapper is replaced by the --model_path checkpoints
        mp.setattr(StableDiffusionPipeline, "fast_init_params",
                   lambda self, *a, **k: jax.tree_util.tree_map(
                       np.array, art["params"]))
        mp.setattr(StableDiffusionPipeline, "make_img2img", cached_img2img)
        # JAX's runner tokenizes the attack prompts with the full CLIP
        # vocabulary; at the tiny config (1000 tokens) its embedding then
        # reads out of range, and flax returns NaN there
        mp.setattr(jtok, "load_tokenizer",
                   lambda *a, **k: FallbackTokenizer(TINY_VOCAB))
        mp.setattr(ju, "simple_decode", jdec)
        _run_main(jr, common + ["--msgdecoder_path", art["jdec"],
                                "--output_dir", str(root / "j")])

    draws = _runner_draws((3, 32, 32, 3), n_chunks=2, bs=2)
    queue = {k: list(v) if isinstance(v, list) else [v]
             for k, v in draws.items()}
    seen = []

    def replay_draw(kind, gen, shape):
        seen.append(kind)
        return queue[kind].pop(0)

    def replay_attack(self, gen, b):
        kind = "SDEdit" if self.strength == 0.1 else "SDEdit2"
        seen.append(kind)
        return queue[kind].pop(0)

    real_sample = tu.simple_sample

    def sample_then_take_jax_pngs(*a, **k):
        out = real_sample(*a, **k)
        shutil.copytree(k["output_dir"], root / "t_clean")
        for name in os.listdir(k["output_dir"]):
            shutil.copy(root / "j" / "clean" / name,
                        os.path.join(k["output_dir"], name))
        return out

    replay = _Replay(_jax_latents([0], 3, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpl, "batch_randn", replay)
        mp.setattr(tdist, "draw", replay_draw)
        mp.setattr(tdist.SDEditAttack, "draw", replay_attack)
        mp.setattr(tu, "simple_sample", sample_then_take_jax_pngs)
        tres = tr.main(common + ["--msgdecoder_path", art["tdec"],
                                 "--device", "cpu",
                                 "--output_dir", str(root / "t")])
    assert replay.calls == 2
    assert all(not q for q in queue.values()), queue
    assert seen == list(SEVEN) + ["SDEdit"] * 2 + ["SDEdit2"] * 2
    return {"root": root, "t": tres,
            "j": dict(zip(KINDS, jdec.results, strict=True))}


@pytest.mark.parametrize("kind", ("clean",) + KINDS)
def test_run_eval_distortion_tiny_matches_jax(dist_runs, kind):
    """Each kind's directory holds JAX's PNG names, its PNGs within one
    level of JAX's, and its bit accuracy and TPR equal JAX's (the clean
    set: the port's own generation against JAX's)."""
    from PIL import Image

    root = dist_runs["root"]
    tdir = root / ("t_clean" if kind == "clean" else f"t/{kind}")
    jdir = root / "j" / kind
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == ["0_0.png", "0_1.png",
                                                  "0_2.png"]
    for name in names:
        a = image_io.load_png(str(tdir / name)).astype(np.int16)
        with Image.open(jdir / name) as im:
            b = np.asarray(im.convert("RGB")).astype(np.int16)
        assert a.shape == b.shape and b.std() > 1.0, name
        assert np.abs(a - b).max() <= 1, (kind, name)
    if kind != "clean":
        assert dist_runs["t"][kind] == dist_runs["j"][kind]
        assert 0.0 <= dist_runs["t"][kind][0] <= 1.0


def test_run_eval_distortion_refusals(art, tmp_path):
    """--lora without --msg_gt and an unknown distortion all exit before
    anything is generated; a non-square --height/--width is refused;
    --device defaults to cuda.  The units refuse an unknown kind and an
    SDEdit attack without a pipeline, with JAX's messages.  Bare --int8
    runs: the clean set generated with int8 convs (the plain path on the
    CPU), then the distortions."""
    from aqualora_torch.eval import run_eval_distortion as tr
    from aqualora_tpu.eval import distortions as jd

    out = tmp_path / "out"
    base = ["--msgdecoder_path", art["tdec"], "--device", "cpu", "--tiny",
            "--output_dir", str(out)]
    for argv, err, match in (
            (["--lora", str(art["wm"]) + "/pytorch_lora_weights.safetensors"],
             SystemExit, "msg_gt"),
            (["--train_folder", art["wm"], "--distortions", "blur,warp"],
             ValueError, "unknown distortion warp"),
            (["--train_folder", art["wm"], "--height", "64", "--width",
              "32"], SystemExit, "non-square")):
        with pytest.raises(err, match=match):
            tr.main(base + argv)
    assert not out.exists()
    assert tr.build_argparser().parse_args(
        ["--msgdecoder_path", "d"]).device == "cuda"
    out8 = tmp_path / "int8"
    res = tr.main(base[:-1] + [str(out8), "--train_folder", art["wm"],
                               "--int8", "--num_prompts", "2",
                               "--batch_size", "2", "--distortions", "blur"])
    assert set(res) == {"blur"}
    assert len(os.listdir(out8 / "clean")) == 2
    x = torch.zeros(1, 3, 8, 8)
    for kind, match in (("warp", "unknown distortion warp"),
                        ("SDEdit", "SDEdit attack requires a pipeline"),
                        ("SDEdit2", "SDEdit2 attack requires a pipeline")):
        with pytest.raises(ValueError, match=match):
            tdist.distortion_unit(x, kind, torch.Generator())
        with pytest.raises(ValueError, match=match):
            jd.distortion_unit(np.zeros((1, 8, 8, 3), np.float32), kind, KEY)
