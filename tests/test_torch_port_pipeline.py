"""The port's slice as a whole against the JAX package: config presets,
tokenizers, DDIM, the detection math, and tokenize -> CLIP -> fold ->
DDIM -> VAE decode -> SecretDecoder bits on the same weights and the same
initial latents.  Also: the port never imports JAX, and chip_smoke.py
refuses to run without a CUDA card."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)


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

PRESETS = {
    "clip_sd15": lambda c: c.CLIPTextConfig.sd15(),
    "clip_sd2": lambda c: c.CLIPTextConfig.sd2(),
    "clip_tiny_lora": lambda c: c.CLIPTextConfig.tiny().with_lora(4),
    "vae_sd15": lambda c: c.VAEConfig.sd15(),
    "vae_tiny": lambda c: c.VAEConfig.tiny(),
    "unet_sd15": lambda c: c.UNetConfig.sd15(320),
    "unet_sd21": lambda c: c.UNetConfig.sd21(320),
    "unet_tiny": lambda c: c.UNetConfig.tiny(),
    "watermark": lambda c: c.WatermarkConfig(),
    "watermark_tiny": lambda c: c.WatermarkConfig.tiny(),
    "effnet_b1": lambda c: c.EfficientNetConfig.b1(),
    "effnet_tiny": lambda c: c.EfficientNetConfig.tiny(),
    "schedule": lambda c: c.ScheduleConfig.sd15(),
    "pipeline_sd15": lambda c: c.PipelineConfig.sd15(320),
    "pipeline_sd21": lambda c: c.PipelineConfig.sd21(320),
    "pipeline_tiny": lambda c: c.PipelineConfig.tiny(),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_presets_equal(name):
    ours, theirs = PRESETS[name](tcfg), PRESETS[name](jcfg)
    assert type(ours).__name__ == type(theirs).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("downscale", "time_embed_dim", "attn_up_blocks",
                 "alpha_scale"):
        if hasattr(theirs, prop):
            assert getattr(ours, prop) == getattr(theirs, prop)


PROMPTS = ["a photograph of an astronaut riding a horse", "",
           "hello world hello", "Café  au lait, 2 cups!",
           "  spaced   out   prompt  ", "x" * 300]


def test_tokenizers_give_identical_ids(tmp_path):
    from aqualora_torch.core import tokenizer as ttok
    from aqualora_tpu.core import tokenizer as jtok

    np.testing.assert_array_equal(ttok.FallbackTokenizer()(PROMPTS),
                                  jtok.FallbackTokenizer()(PROMPTS))
    base = list(jtok.bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(base)}
    for c in base:
        vocab[c + "</w>"] = len(vocab)
    merges = ["h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l",
              "worl d</w>", "c a", "ca f"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vp.write_text(json.dumps(vocab))
    mp.write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    np.testing.assert_array_equal(
        ttok.CLIPTokenizer(str(vp), str(mp))(PROMPTS),
        jtok.CLIPTokenizer(str(vp), str(mp))(PROMPTS))


MU = 3.0


def _jax_denoise(schedule):
    """E[eps | x_t] for data ~ N(mu, 1) (the denoiser of the sampler
    goldens), written once per framework."""
    acp_table = schedule.alphas_cumprod
    n = acp_table.shape[0]

    def denoise(x, t):
        t_lo = jnp.clip(jnp.floor(t), 0, n - 1)
        t_hi = jnp.clip(t_lo + 1, 0, n - 1)
        frac = t - t_lo
        acp = ((1 - frac) * acp_table[t_lo.astype(jnp.int32)]
               + frac * acp_table[t_hi.astype(jnp.int32)])
        alpha, sig = jnp.sqrt(acp), jnp.sqrt(1 - acp)
        x0_mean = (MU * sig ** 2 + alpha * x) / (alpha ** 2 + sig ** 2)
        return (x - alpha * x0_mean) / sig
    return denoise


def _torch_denoise(schedule):
    acp_table = schedule.alphas_cumprod
    n = acp_table.shape[0]

    def denoise(x, t):
        t_lo = torch.clamp(torch.floor(t), 0, n - 1)
        t_hi = torch.clamp(t_lo + 1, 0, n - 1)
        frac = t - t_lo
        acp = ((1 - frac) * acp_table[t_lo.long()]
               + frac * acp_table[t_hi.long()])
        alpha, sig = torch.sqrt(acp), torch.sqrt(1 - acp)
        x0_mean = (MU * sig ** 2 + alpha * x) / (alpha ** 2 + sig ** 2)
        return (x - alpha * x0_mean) / sig
    return denoise


@pytest.mark.parametrize("steps", [8, 25])
def test_ddim_matches_jax_and_goldens(steps):
    """The same deterministic denoiser through both DDIMs, and the port
    against the committed sampler goldens (which the JAX sampler made)."""
    from aqualora_torch.diffusion.samplers import sample_ddim
    from aqualora_torch.diffusion.schedule import NoiseSchedule as TSched
    from aqualora_tpu.diffusion.samplers import sample
    from aqualora_tpu.diffusion.schedule import NoiseSchedule as JSched

    jsched, tsched = JSched.create(jcfg.ScheduleConfig()), TSched.create(
        tcfg.ScheduleConfig(), device="cpu")
    np.testing.assert_array_equal(tsched.alphas_cumprod.numpy(),
                                  np.asarray(jsched.alphas_cumprod))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(123), (8, 4)))
    ref = np.asarray(sample("ddim", jsched, _jax_denoise(jsched),
                            jnp.asarray(z), steps))
    ours = sample_ddim(tsched, _torch_denoise(tsched), torch.tensor(z),
                       steps).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "sampler_goldens.npz"))[f"ddim_{steps}"]
    np.testing.assert_allclose(ours, golden, atol=1e-5)


@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear",
                                           "squaredcos_cap_v2"])
def test_noise_schedule_matches_jax(beta_schedule):
    """Every NoiseSchedule operation, each prediction type and each
    inference grid spacing, against the JAX schedule."""
    from aqualora_torch.diffusion.schedule import NoiseSchedule as TSched
    from aqualora_tpu.diffusion.schedule import NoiseSchedule as JSched

    jsched = JSched.create(jcfg.ScheduleConfig(beta_schedule=beta_schedule))
    tsched = TSched.create(tcfg.ScheduleConfig(beta_schedule=beta_schedule),
                           device="cpu")
    np.testing.assert_array_equal(tsched.betas.numpy(),
                                  np.asarray(jsched.betas))
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
            for _ in range(2))
    t = np.array([1, 500, 999], np.int32)
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    ta, tb, tt = torch.from_numpy(a), torch.from_numpy(b), \
        torch.from_numpy(t).long()
    pairs = [(jsched.add_noise(ja, jb, jt), tsched.add_noise(ta, tb, tt)),
             (jsched.subtract_noise(ja, jb, jt),
              tsched.subtract_noise(ta, tb, tt)),
             (jsched.velocity_to_epsilon(ja, jb, jt),
              tsched.velocity_to_epsilon(ta, tb, tt)),
             (jsched.get_velocity(ja, jb, jt), tsched.get_velocity(ta, tb, tt)),
             (jsched.snr_coeff(jt), tsched.snr_coeff(tt))]
    for kind in ("epsilon", "v_prediction", "sample"):
        pairs += [(jsched.pred_original(ja, jb, jt, kind),
                   tsched.pred_original(ta, tb, tt, kind)),
                  (jsched.to_epsilon(ja, jb, jt, kind),
                   tsched.to_epsilon(ta, tb, tt, kind))]
    for ref, ours in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    for spacing in ("leading", "linspace_round", "linspace"):
        for n in (8, 25):
            np.testing.assert_array_equal(
                tsched.inference_timesteps(n, spacing),
                jsched.inference_timesteps(n, spacing))


def test_detection_math_equal():
    from aqualora_torch.eval import utils_eval as tev
    from aqualora_tpu.eval import utils_eval as jev

    for k in (8, 16, 48):
        for tau in range(k + 1):
            assert tev.calculate_fpr(tau, k) == jev.calculate_fpr(tau, k)
        for fpr in (1e-2, 1e-3, 1e-4, 1e-6):
            assert tev.get_threshold(k, fpr) == jev.get_threshold(k, fpr)


def test_score_bits_follows_the_reference_rule():
    """bit accuracy and TPR as the JAX simple_decode loop computes them:
    an image is detected when its accuracy reaches tau / k."""
    from aqualora_torch.eval.utils_eval import get_threshold, score_bits

    rng = np.random.default_rng(0)
    msg_gt = "".join(map(str, rng.integers(0, 2, 48)))
    gt = np.array([int(c) for c in msg_gt])
    flips = rng.random((64, 48)) < rng.uniform(0.0, 0.5, (64, 1))
    bits = np.where(flips, 1 - gt, gt)
    tau = get_threshold(48, 1e-3) / 48
    acc = [np.mean([a == b for a, b in zip("".join(map(str, r)), msg_gt)])
           for r in bits]
    tp = sum(a >= tau for a in acc)
    bitacc, tpr = score_bits(torch.from_numpy(bits), msg_gt)
    assert math.isclose(bitacc, float(np.mean(acc)), rel_tol=1e-6)
    assert tpr == tp / len(acc)
    assert 0 < tp < len(acc)


def _fill(shapes, seed):
    """Seeded random leaves for an eval_shape tree: norm scales 1, biases 0,
    BatchNorm stats away from 0 / 1, everything else N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        if name in ("mean", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tiny(c, prediction_type):
    cfg = c.PipelineConfig.tiny()
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, prediction_type=prediction_type))


@pytest.fixture(scope="module", params=["epsilon", "v_prediction"])
def slice_outputs(request):
    """The tiny slice through both packages: fold one message, 2 DDIM
    steps at CFG 7.5, VAE decode, SecretDecoder bits; for an epsilon- and
    a v-predicting U-Net (SD-1.5's and SD-2.1's kinds)."""
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder as TDec
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    from aqualora_tpu.models.watermark import SecretDecoder as JDec

    jpipe = JPipe(_tiny(jcfg, request.param))
    cfg = jpipe.config
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, 32, 32)), 1)
    jdec = JDec(cfg.watermark.msg_bits, jcfg.EfficientNetConfig.tiny())
    dvars = _fill(jax.eval_shape(lambda: jdec.init(
        KEY, jnp.zeros((1, 32, 32, 3)), False)), 2)

    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, cfg.watermark.msg_bits).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    # the initial latent JAX's generate draws from `key`, handed to the port
    z = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                     (2, 16, 16, 4)))

    folded = jpipe.fold_message(params, jnp.asarray(msg))
    gen = jpipe.make_generate(num_steps=2, sampler="ddim", height=32,
                              width=32)
    j_img = np.asarray(gen(folded, jnp.asarray(ids), jnp.asarray(neg), key,
                           7.5, None))
    j_logits = np.asarray(jax.jit(lambda v, x: jdec.apply(v, x, False))(
        dvars, jnp.asarray(j_img)))

    tpipe = TPipe(_tiny(tcfg, request.param), device="cpu")
    tpipe.load_jax_params(params)
    tdec = TDec(cfg.watermark.msg_bits, tcfg.EfficientNetConfig.tiny(),
                device="cpu")
    from aqualora_torch.core.convert import jax_params_to_torch
    tdec.load_state_dict(jax_params_to_torch(dvars["params"],
                                             dvars["batch_stats"]))
    tdec.eval()
    tpipe.fold_message(torch.from_numpy(msg))
    t_img = tpipe.make_generate(num_steps=2, sampler="ddim", height=32,
                                width=32)(ids, neg, 7.5,
                                          z=torch.tensor(z))
    t_bits, t_margins = decode_bits(tdec, t_img)
    # decode_latents alone, on the initial latent
    j_dec = np.asarray(jpipe.decode_latents(params, jnp.asarray(z)))
    t_dec = tpipe.decode_latents(torch.tensor(z)).numpy()
    return (j_img, j_logits, t_img.numpy(), t_bits.numpy(), t_margins.numpy(),
            j_dec, t_dec)


def test_tiny_slice_images_match_jax(slice_outputs):
    j_img, _, t_img, _, _, _, _ = slice_outputs
    assert t_img.shape == j_img.shape == (2, 32, 32, 3)
    assert np.isfinite(t_img).all() and np.abs(t_img).max() <= 1.0
    assert j_img.std() > 0.1          # not a degenerate all-equal image
    np.testing.assert_allclose(t_img, j_img, atol=2e-3)


def test_tiny_slice_bits_match_jax(slice_outputs):
    _, j_logits, _, t_bits, t_margins, _, _ = slice_outputs
    j_margins = j_logits[..., 1] - j_logits[..., 0]
    np.testing.assert_array_equal(t_bits, np.argmax(j_logits, axis=-1))
    np.testing.assert_allclose(t_margins, j_margins, atol=1e-4)
    assert 0 < t_bits.sum() < t_bits.size   # both bit values occur


def test_decode_latents_matches_jax(slice_outputs):
    *_, j_dec, t_dec = slice_outputs
    assert t_dec.shape == j_dec.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(t_dec, j_dec, atol=1e-4)


def test_port_never_imports_jax():
    """Every module of aqualora_torch imports, and the tiny slice and one
    tiny PPFT step run, with no jax, flax or aqualora_tpu module loaded."""
    code = """
import importlib, pkgutil, sys
import numpy as np, torch
import aqualora_torch
for m in pkgutil.walk_packages(aqualora_torch.__path__, "aqualora_torch."):
    importlib.import_module(m.name)
from aqualora_torch.core.config import PipelineConfig, EfficientNetConfig
from aqualora_torch.core.tokenizer import FallbackTokenizer
from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                               init_module_weights)
from aqualora_torch.eval.utils_eval import decode_bits
from aqualora_torch.models.watermark import SecretDecoder
cfg = PipelineConfig.tiny()
pipe = StableDiffusionPipeline(cfg, device="cpu")
pipe.init_params(0)
pipe.fold_message(torch.ones(cfg.watermark.msg_bits))
tok = FallbackTokenizer(cfg.clip.vocab_size)
img = pipe.make_generate(2, "ddim", 32, 32)(
    tok(["a red fox", "a lighthouse"]), tok(["", ""]),
    generator=torch.Generator().manual_seed(0))
dec = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.tiny(),
                    device="cpu").eval()
init_module_weights(dec, torch.Generator().manual_seed(1))
bits, _ = decode_bits(dec, img)
assert img.shape == (2, 32, 32, 3) and bits.shape == (2, 8)
from aqualora_torch.train import ppft_train
res = ppft_train.run(ppft_train.build_argparser().parse_args(
    ["--tiny", "--max_train_steps", "1", "--train_batch_size", "2",
     "--device", "cpu"]))
assert len(res["history"]) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "aqualora_tpu"))
assert not bad, bad
print("PORT_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT_OK" in proc.stdout


def test_chip_smoke_fails_without_cuda():
    """On a host with no CUDA card the chip check must fail and must not
    print its success line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
