"""The port's stage 1 (latent watermark pretraining) against the JAX package,
float32 on the CPU.

Each port module is held against its JAX counterpart on the same seeded
numpy inputs and the same random numbers: the JAX functions draw theirs
from keys, and these tests draw the same numbers by repeating the JAX
package's key splits, then hand them to the port, whose functions take
them as arguments.  The JAX side runs jitted on the CPU, its Pallas
backward in interpret mode.  The card's kernels are held against the
port's plain versions by tests/test_torch_port_cuda.py and chip_smoke.py.

The whole-step comparison runs the tiny configuration with the decoder's
dropout at 0 (a `dataclasses.replace` of the tiny EfficientNet config):
flax draws the dropout and stochastic-depth masks inside the module, where
these tests cannot repeat them, and the tiny decoder has no block with a
stochastic-depth probability above 0.  The masks are tested on their own.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
LR = 1e-3
STEPS_PER_EPOCH = 3
NAMES = ("identity", "jpeg", "crop", "blur", "noise", "jitter")


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


@contextlib.contextmanager
def _interpret_pallas():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp_call
    try:
        yield
    finally:
        pl.pallas_call = orig


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _fill(shapes, seed):
    """Seeded random leaves for an eval_shape tree: norm scales 1, biases 0,
    everything else N(0, 1/fan_in)."""
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


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _layer_params(name, key, shape, crop_range=(256, 512)):
    """The port's numbers for distortion `name` on NHWC `shape`, drawn as
    the JAX package's layer draws them from `key` (`distort/noises.py`,
    `distort/noiser.py`)."""
    b, h, w, _ = shape
    u = jax.random.uniform
    if name in ("identity", "jpeg"):
        return {}
    if name == "crop":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        lo_h, lo_w = min(crop_range[0], h), min(crop_range[0], w)
        ch = u(k1, (b,), minval=lo_h,
               maxval=max(min(crop_range[1], h), lo_h + 1e-6))
        cw = u(k2, (b,), minval=lo_w,
               maxval=max(min(crop_range[1], w), lo_w + 1e-6))
        return {"ch": _t(ch), "cw": _t(cw), "ty": _t(u(k3, (b,)) * (h - ch)),
                "tx": _t(u(k4, (b,)) * (w - cw))}
    if name == "blur":
        return {"sigma": _t(u(key, (b,), minval=1e-3, maxval=10.0))}
    if name == "noise":
        k1, k2 = jax.random.split(key)
        return {"std": _t(u(k1, (b, 1, 1, 1), maxval=0.2)).reshape(b),
                "noise": _nchw(jax.random.normal(k2, shape, jnp.float32))}
    if name == "jitter":
        kb, kc, ks, kh = jax.random.split(key, 4)
        return {n: _t(u(k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)
                for n, k, lo, hi in (("brightness", kb, 0.7, 1.3),
                                     ("contrast", kc, 0.8, 1.25),
                                     ("saturation", ks, 0.8, 1.25),
                                     ("hue", kh, -0.2, 0.2))}
    if name == "rotation":
        return {"angle": _t(u(key, (b,), minval=-180.0, maxval=180.0))}
    if name == "sharpness":
        ks, kf = jax.random.split(key)
        s = u(ks, ())
        return {"factor": _t(u(kf, (b, 1, 1, 1), maxval=s)).reshape(b)}
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the kernel math at d = 512
# ---------------------------------------------------------------------------

def test_bwd_plain_matches_pallas_interpret_d512():
    """The port's plain dQ and dK/dV at the VAE mid-block's head dim (d =
    512, T = 128) against the Pallas backward kernels in interpret mode,
    atol 1e-4 as tests/test_ops.py holds them."""
    import aqualora_tpu.ops.flash_attention as F
    from aqualora_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((1, 1, 128, 512), dtype=np.float32)
                  for _ in range(4))
    scale = 512 ** -0.5
    with _interpret_pallas():
        _, res = F._fa_fwd(*map(jnp.asarray, (q, k, v)), scale)
        ref = F._fa_bwd(scale, res, jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_plain(tq, tk, tv, scale)
    delta = fa.attention_delta(o, tg)
    got = (fa.flash_attention_dq_plain(tq, tk, tv, tg, lse, delta, scale),
           *fa.flash_attention_dkv_plain(tq, tk, tv, tg, lse, delta, scale))
    for want, p in zip(ref, got):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), atol=1e-4)


def test_bwd_wrapper_takes_d512_on_cpu():
    """`flash_attention_bwd` takes d = 512 (the plain path on a CPU
    tensor, no launch counted) and autograd through `flash_attention`
    reaches it."""
    from aqualora_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(1, 1, 40, 512, requires_grad=True)
               for _ in range(3))
    counts = (fa.dq_launches.count, fa.dkv_launches.count)
    fa.flash_attention(q, k, v, 512 ** -0.5).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
    assert (fa.dq_launches.count, fa.dkv_launches.count) == counts


# ---------------------------------------------------------------------------
# losses, distortions, augmentations
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    """PRVL (an (H+1) x (W+1) box map with the padded zeros in each mean,
    the max over the batch), message BCE and bit accuracy, rtol 1e-6."""
    from aqualora_torch.train import losses as tl
    from aqualora_tpu.train import losses as jl

    a, b = _images(1, (2, 40, 36, 3)), _images(2, (2, 40, 36, 3))
    np.testing.assert_allclose(
        tl.prvl_loss(_nchw(a), _nchw(b)).item(),
        float(jl.prvl_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 8, 2)).astype(np.float32)
    msg = (rng.random((3, 8)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tl.message_bce(_t(logits), _t(msg)).item(),
        float(jl.message_bce(jnp.asarray(logits), jnp.asarray(msg))),
        rtol=1e-6)
    assert tl.bit_accuracy(_t(logits), _t(msg)).item() == float(
        jl.bit_accuracy(jnp.asarray(logits), jnp.asarray(msg)))


def test_jpeg_matches_jax():
    """The block-DCT JPEG with the (25, 9, 9) zig-zag mask on a size that
    is not a multiple of 8, atol 1e-5."""
    from aqualora_torch.distort.jpeg import jpeg_compress
    from aqualora_tpu.distort.jpeg import jpeg_compress as jax_jpeg

    x = _images(4, (2, 30, 21, 3))
    np.testing.assert_allclose(_nhwc(jpeg_compress(_nchw(x))),
                               np.asarray(jax_jpeg(jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["rotation", "crop", "blur", "noise",
                                  "jitter", "sharpness"])
def test_distortion_matches_jax(name):
    """Each distortion of `distort/noises.py` with the JAX draws handed to
    it, atol 2e-5 (bilinear resampling and float32 sums in other
    orders)."""
    from aqualora_torch.distort import noises as tn
    from aqualora_tpu.distort import noises as jn

    shape = (2, 32, 28, 3)
    x = _images(5, shape)
    key = jax.random.PRNGKey(11)
    p = _layer_params(name, key, shape, crop_range=(16, 28))
    xt, xj = _nchw(x), jnp.asarray(x)
    got, want = {
        "rotation": lambda: (tn.rotate(xt, p["angle"]),
                             jax.jit(jn.rotate, static_argnums=2)(
                                 key, xj, 180.0)),
        "crop": lambda: (tn.crop_and_resize(xt, p["ch"], p["cw"], p["ty"],
                                            p["tx"], 24),
                         jax.jit(jn.crop_and_resize, static_argnums=(2, 3))(
                             key, xj, (16, 28), 24)),
        "blur": lambda: (tn.gaussian_blur(xt, p["sigma"]),
                         jn.gaussian_blur(key, xj, sigma_max=10.0)),
        "noise": lambda: (tn.gaussian_noise(xt, p["std"], p["noise"]),
                          jn.gaussian_noise(key, xj, std_max=0.2)),
        "jitter": lambda: (tn.color_jitter(xt, p["brightness"],
                                           p["contrast"], p["saturation"],
                                           p["hue"]),
                           jn.color_jitter(key, xj)),
        # the Noiser's nested draw: the factor's bound is itself uniform
        "sharpness": lambda: (tn.sharpness(xt, p["factor"]), jn.sharpness(
            jax.random.split(key)[1], xj, strength_max=jax.random.uniform(
                jax.random.split(key)[0], ()))),
    }[name]()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)


@pytest.fixture(scope="module")
def jax_noiser():
    """The JAX stage-1 Noiser, jitted once for the six layers: the layer
    probabilities are a traced argument, so one trace serves them all."""
    from aqualora_tpu.distort.noiser import Noiser as JaxNoiser
    return jax.jit(JaxNoiser())


@pytest.mark.parametrize("index", range(6))
def test_noiser_layer_matches_jax(index, jax_noiser):
    """The stage-1 Noiser with one layer's probability at 1: the layer the
    JAX Noiser picks with `jax.random.choice`, applied with its draws
    from the layer key, at 64 px (the crop range clamps to the image)."""
    from aqualora_torch.distort.noiser import STAGE1_LAYERS, Noiser, NoiseDraw

    assert STAGE1_LAYERS == NAMES
    shape = (2, 64, 64, 3)
    x = _images(6 + index, shape)
    probs = np.eye(6, dtype=np.float32)[index]
    key = jax.random.PRNGKey(20 + index)
    want = jax_noiser(key, jnp.asarray(x), jnp.asarray(probs))
    kc, ka = jax.random.split(key)
    picked = int(jax.random.choice(kc, 6, p=jnp.asarray(probs)))
    assert picked == index
    got = Noiser()(_nchw(x), NoiseDraw(picked, _layer_params(
        NAMES[picked], ka, shape)))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)


def test_noiser_draw_follows_probs():
    """`Noiser.draw` picks each layer at its probability (5000 draws,
    within 0.03) and never a layer of probability 0."""
    from aqualora_torch.distort.noiser import Noiser

    probs = (0.4, 0.1, 0.2, 0.05, 0.1, 0.15)
    gen = torch.Generator().manual_seed(0)
    noiser = Noiser()
    picks = np.bincount([noiser.draw(gen, (1, 3, 8, 8), probs).index
                         for _ in range(5000)], minlength=6) / 5000
    np.testing.assert_allclose(picks, probs, atol=0.03)
    zero = (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    assert {noiser.draw(gen, (1, 3, 8, 8), zero).index
            for _ in range(50)} == {2}


@pytest.mark.parametrize("seed", range(4))
def test_cornerfy_and_base_augment_match_jax(seed):
    """`maybe_cornerfy` on a watermark latent and `base_augment` on
    images with the JAX draws (flag, scales; apply, flip, quarter turns):
    the resampled latent within 1e-5 (four-term float32 bilinear sums,
    fused otherwise by XLA), the flipped and turned images exactly."""
    from aqualora_torch.train import augment as ta
    from aqualora_tpu.train import augment as ja

    key = jax.random.PRNGKey(30 + seed)
    lat = np.random.default_rng(seed).standard_normal(
        (2, 16, 12, 4)).astype(np.float32)
    kp, ka = jax.random.split(key)
    kh, kw = jax.random.split(ka)
    do = bool(jax.random.bernoulli(kp, 0.25)) or seed == 0
    hs = float(jax.random.uniform(kh, (), minval=1.0, maxval=2.0))
    ws = float(jax.random.uniform(kw, (), minval=1.0, maxval=2.0))
    want = (jax.jit(ja.cornerfy)(ka, jnp.asarray(lat)) if do
            else jax.jit(ja.maybe_cornerfy)(key, jnp.asarray(lat)))
    got = ta.maybe_cornerfy(_nchw(lat), do, hs, ws)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)

    img = _images(40 + seed, (2, 16, 16, 3))
    kp, kf, kr = jax.random.split(key, 3)
    got = ta.base_augment(_nchw(img), bool(jax.random.bernoulli(kp)),
                          bool(jax.random.bernoulli(kf)),
                          int(jax.random.randint(kr, (), 0, 4)))
    np.testing.assert_array_equal(
        _nhwc(got), np.asarray(jax.jit(ja.base_augment)(key,
                                                        jnp.asarray(img))))


def test_augment_draws_cover_both_branches():
    """The seeds of test_cornerfy_and_base_augment_match_jax reach
    base_augment's flip and no-flip, apply and no-apply."""
    applies, flips = set(), set()
    for seed in range(4):
        kp, kf, _ = jax.random.split(jax.random.PRNGKey(30 + seed), 3)
        applies.add(bool(jax.random.bernoulli(kp)))
        flips.add(bool(jax.random.bernoulli(kf)))
    assert applies == {True, False} and flips == {True, False}


# ---------------------------------------------------------------------------
# LPIPS and the EfficientNet in train mode
# ---------------------------------------------------------------------------

def test_lpips_matches_jax():
    """LPIPS-VGG16 with seeded random weights through `jax_params_to_torch`
    (the lpips layout), on [-1, 1] images at 32 px, rtol 1e-5."""
    from aqualora_torch.models.lpips import LPIPS
    from aqualora_tpu.models.lpips import LPIPS as JaxLPIPS

    a, b = _images(7, (2, 32, 32, 3)), _images(8, (2, 32, 32, 3))
    jm = JaxLPIPS()
    params = _fill(jax.eval_shape(lambda: jm.init(
        KEY, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3)))), 3
    )["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(a),
                             jnp.asarray(b))
    tm = LPIPS()
    sd = jax_params_to_torch(_np(params))
    assert "net.slice3.14.weight" in sd
    assert sd["lin2.model.1.weight"].shape == (1, 256, 1, 1)
    tm.load_state_dict(sd, strict=True)
    got = tm(_nchw(a), _nchw(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)


def _tiny_backbone():
    from aqualora_tpu.core.config import EfficientNetConfig
    return dataclasses.replace(EfficientNetConfig.tiny(), dropout_rate=0.0)


def test_efficientnet_train_mode_matches_flax():
    """The tiny SecretDecoder in train mode: the logits and the updated
    BatchNorm statistics against flax's `mutable=["batch_stats"]` call
    (flax updates the variance with the biased batch variance, which
    `torch.nn.BatchNorm2d` would not), then the eval-mode logits with the
    updated statistics; rtol 1e-4, atol 1e-5."""
    import aqualora_torch.core.config as tcfg
    from aqualora_torch.models.efficientnet import Masks
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_tpu.models.watermark import SecretDecoder as JaxDecoder

    jbb = _tiny_backbone()
    jdec = JaxDecoder(8, jbb)
    shapes = jax.eval_shape(lambda: jdec.init(KEY, jnp.zeros((1, 64, 64, 3))))
    params, stats = _fill(shapes["params"], 4), _stats(shapes["batch_stats"], 5)
    x = _images(9, (3, 48, 48, 3))
    logits, upd = jax.jit(lambda p, s, x: jdec.apply(
        {"params": p, "batch_stats": s}, x, True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(x))
    eval_logits = jax.jit(lambda p, s, x: jdec.apply(
        {"params": p, "batch_stats": s}, x, False))(
            params, upd["batch_stats"], jnp.asarray(x))

    tdec = SecretDecoder(8, dataclasses.replace(
        tcfg.EfficientNetConfig.tiny(), dropout_rate=0.0), device="cpu")
    assert tdec.model.stochastic_blocks() == []
    tdec.load_state_dict(jax_params_to_torch(_np(params), _np(stats)),
                         strict=True)
    got = tdec(_nchw(x), train=True, masks=Masks([], None))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    want = jax_params_to_torch(_np(params), _np(upd["batch_stats"]))
    sd = tdec.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            n += 1
    assert n > 20
    np.testing.assert_allclose(tdec(_nchw(x)).detach().numpy(),
                               np.asarray(eval_logits), rtol=1e-4, atol=1e-5)
    # the mode is the call's: an eval call leaves the statistics and the
    # module's flag as they were, and a train call without masks is refused
    assert all(torch.equal(v, sd[k]) for k, v in tdec.state_dict().items())
    assert tdec.training
    with pytest.raises(ValueError, match="keep masks"):
        tdec(_nchw(x), train=True)


def test_bf16_encoder_and_decoder_match_flax_bf16():
    """Under bf16 the SecretEncoder and SecretDecoder compute in bfloat16
    on float32 parameters (`Stage1Models.autocast`), as flax's
    `dtype=bfloat16` does.  On bf16 inputs, the encoder's watermark and
    the train-mode decoder's logits and updated statistics each lie
    within three times the reference's own bf16 rounding: the gap between
    flax's bf16 and float32 results.  (That bound would also pass float32
    compute; test_stage1_bf16_step_computes_in_bf16 checks the types.)"""
    import aqualora_torch.core.config as tcfg
    from aqualora_torch.models.efficientnet import Masks
    from aqualora_torch.train import latent_wm_pretrain as tt
    from aqualora_tpu.models.watermark import SecretDecoder as JaxDecoder
    from aqualora_tpu.models.watermark import SecretEncoder as JaxEncoder

    bf = jnp.bfloat16
    models = tt.build_models(tcfg.VAEConfig.tiny(),
                             tcfg.WatermarkConfig.tiny(), dataclasses.replace(
                                 tcfg.EfficientNetConfig.tiny(),
                                 dropout_rate=0.0), "cpu", torch.bfloat16)

    def gap(a, b):
        return np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)
                      ).max()

    lat = jnp.asarray(_images(1, (2, 32, 32, 4))).astype(bf)
    msg = (np.random.default_rng(2).random((2, 8)) > 0.5).astype(np.float32)
    jenc = {dt: JaxEncoder(8, 8, 256, 4, dtype=dt) for dt in (bf, jnp.float32)}
    eparams = _fill(jax.eval_shape(lambda: jenc[bf].init(
        KEY, lat, jnp.zeros((1, 8))))["params"], 3)
    want = {dt: jax.jit(m.apply)({"params": eparams}, lat, jnp.asarray(msg))[1]
            for dt, m in jenc.items()}
    models.sec_encoder.load_state_dict(jax_params_to_torch(_np(eparams)),
                                       strict=True)
    with models.autocast():
        _, c = models.sec_encoder(_nchw(lat.astype(jnp.float32)).to(
            torch.bfloat16), _t(msg))
    assert c.dtype == torch.bfloat16
    assert gap(_nhwc(c.float()), want[bf]) <= 3 * gap(want[bf],
                                                      want[jnp.float32])

    x = jnp.asarray(_images(9, (3, 48, 48, 3))).astype(bf)
    jdec = {dt: JaxDecoder(8, _tiny_backbone(), dtype=dt)
            for dt in (bf, jnp.float32)}
    shapes = jax.eval_shape(lambda: jdec[bf].init(KEY, jnp.zeros((1, 64, 64,
                                                                  3))))
    params, stats = _fill(shapes["params"], 4), _stats(shapes["batch_stats"],
                                                      5)
    ref = {dt: jax.jit(lambda p, s, x, m=m: m.apply(
        {"params": p, "batch_stats": s}, x, True, mutable=["batch_stats"]))(
            params, stats, x) for dt, m in jdec.items()}
    dec = models.sec_decoder
    dec.load_state_dict(jax_params_to_torch(_np(params), _np(stats)),
                        strict=True)
    with models.autocast():
        logits = dec(_nchw(x.astype(jnp.float32)).to(torch.bfloat16),
                     train=True, masks=Masks([], None))
    assert logits.dtype == torch.bfloat16
    assert gap(logits.float().detach().numpy(), ref[bf][0]) <= 3 * gap(
        ref[bf][0], ref[jnp.float32][0])
    running = {dt: {k: v.numpy() for k, v in jax_params_to_torch(
        _np(params), _np(r[1]["batch_stats"])).items()
        if k.endswith(("running_mean", "running_var"))}
        for dt, r in ref.items()}
    sd = dec.state_dict()
    worst = max(gap(sd[k], v) for k, v in running[bf].items())
    own = max(gap(v, running[jnp.float32][k]) for k, v in running[bf].items())
    assert worst <= 3 * own


def test_stage1_bf16_step_computes_in_bf16():
    """The tiny stage-1 step under bf16 on the CPU: every convolution and
    linear layer of the SecretEncoder and SecretDecoder computes in
    bfloat16, while their parameters, gradients and BatchNorm statistics
    stay float32; the loss is finite (at 32 px, B2)."""
    import aqualora_torch.core.config as tcfg
    from aqualora_torch.train import latent_wm_pretrain as tt

    models = tt.build_models(tcfg.VAEConfig.tiny(),
                             tcfg.WatermarkConfig.tiny(),
                             tcfg.EfficientNetConfig.tiny(), "cpu",
                             torch.bfloat16)
    tt.init_models(models, 0)
    seen = []
    for part in (models.sec_encoder, models.sec_decoder):
        for m in part.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.register_forward_hook(
                    lambda m, i, o: seen.append(o.dtype))
    gen = torch.Generator().manual_seed(0)
    draws = tt.draw(models, gen, (2, 3, 32, 32), tt.LATE_PROBS)
    loss, _ = tt.make_loss_fn(models)(torch.rand(2, 3, 32, 32) * 2 - 1,
                                      draws, tt.Control())
    loss.backward()
    assert torch.isfinite(loss)
    assert len(seen) > 20 and set(seen) == {torch.bfloat16}
    for part in (models.sec_encoder, models.sec_decoder):
        for p in part.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
    assert all(b.dtype == torch.float32 for n, b in
               models.sec_decoder.named_buffers() if "running" in n)


def test_decoder_masks_keep_rate_and_scale():
    """EfficientNet-B1's training masks: each stochastic block keeps a
    sample with probability 1 - p (p = 0.2 * block / blocks, as flax's
    `MBConv`), the head keeps a feature with 1 - 0.2; a kept branch is
    scaled by 1 / (1 - p) and a dropped one is 0."""
    from aqualora_torch.core.config import EfficientNetConfig
    from aqualora_torch.models.efficientnet import EfficientNet

    net = EfficientNet(EfficientNetConfig.b1(num_classes=96))
    blocks = net.stochastic_blocks()
    assert len(blocks) == 16
    assert all(b.use_res for b in blocks)
    masks = net.draw_masks(20000, torch.Generator().manual_seed(0))
    for b, keep in zip(blocks, masks.depth):
        assert keep.dtype == torch.bool and keep.shape == (20000,)
        assert abs(keep.float().mean().item() - (1 - b.sd_prob)) < 0.015
    assert masks.dropout.shape == (20000, net.head_channels)
    assert abs(masks.dropout.float().mean().item() - 0.8) < 0.005

    block = blocks[-1]
    x = torch.randn(2, block.block[0][0].in_channels, 6, 6)
    with torch.no_grad():
        branch = block.block(x)
        out = block(x, keep=torch.tensor([True, False]))
    torch.testing.assert_close(out[0], branch[0] / (1 - block.sd_prob) + x[0])
    torch.testing.assert_close(out[1], x[1])


# ---------------------------------------------------------------------------
# the tiny stage-1 step
# ---------------------------------------------------------------------------

def _port_draws(key, images_shape, probs, bits):
    """The port's `Draws` for the JAX step's key: the splits of
    `make_train_step` (augmentation) and `loss_fn` (VAE noise, message,
    cornerfy, Noiser; the decoder's masks are unused at dropout 0)."""
    from aqualora_torch.distort.noiser import NoiseDraw
    from aqualora_torch.models.efficientnet import Masks
    from aqualora_torch.train.latent_wm_pretrain import Draws

    b, h, w, _ = images_shape
    kaug, key = jax.random.split(key)
    kvae, kmsg, kcorner, kdist, _ = jax.random.split(key, 5)
    kp, kf, kr = jax.random.split(kaug, 3)
    cp, ca = jax.random.split(kcorner)
    kh, kw = jax.random.split(ca)
    kc, ka = jax.random.split(kdist)
    index = int(jax.random.choice(kc, 6, p=jnp.asarray(probs)))
    return Draws(
        vae_noise=_nchw(jax.random.normal(kvae, (b, h // 2, w // 2, 4))),
        msg=_t(jax.random.bernoulli(kmsg, 0.5, (b, bits)).astype(
            jnp.float32)),
        corner=bool(jax.random.bernoulli(cp, 0.25)),
        corner_hs=float(jax.random.uniform(kh, (), minval=1.0, maxval=2.0)),
        corner_ws=float(jax.random.uniform(kw, (), minval=1.0, maxval=2.0)),
        aug=bool(jax.random.bernoulli(kp)), aug_flip=bool(
            jax.random.bernoulli(kf)),
        aug_k=int(jax.random.randint(kr, (), 0, 4)),
        noise=NoiseDraw(index, _layer_params(NAMES[index], ka, (b, h, w, 3))),
        masks=Masks([], None))


def _port_tree(models, attr):
    """Copies of the encoder's and decoder's parameters or gradients."""
    return {part: {n: getattr(p, attr).detach().clone() for n, p in
                   getattr(models, part).named_parameters()}
            for part in ("sec_encoder", "sec_decoder")}


@pytest.fixture(scope="module")
def stage1():
    """One tiny stage-1 step through both trainers for each of the six
    stage-1 distortions (its probability at 1), loss weights (5, 1, 1.5),
    random_aug on, at 64 px B2.  The JAX step's optimizer has a
    pass-through transform in front that keeps the raw gradients."""
    import optax

    import aqualora_torch.core.config as tcfg
    from aqualora_torch.train import latent_wm_pretrain as tt
    from aqualora_tpu.core.config import VAEConfig, WatermarkConfig
    from aqualora_tpu.train import latent_wm_pretrain as jt

    wm = WatermarkConfig.tiny()
    jm = jt.build_models(VAEConfig.tiny(), wm, _tiny_backbone())
    img, lat = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 32, 32, 4))
    shapes = jax.eval_shape(lambda: {
        "vae": jm.vae.init(KEY, img, KEY)["params"],
        "lpips": jm.lpips.init(KEY, img, img)["params"],
        "enc": jm.sec_encoder.init(KEY, lat, jnp.zeros((1, 8)))["params"],
        "dec": jm.sec_decoder.init(KEY, img)})
    frozen = {"vae": _fill(shapes["vae"], 1), "lpips": _fill(shapes["lpips"],
                                                             2)}
    params = {"sec_encoder": _fill(shapes["enc"], 3),
              "sec_decoder": _fill(shapes["dec"]["params"], 4)}
    stats = _stats(shapes["dec"]["batch_stats"], 5)

    lr_fn = lambda step: LR * (0.8 ** ((step // STEPS_PER_EPOCH) // 2))
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, state, params=None: (u, u))
    tx = optax.chain(record, optax.adamw(lr_fn, weight_decay=1e-4))
    j_step = jt.make_train_step(jm, tx, wm.msg_bits)

    def fresh():
        return jax.tree_util.tree_map(jnp.array, (params, stats))

    tbb = dataclasses.replace(tcfg.EfficientNetConfig.tiny(), dropout_rate=0.0)
    models = tt.build_models(tcfg.VAEConfig.tiny(),
                             tcfg.WatermarkConfig.tiny(), tbb, "cpu")
    models.vae.load_state_dict(jax_params_to_torch(_np(frozen["vae"])),
                               strict=True)
    models.lpips.load_state_dict(jax_params_to_torch(_np(frozen["lpips"])),
                                 strict=True)
    runs = []
    for index in range(6):
        probs = np.eye(6, dtype=np.float32)[index]
        ctl = {"wm_scale": jnp.float32(1.0),
               "loss_weights": jnp.asarray((5.0, 1.0, 1.5)),
               "distort_probs": jnp.asarray(probs),
               "fixinit": jnp.asarray(False),
               "random_aug": jnp.asarray(True)}
        pixels = _images(50 + index, (2, 64, 64, 3))
        key = jax.random.PRNGKey(60 + index)
        p, s = fresh()
        j_new, j_stats, j_opt, j_metrics = j_step(
            p, s, tx.init(p), frozen, jnp.asarray(pixels), key, ctl)

        models.sec_encoder.load_state_dict(
            jax_params_to_torch(_np(params["sec_encoder"])), strict=True)
        models.sec_decoder.load_state_dict(jax_params_to_torch(
            _np(params["sec_decoder"]), _np(stats)), strict=True)
        optimizer, scheduler = tt.make_optimizer(models, LR, STEPS_PER_EPOCH)
        step = tt.make_train_step(models, optimizer, scheduler)
        draws = _port_draws(key, pixels.shape, probs, wm.msg_bits)
        assert draws.noise.index == index
        t_metrics = step(pixels, draws, tt.Control())
        runs.append({"j_metrics": _np(j_metrics),
                     "j_grads": _np(j_opt[0]), "j_new": _np(j_new),
                     "j_stats": _np(j_stats), "t_metrics": t_metrics,
                     "t_grads": _port_tree(models, "grad"),
                     "t_params": _port_tree(models, "data"),
                     "t_stats": {k: v.clone() for k, v in
                                 models.sec_decoder.state_dict().items()},
                     "draws": draws})
    return {"runs": runs, "params": _np(params)}


def test_stage1_loss_matches_jax(stage1):
    """The loss and its terms (LPIPS, message BCE, PRVL) and the bit
    accuracy of each of the six steps, rtol 1e-5; every term is live and
    the draws reach cornerfy's and base_augment's both branches."""
    runs = stage1["runs"]
    for run in runs:
        j, t = run["j_metrics"], run["t_metrics"]
        for name in ("loss", "lpips_loss", "msgloss", "prvl_loss"):
            assert float(j[name]) > 0, name
            np.testing.assert_allclose(float(t[name]), float(j[name]),
                                       rtol=1e-5, err_msg=name)
        assert float(t["acc"]) == float(j["acc"])
    assert {r["draws"].corner for r in runs} == {True, False}
    assert {r["draws"].aug for r in runs} == {True, False}


def _grad_tol(g, part_max):
    """How far a leaf's gradient may differ: 1e-4 of its own largest value
    (float32 sums in other orders through the VAE decode, the distortion,
    LPIPS and the decoder) plus 1e-5 of the module's largest gradient.
    The second term is for leaves whose exact gradient is 0, as the
    decoder's project BatchNorm biases: a per-channel constant in the
    block stream is removed by the next convolution's train-mode
    BatchNorm, so both sides read float32 noise there."""
    return 1e-4 * np.abs(g).max() + 1e-5 * part_max


def test_stage1_every_gradient_matches_jax(stage1):
    """Every encoder and decoder gradient within `_grad_tol`, for each of
    the six distortions."""
    for run in stage1["runs"]:
        got = run["t_grads"]
        n = 0
        for part in ("sec_encoder", "sec_decoder"):
            want = jax_params_to_torch(run["j_grads"][part])
            assert set(want) == set(got[part])
            part_max = max(np.abs(g.numpy()).max() for g in want.values())
            for name, g in want.items():
                g = g.numpy()
                assert np.abs(g).max() > 0, (part, name)
                np.testing.assert_allclose(got[part][name].numpy(), g,
                                           atol=_grad_tol(g, part_max),
                                           err_msg=f"{part}.{name}")
                n += 1
        assert n > 50


def test_stage1_train_step_matches_jax(stage1):
    """The parameters after one AdamW step (lr 1e-3, weight decay 1e-4)
    and the decoder's updated BatchNorm statistics.  As in the PPFT test,
    an element whose gradient is resolved (above ten times `_grad_tol`)
    agrees to 1e-6 + 1e-6 * |p|; elsewhere the first step is bounded by
    2 * lr * (1 + wd).  The statistics rtol 1e-4, atol 1e-5."""
    for run in stage1["runs"]:
        got = run["t_params"]
        for part in ("sec_encoder", "sec_decoder"):
            new = jax_params_to_torch(run["j_new"][part])
            grads = {k: v.numpy() for k, v in
                     jax_params_to_torch(run["j_grads"][part]).items()}
            part_max = max(np.abs(g).max() for g in grads.values())
            for name, want in new.items():
                want, p = want.numpy(), got[part][name].numpy()
                g = grads[name]
                resolved = np.abs(g) > 10 * _grad_tol(g, part_max)
                np.testing.assert_allclose(p[resolved], want[resolved],
                                           atol=1e-6, rtol=1e-6,
                                           err_msg=name)
                assert np.abs(p - want).max() <= 2 * LR * (1 + 1e-4), name
        want = jax_params_to_torch(run["j_new"]["sec_decoder"],
                                   run["j_stats"])
        sd = run["t_stats"]
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=k)


def test_step_lr_and_curriculum_match_jax():
    """StepLR as lr * 0.8^(epoch // 2) with epoch = update // steps per
    epoch (the JAX `lr_fn`), and the curriculum's staged weights and
    probabilities at the epochs where they change."""
    from aqualora_torch.train import latent_wm_pretrain as tt

    factor = tt.step_lr(STEPS_PER_EPOCH)
    for step in (0, 2, 3, 5, 6, 11, 12, 30):
        epoch = step // STEPS_PER_EPOCH
        assert factor(step) == 0.8 ** (epoch // 2)
    warm = tt.curriculum(20, True, True, True)
    assert (warm.wm_scale, warm.loss_weights, warm.fixinit) == (
        0.03, (0.0, 1.0, 0.0), True)
    want = {6: (0.0, 1.0, 0.0), 7: (1.0, 1.0, 0.0), 10: (1.0, 1.0, 0.0),
            11: (5.0, 1.0, 1.5)}
    for epoch, weights in want.items():
        ctl = tt.curriculum(epoch, False, False, True)
        assert ctl.loss_weights == weights and ctl.wm_scale == 1.0
    assert tt.curriculum(12, False, False, True).distort_probs == (
        0.6, 0.0, 0.4, 0.0, 0.0, 0.0)
    assert tt.curriculum(13, False, False, True).distort_probs == (
        0.4, 0.1, 0.2, 0.05, 0.1, 0.15)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_stage1_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """The entry point as a user calls it (`main`, what `python -m` runs,
    in this process), on the CPU: two logged steps, finite losses, and the
    artifact loads into fresh tiny modules."""
    import aqualora_torch.core.config as tcfg
    from aqualora_torch.train import latent_wm_pretrain as tt

    monkeypatch.setattr(sys, "argv", [
        "latent_wm_pretrain", "--tiny", "--max_train_steps", "2",
        "--batch_size", "2", "--device", "cpu", "--output_dir",
        str(tmp_path)])
    tt.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " step " in ln]
    assert len(lines) == 2
    for ln in lines:
        fields = dict(kv.split("=") for kv in ln.split() if "=" in kv)
        assert np.isfinite(float(fields["loss"]))
    art = torch.load(tmp_path / "pretrained_latentwm.pt")
    models = tt.build_models(tcfg.VAEConfig.tiny(), tcfg.WatermarkConfig.tiny(),
                             tcfg.EfficientNetConfig.tiny(), "cpu")
    models.sec_encoder.load_state_dict(art["sec_encoder"], strict=True)
    models.sec_decoder.load_state_dict(art["sec_decoder"], strict=True)
    assert int(art["sec_decoder"][
        "model.features.0.1.num_batches_tracked"]) == 2


def test_stage1_cli_defaults_and_refusals():
    """`--device` defaults to cuda; the one flag not ported (`--fsdp`) is
    refused, never ignored, and the others build a trainer (they are held
    in tests/test_torch_port_stage1_flags.py); a VAE directory that does
    not exist is refused (the loader is held against JAX's in
    tests/test_torch_port_artifacts.py); a dataset path that is not a directory raises rather than training on
    noise (the folder itself: tests/test_torch_port_data.py)."""
    from aqualora_torch.train import data
    from aqualora_torch.train import latent_wm_pretrain as tt

    args = tt.build_argparser().parse_args([])
    assert args.device == "cuda" and args.batch_size == 5
    assert args.mixed_precision == "no"
    with pytest.raises(NotImplementedError, match="--fsdp"):
        tt.build_trainer(tt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--fsdp"]))
    for extra in (["--resume_from_ckpt", "x"], ["--remat_lpips"],
                  ["--remat_vae_decode"], ["--report_to", "tensorboard"]):
        tt.build_trainer(tt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu"] + extra))
    with pytest.raises(FileNotFoundError):
        tt.build_trainer(tt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--pretrained_model_name_or_path",
             "/nonexistent/sd"]))
    with pytest.raises(FileNotFoundError, match="not a directory"):
        data.make_dataset("/nonexistent/images", 64)
    with pytest.raises(FileNotFoundError, match="not a directory"):
        tt.build_trainer(tt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--dataset", "/nonexistent/images"]))
    assert len(data.make_dataset(None, 64)) == 256


def test_stage1_modules_import_no_jax():
    """The modules of the stage-1 slice import neither jax nor
    aqualora_tpu."""
    mods = ["aqualora_torch.train.latent_wm_pretrain",
            "aqualora_torch.train.losses", "aqualora_torch.train.augment",
            "aqualora_torch.distort.noiser", "aqualora_torch.distort.noises",
            "aqualora_torch.distort.jpeg", "aqualora_torch.models.lpips",
            "aqualora_torch.models.efficientnet",
            "aqualora_torch.core.convert"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'aqualora_tpu'))]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
