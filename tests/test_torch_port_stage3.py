"""The port's stage 3 (the decoder's robustness fine-tune) against the JAX
package, on the CPU at the tiny configuration.

The stage-3 distortions, the resolution stream, the generation with the
message threaded as the LoRA diagonal and the decoder step are held against
`aqualora_tpu` on the same seeded numpy inputs and the same random numbers:
the JAX functions draw theirs from keys, and these tests draw the same
numbers by repeating the JAX package's key splits, then hand them to the
port, whose functions take them as arguments.  The decoder step runs the
tiny decoder with its dropout at 0 (a `dataclasses.replace` of the tiny
EfficientNet config), since flax draws the dropout masks inside the
module; the tiny decoder has no stochastic-depth block.  Then the port's
own contracts: resume, checkpoints, the CLI chain stage 1 -> PPFT ->
stage 3 -> the auditor's loader, and PPFT's resume.
"""

import dataclasses
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
from aqualora_torch.core.convert import jax_params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
KINDS = ("identity", "color_jitter", "crop", "blur", "noise")
# the generated images, port against JAX (the tiny DDIM and dpms_m slices'
# tolerance, tests/test_torch_port_pipeline.py)
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


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


def _unit_params(kind, key, shape):
    """The port's numbers for the stage-3 distortion `kind` on NHWC
    `shape`, drawn as `aqualora_tpu/distort/noiser.py:_du_*` draws them
    from `key` (through `distort/noises.py`)."""
    b, h, w, _ = shape
    u = jax.random.uniform
    t = lambda x: torch.from_numpy(np.array(x).reshape(b))
    if kind == "identity":
        return {}
    if kind == "color_jitter":
        kb, kc, ks, kh = jax.random.split(key, 4)
        draw = lambda k, lo, hi: t(u(k, (b, 1, 1, 1), minval=lo, maxval=hi))
        return {"brightness": draw(kb, 0.8, 1.2),
                "contrast": draw(kc, 0.8, 1.2),
                "saturation": draw(ks, 0.8, 1.2), "hue": draw(kh, -0.1, 0.1)}
    if kind == "crop":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        lo_h, lo_w = min(432, h), min(432, w)
        ch = u(k1, (b,), minval=lo_h, maxval=max(min(512, h), lo_h + 1e-6))
        cw = u(k2, (b,), minval=lo_w, maxval=max(min(512, w), lo_w + 1e-6))
        return {"ch": t(ch), "cw": t(cw), "ty": t(u(k3, (b,)) * (h - ch)),
                "tx": t(u(k4, (b,)) * (w - cw))}
    if kind == "blur":
        return {"sigma": t(u(key, (b,), minval=4.0 - 1e-6, maxval=4.0))}
    _, k2 = jax.random.split(key)
    return {"noise": _nchw(jax.random.normal(k2, shape))}


# ---------------------------------------------------------------------------
# the distortions and the streams
# ---------------------------------------------------------------------------

# the crop's resample at 576^2 reads sampling coordinates up to 576, where a
# float32 ulp is 2^-14: XLA rounds JAX's coordinates otherwise than torch
# (the port lies within 1.3e-7 of the same resample in float64, JAX 3.9e-5
# off it), and one ulp of a coordinate moves a bilinear weight by 2^-14,
# times a neighbour difference of at most 1 on [0, 1] images
CROP_TOL = 2.0 ** -14


@pytest.fixture(scope="module")
def jax_noiser():
    """JAX's Stage3Noiser, jitted once for the five cases."""
    from aqualora_tpu.distort.noiser import Stage3Noiser
    return jax.jit(Stage3Noiser())


@pytest.mark.parametrize("kind", KINDS)
def test_stage3_noiser_matches_jax(kind, jax_noiser):
    """Each stage-3 distortion at 576^2 B2 (where the crop's U(432, 512)
    is live) with JAX's draws handed over, within 1e-5 (float32 sums in
    other orders; the crop within CROP_TOL, and the port's crop within
    1e-6 of its float64 resample); through `Stage3Noiser` with the pick
    JAX's `jax.random.choice` makes from a key whose pick is this kind."""
    from aqualora_torch.distort.noiser import (DISTORTION_UNITS, NoiseDraw,
                                               Stage3Noiser,
                                               distortion_unit)
    from aqualora_tpu.distort import noiser as jn

    assert Stage3Noiser.ORDER == jn.Stage3Noiser.ORDER == KINDS
    assert Stage3Noiser.DEFAULT_PROBS == jn.Stage3Noiser.DEFAULT_PROBS
    assert set(DISTORTION_UNITS) == set(jn.DISTORTION_UNIT_FNS)
    index = KINDS.index(kind)
    p = jnp.asarray(jn.Stage3Noiser.DEFAULT_PROBS)
    seed = next(s for s in range(200) if int(jax.random.choice(
        jax.random.split(jax.random.PRNGKey(s))[0], 5, p=p)) == index)
    key = jax.random.PRNGKey(seed)
    shape = (2, 576, 576, 3)
    x = np.random.default_rng(index).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax_noiser(key, jnp.asarray(x)))
    _, ka = jax.random.split(key)
    params = _unit_params(kind, ka, shape)
    got = Stage3Noiser()(_nchw(x), NoiseDraw(index, params))
    tol = CROP_TOL if kind == "crop" else 1e-5
    np.testing.assert_allclose(_nhwc(got), want, atol=tol)
    np.testing.assert_allclose(_nhwc(distortion_unit(_nchw(x), kind, params)),
                               want, atol=tol)
    if kind == "crop":
        f64 = distortion_unit(_nchw(x).double(), kind,
                              {k: v.double() for k, v in params.items()})
        np.testing.assert_allclose(_nhwc(got), _nhwc(f64), atol=1e-6)
    if kind != "identity":
        assert np.abs(want - x).max() > 1e-2
    assert got.dtype == torch.float32


def test_stage3_noiser_draw_follows_probs():
    """`Stage3Noiser.draw` picks each distortion at its default probability
    (20000 draws, within 0.01), and only the kinds given a probability."""
    from aqualora_torch.distort.noiser import Stage3Noiser

    gen = torch.Generator().manual_seed(0)
    noiser = Stage3Noiser()
    picks = np.bincount([noiser.draw(gen, (1, 3, 8, 8)).index
                         for _ in range(20000)], minlength=5) / 20000
    np.testing.assert_allclose(picks, Stage3Noiser.DEFAULT_PROBS, atol=0.01)
    only_blur = (0.0, 0.0, 0.0, 1.0, 0.0)
    assert {noiser.draw(gen, (1, 3, 8, 8), only_blur).index
            for _ in range(50)} == {3}


def _tiny_trainer(tmp, *extra):
    from aqualora_torch.train import rob_enhance_finetune as s3
    return s3.build_trainer(s3.build_argparser().parse_args(
        ["--tiny", "--train_batch_size", "2", "--device", "cpu",
         "--output_dir", str(tmp), "--report_to", "none", *extra]))


def test_stage3_resolution_sequence_matches_jax(tmp_path):
    """The resolutions: the JAX package's RESOLUTIONS (and (32, 48) under
    --tiny), each step's drawn with `np.random.default_rng(seed).choice`,
    the JAX loop's stream, also through the port's step inputs."""
    from aqualora_torch.train import rob_enhance_finetune as s3
    from aqualora_tpu.train import rob_enhance_finetune as j3

    assert s3.RESOLUTIONS == j3.RESOLUTIONS
    want = np.random.default_rng(3)
    tr = _tiny_trainer(tmp_path, "--seed", "3")
    got = [s3.next_step_inputs(tr)[1] for _ in range(12)]
    assert got == [int(want.choice((32, 48))) for _ in range(12)]
    assert set(got) == {32, 48}
    full = np.random.default_rng(0)
    assert [int(full.choice(s3.RESOLUTIONS)) for _ in range(6)] == [
        768, 704, 640, 576, 576, 512]


# ---------------------------------------------------------------------------
# the generation and the decoder step against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny JAX pipeline (float32 and bf16) and seeded weights, every
    LoRA up weight non-zero."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    jpipe = StableDiffusionPipeline(jcfg.PipelineConfig.tiny())
    params = _np(_fill(jax.eval_shape(
        lambda: jpipe.init_params(KEY, 32, 32)), 7))
    return {"f32": jpipe, "bf16": StableDiffusionPipeline(
        jcfg.PipelineConfig.tiny(), dtype=jnp.bfloat16), "params": params}


def _jax_generate(jpipe, params, res, ids, neg, key, msg):
    """JAX's stage-3 generation (`rob_enhance_finetune.py:213-220`) and the
    initial latent it draws from `key`."""
    diag = jpipe.message_scale(params, jnp.asarray(msg),
                               multiplier=jpipe.config.watermark
                               .inference_scale)
    images = jpipe.make_generate(num_steps=2, sampler="dpms_m", height=res,
                                 width=res)(params, jnp.asarray(ids),
                                            jnp.asarray(neg), key, 7.5, diag)
    z = jax.random.normal(jax.random.split(key)[1], (2, res // 2, res // 2, 4))
    return np.asarray(images), torch.from_numpy(np.array(z))


@pytest.fixture(scope="module")
def generated(tiny_jax, tmp_path_factory):
    """JAX's stage-3 images at 32^2 and 48^2 (float32), and at 32^2 in
    bf16, with the message threaded as the diagonal; the port's from the
    same weights, captions, messages and initial latents."""
    from aqualora_torch.distort.noiser import NoiseDraw
    from aqualora_torch.models.efficientnet import Masks
    from aqualora_torch.train import rob_enhance_finetune as s3

    params = tiny_jax["params"]
    cfg = tiny_jax["f32"].config
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    msg = rng.integers(0, 2, (2, cfg.watermark.msg_bits)).astype(np.float32)
    out = {}
    for tag, res in (("f32", 32), ("f32", 48), ("bf16", 32)):
        j_img, z = _jax_generate(tiny_jax[tag], params, res, ids, neg,
                                 jax.random.PRNGKey(res), msg)
        extra = ("--mixed_precision", "bf16") if tag == "bf16" else ()
        tr = _tiny_trainer(tmp_path_factory.mktemp("gen"), *extra)
        tr.pipe.load_jax_params(params)
        tr.tokenizer = lambda ids_or_caps, ids=ids, neg=neg: (
            ids if ids_or_caps[0] == "x" else neg)
        d = s3.Draws(z, torch.from_numpy(msg), NoiseDraw(0, {}),
                     Masks([], None))
        t_img = s3.generate_images(tr, res, ["x", "x"], d)
        plain = tr.generators[res](ids, neg, 7.5, None, z=z)
        out[(tag, res)] = (j_img, t_img, plain, tr)
    return out


@pytest.mark.parametrize("case", [("f32", 32), ("f32", 48), ("bf16", 32)],
                         ids=["f32-32", "f32-48", "bf16-32"])
def test_stage3_generation_threads_the_diag_like_jax(generated, case):
    """`generate_images`: dpms_m 2 steps at CFG 7.5 with mapper(msg) * 1.03
    threaded as the per-image LoRA diagonal (not folded), JAX's initial
    latents replayed: in float32 the images in [-1, 1] within IMAGE_TOL
    of JAX's; without the diagonal they differ.  In bf16 both packages
    return float32 images (the VAE's last convolution computes in float32)
    and run the U-Net in bf16 in other orders, whose roundings two steps at
    CFG 7.5 amplify on random weights: the mean gap to JAX's bf16 images
    stays within twice JAX's own bf16-to-float32 gap (measured 1.46x)."""
    j_img, t_img, plain, tr = generated[case]
    tag, res = case
    assert t_img.shape == (2, 3, res, res) and t_img.dtype == torch.float32
    assert j_img.dtype == np.float32
    got = _nhwc(t_img) * 2 - 1
    if tag == "f32":
        np.testing.assert_allclose(got, j_img, atol=IMAGE_TOL)
        assert np.abs(plain.numpy() - j_img).max() > 10 * IMAGE_TOL
    else:
        j_f32 = generated[("f32", res)][0]
        gap = np.abs(j_img - j_f32).mean()
        assert gap > 0 and np.abs(got - j_img).mean() <= 2 * gap
        assert tr.pipe.unet.conv_in.weight.dtype == torch.bfloat16
        assert tr.decoder.model.classifier[1].weight.dtype == torch.float32


def _record_adamw(lr):
    """optax.adamw (weight decay 1e-2, the CLI default on both sides)
    behind a pass-through transform whose state keeps the
    raw gradients (the JAX step returns only the updated parameters)."""
    import optax
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, state, params=None: (u, u))
    return optax.chain(record, optax.adamw(lambda step: lr,
                                           weight_decay=1e-2))


DECODER_LR = 1e-3


@pytest.fixture(scope="module")
def jax_decoder_step():
    """JAX's jitted decoder step (`make_decoder_step`) for the tiny decoder
    at dropout 0, and its seeded parameters and statistics: one compile
    for both cases, whose images have one shape."""
    from aqualora_tpu.models.watermark import SecretDecoder
    from aqualora_tpu.train import rob_enhance_finetune as j3

    jdec = SecretDecoder(8, dataclasses.replace(
        jcfg.EfficientNetConfig.tiny(), dropout_rate=0.0))
    shapes = jax.eval_shape(lambda: jdec.init(KEY, jnp.zeros((1, 64, 64, 3))))
    tx = _record_adamw(DECODER_LR)
    return (jdec, tx, j3.make_decoder_step(jdec, tx),
            _fill(shapes["params"], 21), _stats(shapes["batch_stats"], 22))


@pytest.mark.parametrize("images", ["f32", "bf16"])
def test_stage3_decoder_step_matches_jax(images, generated, jax_decoder_step):
    """One decoder step (`make_decoder_step`): the tiny decoder (dropout
    0) in train mode on distorted images, AdamW at lr 1e-3 without
    warm-up on both sides.  "f32": seeded uniform images at 32^2 with
    colour jitter; "bf16": the images JAX's bf16 pipeline generates (float32
    typed, as JAX hands them to its step) with noise.  The loss to rtol
    1e-5, the accuracy exactly, every gradient within 1e-4 of its leaf's
    largest value plus 1e-5 of the decoder's; after the update, as in the
    stage-1 test, an element whose gradient is resolved (above ten times
    that limit) agrees to 1e-6 + 1e-6 * |p|, elsewhere the first Adam step
    is bounded by 2 * lr * (1 + wd) (an Adam step moves a parameter by
    about lr whatever its gradient's size, so an unresolved gradient's
    sign is float32 noise); the BatchNorm statistics rtol 1e-4, atol
    1e-5, and every tensor moves."""
    from aqualora_torch.distort.noiser import NoiseDraw
    from aqualora_torch.models.efficientnet import Masks
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train import ppft_train as pt
    from aqualora_torch.train import rob_enhance_finetune as s3
    from aqualora_tpu.distort.noiser import Stage3Noiser as JNoiser

    bits, lr = 8, DECODER_LR
    jdec, tx, step, params, stats = jax_decoder_step
    if images == "f32":
        x = np.random.default_rng(23).uniform(0, 1, (2, 32, 32, 3)).astype(
            np.float32)
        kind = "color_jitter"
    else:
        x = (generated[("bf16", 32)][0] + 1.0) / 2.0
        kind = "noise"
    assert x.dtype == np.float32
    msg = np.random.default_rng(24).integers(0, 2, (2, bits)).astype(
        np.float32)
    p = jnp.asarray(JNoiser.DEFAULT_PROBS)
    # the pick of JAX's step: kd, kdrop = split(key); kc, ka = split(kd)
    kc = lambda s: jax.random.split(jax.random.split(
        jax.random.PRNGKey(s))[0])[0]
    seed = next(s for s in range(300) if int(jax.random.choice(
        kc(s), 5, p=p)) == KINDS.index(kind))
    key = jax.random.PRNGKey(seed)
    fresh = jax.tree_util.tree_map(jnp.array, (params, stats))
    j_new, j_stats, j_opt, j_metrics = step(
        fresh[0], fresh[1], tx.init(fresh[0]), jnp.asarray(x),
        jnp.asarray(msg), key)

    tdec = SecretDecoder(bits, dataclasses.replace(
        tcfg.EfficientNetConfig.tiny(), dropout_rate=0.0), device="cpu")
    tdec.load_state_dict(jax_params_to_torch(_np(params), _np(stats)),
                         strict=True)
    tdec.requires_grad_(True)
    optimizer, scheduler = pt.make_optimizer(
        {"decoder": list(tdec.parameters())}, lr, 0, 10, lr_end=1.0)
    kd = jax.random.split(key)[0]
    ka = jax.random.split(kd)[1]
    t_metrics = s3.make_decoder_step(tdec, optimizer, scheduler)(
        _nchw(x), torch.from_numpy(msg), NoiseDraw(
            KINDS.index(kind), _unit_params(kind, ka, x.shape)),
        Masks([], None))

    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    assert float(t_metrics["acc"]) == float(j_metrics["acc"])
    want = {n: np.asarray(g) for n, g in
            jax_params_to_torch(_np(j_opt[0])).items()}
    grads = {n: p.grad for n, p in tdec.named_parameters()}
    top = max(float(np.abs(g).max()) for g in want.values())
    assert set(grads) == set(want) and top > 0
    tol = {n: 1e-4 * np.abs(g).max() + 1e-5 * top for n, g in want.items()}
    for n, g in want.items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=0, atol=tol[n],
                                   err_msg=n)
    new = jax_params_to_torch(_np(j_new), _np(j_stats))
    sd = tdec.state_dict()
    for n, v in new.items():
        got, v = sd[n].numpy(), np.asarray(v)
        if n in want:
            resolved = np.abs(want[n]) > 10 * tol[n]
            np.testing.assert_allclose(got[resolved], v[resolved], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
            assert np.abs(got - v).max() <= 2 * lr * (1 + 1e-2), n
        elif n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5,
                                       err_msg=n)
    start = jax_params_to_torch(_np(params), _np(stats))
    moved = sum(not torch.equal(sd[n], torch.as_tensor(np.asarray(start[n])))
                for n in start)
    assert moved == len(start)


# ---------------------------------------------------------------------------
# the port's loop: resume, checkpoints, the CLI
# ---------------------------------------------------------------------------

def _s3_argv(out, steps, *extra):
    # a constant learning rate (no warm-up, lr_end 1 holds the cosine at its
    # start), so that a run resumed at step k follows an uninterrupted
    # run's schedule: the cosine's length is the run's step count
    return ["--tiny", "--train_batch_size", "2", "--device", "cpu",
            "--output_dir", str(out), "--seed", "5", "--report_to", "none",
            "--lr_warmup_steps", "0", "--lr_end", "1", "--learning_rate",
            "1e-3", "--max_train_steps", str(steps), *extra]


def test_stage3_resume_replays_draws(tmp_path):
    """4 steps straight against 2 steps then `--resume_from_checkpoint
    latest` to 4: steps 3-4's metrics and the decoder (parameters and
    BatchNorm statistics) bit for bit; at most `--checkpoints_total_limit`
    checkpoints stay; a checkpoint of another seed is refused, and a run
    with none raises FileNotFoundError, as JAX's manager does."""
    from aqualora_torch.train import rob_enhance_finetune as s3

    run = lambda argv: s3.run(s3.build_argparser().parse_args(argv))
    straight = run(_s3_argv(tmp_path / "a", 4, "--checkpointing_steps", "1",
                            "--checkpoints_total_limit", "2"))
    assert sorted(os.listdir(tmp_path / "a" / "checkpoints")) == [
        "3.pt", "4.pt"]
    run(_s3_argv(tmp_path / "b", 2, "--checkpointing_steps", "2"))
    resumed = run(_s3_argv(tmp_path / "b", 4, "--checkpointing_steps", "2",
                           "--resume_from_checkpoint", "latest"))
    assert resumed["start_step"] == 2 and len(resumed["history"]) == 2
    assert resumed["history"] == straight["history"][2:]
    assert resumed["resolutions"] == straight["resolutions"][2:]
    a, b = straight["decoder"].state_dict(), resumed["decoder"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # an explicit step resumes too
    again = run(_s3_argv(tmp_path / "b", 4, "--resume_from_checkpoint", "2"))
    assert again["history"] == straight["history"][2:]
    with pytest.raises(ValueError, match="draws"):
        run(_s3_argv(tmp_path / "b", 4, "--resume_from_checkpoint", "2")
            [:-2] + ["--seed", "6", "--resume_from_checkpoint", "2"])
    with pytest.raises(FileNotFoundError):
        run(_s3_argv(tmp_path / "c", 2, "--resume_from_checkpoint",
                     "latest"))


def test_checkpoint_manager_saves_restores_and_prunes(tmp_path):
    """`core.checkpoint.CheckpointManager`: a nested state with tensors
    (moved to the CPU), ints and lists restores equal; `latest_step`,
    pruning to `max_to_keep`, no temporary file left."""
    from aqualora_torch.core.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 5, 7):
        mgr.save(step, {"w": torch.full((2, 3), float(step)), "step": step,
                        "nested": {"l": [torch.arange(3), 4]}})
    assert mgr.steps() == [5, 7] and mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "ck")) == ["5.pt", "7.pt"]
    got = mgr.restore()
    assert got["step"] == 7 and torch.equal(got["w"], torch.full((2, 3), 7.))
    assert torch.equal(got["nested"]["l"][0], torch.arange(3))
    assert mgr.restore(5)["step"] == 5
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)


def test_stage3_cli_writes_a_msgdecoder_the_auditor_reads(tmp_path, capsys):
    """The tiny chain through the CLIs' `run`: stage 1 -> PPFT from its
    file -> stage 3 with `--start_from_pretrain` (only the decoder, its
    BatchNorm statistics included) and `--resume_from_lora` (PPFT's LoRA
    and mapper), 2 steps; its msgdecoder.pt read strictly by
    `load_msgdecoder` equals the trained decoder; the log lines carry the
    resolution, and TensorBoard's logs are written where it is installed."""
    from aqualora_torch.core import io as tio
    from aqualora_torch.eval.utils_eval import load_msgdecoder
    from aqualora_torch.train import latent_wm_pretrain as s1
    from aqualora_torch.train import ppft_train as pt
    from aqualora_torch.train import rob_enhance_finetune as s3

    s1.run(s1.build_argparser().parse_args(
        ["--tiny", "--max_train_steps", "1", "--batch_size", "2",
         "--device", "cpu", "--output_dir", str(tmp_path / "s1")]))
    s1_file = str(tmp_path / "s1" / "pretrained_latentwm.pt")
    pt.run(pt.build_argparser().parse_args(
        ["--tiny", "--max_train_steps", "1", "--train_batch_size", "2",
         "--device", "cpu", "--report_to", "none", "--start_from_pretrain",
         s1_file, "--output_dir", str(tmp_path / "ppft")]))
    argv = ["--tiny", "--max_train_steps", "2", "--train_batch_size", "2",
            "--device", "cpu", "--start_from_pretrain", s1_file,
            "--resume_from_lora", str(tmp_path / "ppft"),
            "--output_dir", str(tmp_path / "s3")]
    args = s3.build_argparser().parse_args(argv)
    tr = s3.build_trainer(args)
    stage1 = torch.load(s1_file, weights_only=True)["sec_decoder"]
    sd = tr.decoder.state_dict()
    assert set(sd) == set(stage1)
    assert all(torch.equal(sd[k], stage1[k]) for k in sd)
    lora = tio.load_safetensors(str(tmp_path / "ppft" / tio.LORA_FILE))
    got = pt.split_lora(tr.pipe.unet)[1]
    assert all(torch.equal(got[name], lora[key]) for key, name in
               tio.lora_key_map(tr.pipe.config.unet).items())

    res = s3.run(args)
    out = capsys.readouterr().out
    assert "step 2/2 res=" in out and "acc=" in out and "loss=" in out
    assert len(res["history"]) == 2 and len(res["resolutions"]) == 2
    dec = load_msgdecoder(str(tmp_path / "s3" / pt.MSGDECODER_FILE),
                          tr.pipe.config.watermark.msg_bits,
                          tcfg.EfficientNetConfig.tiny(), device="cpu")
    want = res["decoder"].state_dict()
    assert all(torch.equal(dec.state_dict()[k], v) for k, v in want.items())
    assert not all(torch.equal(want[k], stage1[k]) for k in want)
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        return
    assert os.listdir(tmp_path / "s3" / "logs")


def test_stage3_cli_defaults_and_refusals(tmp_path):
    """The parser has JAX's stage-3 defaults (PPFT's parser, lr 5e-6, 48
    bits) and PPFT's checkpoint flags with JAX's defaults; `--fsdp` in a
    world of one process changes nothing, as in JAX; `--dataset_name` and
    `--dataset_config_name` are refused naming the HF datasets path; a
    `--train_data_dir` that is not a directory raises; a run needs
    `--output_dir`.  `--int8_gen` runs: every conv site of the U-Net holds
    int8 codes before the first step, the LoRA sites keep their LoRA."""
    from aqualora_torch.train import rob_enhance_finetune as s3

    args = s3.build_argparser().parse_args([])
    assert (args.learning_rate, args.msg_bits) == (5e-6, 48)
    assert (args.checkpointing_steps, args.checkpoints_total_limit,
            args.resume_from_checkpoint, args.report_to) == (
        500, None, None, "tensorboard")
    assert (args.device, args.mixed_precision, args.lr_warmup_steps) == (
        "cuda", "no", 500)
    assert "--output_dir is required" in s3.build_argparser().format_help()
    base = ["--tiny", "--device", "cpu", "--output_dir", str(tmp_path)]
    assert not s3.build_trainer(s3.build_argparser().parse_args(
        base + ["--fsdp"])).fsdp
    for flag, item in (("--dataset_name=n", "HF datasets"),
                       ("--dataset_config_name=c", "HF datasets")):
        with pytest.raises(NotImplementedError, match=item):
            s3.run(s3.build_argparser().parse_args(base + [flag]))
    with pytest.raises(FileNotFoundError, match="not a directory"):
        s3.run(s3.build_argparser().parse_args(
            base + [f"--train_data_dir={tmp_path / 'missing'}"]))
    with pytest.raises(ValueError, match="output_dir"):
        s3.run(s3.build_argparser().parse_args(["--tiny", "--device", "cpu"]))
    assert not os.listdir(tmp_path)
    from aqualora_torch.ops import quant
    args = s3.build_argparser().parse_args(
        _s3_argv(tmp_path / "int8", 1, "--int8_gen"))
    tr = s3.build_trainer(args)
    sites = quant.int8_sites(tr.pipe.unet, include_dense=False)
    assert sites and all(m.weight.dtype == torch.int8
                         and m.weight_scale.dtype == torch.float32
                         for _, m in sites)
    assert not any(m.weight.dtype == torch.int8 for _, m in quant.int8_sites(
        tr.pipe.unet, include_convs=False))
    assert any(getattr(m, "lora", None) is not None for _, m in sites)
    res = s3.run(args)
    assert len(res["history"]) == 1


def test_stage3_modules_import_no_jax():
    """The modules of the stage-3 slice import neither jax nor
    aqualora_tpu."""
    mods = ["aqualora_torch.train.rob_enhance_finetune",
            "aqualora_torch.core.checkpoint", "aqualora_torch.utils.logging",
            "aqualora_torch.distort.noiser", "aqualora_torch.train.ppft_train",
            "aqualora_torch.diffusion.pipeline", "aqualora_torch.models.lora"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'aqualora_tpu'))]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_ppft_resume_latest(tmp_path):
    """PPFT checkpoint/resume (tests/test_resume.py's contract): save at
    step 2, resume "latest" to 4, only 2 more steps recorded; the resumed
    run's LoRA, mapper and metrics equal an uninterrupted 4-step run's bit
    for bit (the skipped steps' batches and draws are replayed)."""
    from aqualora_torch.train import ppft_train as pt

    def run(out, steps, *extra):
        return pt.run(pt.build_argparser().parse_args(
            ["--tiny", "--train_batch_size", "2", "--device", "cpu",
             "--output_dir", str(out), "--checkpointing_steps", "2",
             "--seed", "3", "--report_to", "none", "--max_train_steps",
             str(steps), *extra]))

    run(tmp_path / "ppft", 2)
    assert os.path.isdir(tmp_path / "ppft" / "checkpoints")
    res = run(tmp_path / "ppft", 4, "--resume_from_checkpoint", "latest")
    assert res["start_step"] == 2 and len(res["history"]) == 2
    straight = run(tmp_path / "straight", 4)
    assert res["history"] == straight["history"][2:]
    pa, pb = res["trainer"].pipe, straight["trainer"].pipe
    la, lb = pt.split_lora(pa.unet)[1], pt.split_lora(pb.unet)[1]
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert torch.equal(pa.mapper.bit_embeddings.weight,
                       pb.mapper.bit_embeddings.weight)
    with pytest.raises(ValueError, match="output_dir"):
        pt.run(pt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--resume_from_checkpoint",
             "latest"]))
