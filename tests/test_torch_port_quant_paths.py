"""The port's w8a8 int8 paths against the JAX package's, on the CPU at the
tiny config: `simple_sample`'s int8 modes (`eval/utils_eval.py`) and the
PPFT loss under `--teacher_int8` (`train/ppft_train.py`).  The quantizer,
the products, the sites and the U-Net are in tests/test_torch_port_quant.py,
whose fixtures and helpers these tests share.  The two files are apart so
that the tier-1 run's workers take them in parallel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.ops import quant as tq
# the module fixtures (`_one_torch_thread` autouse) by import, and helpers
from test_torch_port_quant import (  # noqa: F401
    KEY, _fill, _np, _one_torch_thread, _t, jax_int8, pipe_params)


# simple_sample, tiny, float32, 2 DPM-Solver++ steps at 32 px, the same
# weights and latents.  The int8 sampler is chaotic at this size: moving its
# initial latent by 2^-18 of itself moves the port's own images by as much
# as they differ from JAX's (measured, +2^-18: conv 0.278 against 0.285,
# all+vae 0.409 against 0.397, vae 0.0165 against 0.019 in max |d|; means
# within 1.7x), because each flipped activation code cascades.  The images
# are held within SAMPLE_FACTOR of that change; the quantized weights the
# pipeline samples with are held to JAX's bit for bit.
SAMPLE_FACTOR = 3.0


def _jax_quantized(params, jax_int8, mode):
    """JAX's simple_sample conversion for `mode`
    (`aqualora_tpu/eval/utils_eval.py:260-278`), eagerly (see `jax_int8`)."""
    t = set(mode.split("+"))
    out = dict(params)
    if t & {"conv", "dense", "all"}:
        out["unet"] = jax_int8("unet", bool(t & {"conv", "all"}),
                               bool(t & {"dense", "all"}))
    if "vae" in t:
        out["vae"] = jax_int8("vae")
    return out


@pytest.mark.parametrize("mode", ["conv", "all+vae", "vae"])
def test_simple_sample_int8_modes_match_jax(pipe_params, jax_int8, mode):
    """`simple_sample(int8=mode)` samples with exactly the int8 U-Net and
    VAE that JAX's conversion of the mode gives (state dicts equal bit for
    bit), and its images are within SAMPLE_FACTOR of its own sensitivity
    of JAX's on the same weights and initial latents (the port replays
    JAX's draws); an unknown mode raises ValueError."""
    from aqualora_torch.diffusion import pipeline as tpl
    from aqualora_torch.eval import utils_eval as tu
    from aqualora_tpu.eval import utils_eval as ju
    from test_torch_port_eval import _jax_latents, _Recorder, _Replay

    prompts = ["a cat", "a dog"]
    kw = dict(seeds=[3], num_inference_steps=2, batch_size=2, resolution=32)
    jrec = _Recorder(ju.images_to_pil)
    trec = _Recorder(tu.images_to_uint8)
    states = []
    make = tpl.StableDiffusionPipeline.make_generate

    def recorded(pipe, *a, **k):
        states.append({"unet": pipe.unet.state_dict(),
                       "vae": pipe.vae.state_dict()})
        return make(pipe, *a, **k)
    latents = _jax_latents([3], 2, 2)
    moved = [z * np.float32(1 + 2 ** -18) for z in latents]
    jq_params = _jax_quantized(pipe_params, jax_int8, mode)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ju, "images_to_pil", jrec)
        mp.setattr(tu, "images_to_uint8", trec)
        mp.setattr(tpl, "batch_randn", _Replay(latents + moved))
        mp.setattr(tpl.StableDiffusionPipeline, "make_generate", recorded)
        ju.simple_sample(None, "dpms_m", prompts,
                         config=jcfg.PipelineConfig.tiny(), params=jq_params,
                         **kw)
        for _ in range(2):
            tu.simple_sample(None, "dpms_m", prompts,
                             config=tcfg.PipelineConfig.tiny(),
                             params={k: jax_params_to_torch(v)
                                     for k, v in pipe_params.items()},
                             int8=mode, device="cpu", **kw)
    for name in ("unet", "vae"):
        want = jax_params_to_torch(jq_params[name])
        got = states[0][name]
        assert set(got) == set(want), name
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert any(v.dtype == torch.int8 for st in states[0].values()
               for v in st.values())
    ref, (got, *own) = jrec.seen[0], trec.seen
    err = np.abs(got - ref)
    wobble = np.stack([np.abs(o - got) for o in own])
    assert err.max() <= SAMPLE_FACTOR * wobble.max() + 1e-4
    assert err.mean() <= SAMPLE_FACTOR * wobble.mean(
        axis=(1, 2, 3, 4)).max() + 1e-5
    with pytest.raises(ValueError, match="int8 mode 'conv\\+int4'"):
        tu.simple_sample(None, "dpms_m", prompts, int8="conv+int4",
                         device="cpu", **kw)


# The --teacher_int8 loss, port against JAX (float32), at the seed-5
# pipeline weights: measured 0.3581330478 against 0.3581330180 (8e-8
# relative), where the int8 teacher moves the loss from the float
# teacher's 0.3577060 by 1.2e-3.  JAX quantizes in its jitted step, where
# some scales come out one ulp from the written division (`jax_int8`); at
# the seed-11 U-Net of `pipe_params` that flips an activation of the
# teacher pass and the two losses differ by 1.5e-3 relative, as much as the
# quantization moves them.
PPFT_RTOL = 1e-5


def test_teacher_int8_ppft_loss_matches_jax():
    """One PPFT loss with `--teacher_int8` (the teacher's conv sites in
    w8a8) against JAX's `make_loss_fn(teacher_int8=True)` on the same
    weights and draws (float32, 32 px: the fused injection), within the
    stated tolerance; it differs from the float teacher's loss.  The port
    quantizes the teacher once (`int8_twin`): after a training step that
    moves the LoRA, a fresh quantization of the frozen weights gives the
    twin's teacher output bit for bit."""
    import flax.traverse_util as ftu

    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretEncoder as TEnc
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc
    from aqualora_tpu.train import ppft_train as jt

    cfg = jcfg.PipelineConfig.tiny()
    bits, grid = cfg.watermark.msg_bits, cfg.watermark.secret_grid
    jpipe = JPipe(cfg)
    pipe_params = _np(_fill(jax.eval_shape(lambda: jpipe.init_params(
        KEY, 32, 32)), 5))
    jsec = JEnc(bits, grid, 16, 4)
    sec_params = _np(_fill(jax.eval_shape(lambda: jsec.init(
        KEY, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1, bits)))), 1)["params"])
    base_flat, lora_flat = jt.split_lora(pipe_params["unet"])
    trainable = {"lora": ftu.unflatten_dict(lora_flat),
                 "mapper": pipe_params["mapper"]}
    frozen = {"vae": pipe_params["vae"],
              "text_encoder": pipe_params["text_encoder"],
              "sec_encoder": sec_params}
    rng = np.random.default_rng(2)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(42)
    fn = jax.jit(jt.make_loss_fn(jpipe, jsec, bits, teacher_int8=True))
    j_loss = float(fn(trainable, base_flat, frozen, jnp.asarray(pixels),
                      jnp.asarray(ids), key)[0])

    kmsg, kvae, knoise, kt = jax.random.split(key, 7)[:4]
    shape = (2, 16, 16, 4)
    nchw = lambda a: _t(a).permute(0, 3, 1, 2).contiguous()
    draws = tt.Draws(
        _t(jax.random.bernoulli(kmsg, 0.5, (2, bits)).astype(jnp.float32)),
        nchw(jax.random.normal(kvae, shape, jnp.float32)),
        nchw(jax.random.normal(knoise, shape)),
        _t(jax.random.randint(kt, (2,), 0,
                              cfg.schedule.num_train_timesteps)).long())
    tpipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu",
                                    int8="conv")
    tpipe.load_jax_params(pipe_params)
    teacher = tpipe.int8_twin()
    tsec = TEnc(bits, grid, 16, 4)
    tsec.load_state_dict(jax_params_to_torch(sec_params), strict=True)
    tsec.requires_grad_(False)
    loss = tt.make_loss_fn(tpipe, tsec, teacher_unet=teacher)(
        pixels, ids, draws)[0].item()
    float_loss = tt.make_loss_fn(tpipe, tsec)(pixels, ids, draws)[0].item()
    np.testing.assert_allclose(loss, j_loss, rtol=PPFT_RTOL)
    assert abs(loss - float_loss) > 100 * PPFT_RTOL * loss

    groups = tt.trainable_groups(tpipe)
    optimizer, scheduler = tt.make_optimizer(groups, 1e-2, 0, 10)
    step = tt.make_train_step(tpipe, tsec, optimizer, scheduler, 1.0,
                              teacher_unet=teacher)
    before = [p.detach().clone() for p in groups["lora"]]
    step(pixels, ids, draws)
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     groups["lora"]))
    fresh = tq.quantized_copy(tpipe.unet)
    x = nchw(np.random.default_rng(3).standard_normal(shape).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (2, 77, cfg.unet.cross_attention_dim)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(teacher(x, draws.t, ctx, None),
                           fresh(x, draws.t, ctx, None))
