"""The text-encoder LoRA of the port (`--train_text_encoder`) against the
JAX package, on the CPU at the tiny configuration: the key layout, the
export/import round trip through the port's safetensors, `encode_prompt`
through the LoRA, and one PPFT step that trains it.

The JAX side runs jitted on the CPU (its injection takes the Pallas kernel
in interpret mode); the port runs the plain versions of its kernels (the
card's are held against them by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch

KEY = jax.random.PRNGKey(0)
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host, and a thread pool as wide as the host
    in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


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


def _te_configs():
    import dataclasses

    import aqualora_torch.core.config as tcfg
    import aqualora_tpu.core.config as jcfg
    j = jcfg.PipelineConfig.tiny()
    t = tcfg.PipelineConfig.tiny()
    return (dataclasses.replace(j, clip=j.clip.with_lora(4)),
            dataclasses.replace(t, clip=t.clip.with_lora(4)))


@pytest.fixture(scope="module")
def te_pipeline():
    """The JAX tiny pipeline with the text-encoder LoRA and its seeded
    parameters at 32 px (every LoRA up non-zero)."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    jc, _ = _te_configs()
    jpipe = StableDiffusionPipeline(jc)
    return jpipe, _fill(jax.eval_shape(
        lambda: jpipe.init_params(KEY, 32, 32)), 0)


# ---------------------------------------------------------------------------
# the text-encoder LoRA
# ---------------------------------------------------------------------------

def test_te_lora_keys_round_trip_and_encode_prompt(tmp_path, te_pipeline):
    """The key layout equals `te_lora_torch_keys`, one CLIP tensor each;
    export, the port's safetensors and import give the tensors back bit for
    bit; `encode_prompt` through the text-encoder LoRA within 1e-5 of
    JAX's."""
    from aqualora_torch.core import io as tio
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_torch.train.ppft_train import split_lora
    from aqualora_tpu.core import io as jio
    from aqualora_tpu.core.config import CLIPTextConfig

    for clip_cfg in (CLIPTextConfig.tiny(), CLIPTextConfig.sd15()):
        got = tio.te_lora_torch_keys(clip_cfg)
        want = jio.te_lora_torch_keys(clip_cfg)
        assert list(got) == list(want)
        for k, path in want.items():
            assert got[k] == ".".join(path).replace("layers_", "layers.") \
                .replace("kernel", "weight")
    jc, tc = _te_configs()
    jpipe, params = te_pipeline
    tpipe = TPipe(tc, device="cpu")
    tpipe.load_jax_params(_np(params))
    state = tio.export_te_lora_safetensors(tpipe.clip, tc.clip)
    assert len(state) == len(split_lora(tpipe.clip)[1]) == 2 * 2 * 6
    want = jio.export_te_lora_safetensors(params["text_encoder"], jc.clip)
    assert set(state) == set(want)
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), want[k])
    path = str(tmp_path / "te.safetensors")
    tio.save_safetensors(state, path)
    fresh = TPipe(tc, device="cpu")
    tio.import_te_lora_safetensors(fresh.clip, tc.clip,
                                   tio.load_safetensors(path))
    for k, p in split_lora(fresh.clip)[1].items():
        assert torch.equal(p, dict(tpipe.clip.named_parameters())[k]), k
    ids = np.random.default_rng(6).integers(0, tc.clip.vocab_size, (2, 77))
    got = tpipe.encode_prompt(ids).numpy()
    want = np.asarray(jpipe.encode_prompt(params, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    plain = TPipe(tc, device="cpu")
    plain.load_jax_params(_np(params))
    for p in split_lora(plain.clip)[1].values():
        p.data.zero_()
    assert np.abs(plain.encode_prompt(ids).numpy() - got).max() > 1e-3


@pytest.fixture(scope="module")
def te_step(te_pipeline):
    """One PPFT step of the tiny config with --train_text_encoder through
    both trainers, at 32 px (the fused injection), JAX's draws handed to
    the port."""
    import flax.traverse_util as tu
    import optax

    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_torch.models.watermark import SecretEncoder as TEnc
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc
    from aqualora_tpu.train import ppft_train as jt

    jc, tc = _te_configs()
    bits, grid = jc.watermark.msg_bits, jc.watermark.secret_grid
    jpipe, params = te_pipeline
    jsec = JEnc(bits, grid, 16, 4)
    sec_params = _fill(jax.eval_shape(lambda: jsec.init(
        KEY, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1, bits)))), 1)["params"]
    base_flat, lora_flat = jt.split_lora(params["unet"])
    te_base, te_lora = jt.split_lora(params["text_encoder"])
    trainable = {"lora": tu.unflatten_dict(lora_flat),
                 "mapper": params["mapper"],
                 "te_lora": tu.unflatten_dict(te_lora)}
    frozen = {"vae": params["vae"], "text_encoder": params["text_encoder"],
              "sec_encoder": sec_params, "text_encoder_base": te_base}
    rng = np.random.default_rng(2)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, jc.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(42)
    lr_fn = jt.cosine_with_warmup_lr_end(LR, 0, 10, 0.0)
    adamw = lambda: optax.adamw(lr_fn, weight_decay=1e-2)   # noqa: E731
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, state, params=None: (u, u))
    tx = optax.chain(record, optax.multi_transform(
        {"lora": optax.chain(optax.clip_by_global_norm(1.0), adamw()),
         "mapper": adamw()},
        {"lora": "lora", "mapper": "mapper", "te_lora": "lora"}))
    j_step = jt.make_train_step(jpipe, jsec, tx, bits,
                                train_text_encoder=True)
    j_new, j_state, j_metrics = j_step(trainable, tx.init(trainable),
                                       base_flat, frozen, jnp.asarray(pixels),
                                       jnp.asarray(ids), key)
    kmsg, kvae, knoise, kt = jax.random.split(key, 7)[:4]
    shape = (2, 16, 16, 4)
    draws = tt.Draws(
        torch.from_numpy(np.array(jax.random.bernoulli(
            kmsg, 0.5, (2, bits)).astype(jnp.float32))),
        _nchw(jax.random.normal(kvae, shape, jnp.float32)),
        _nchw(jax.random.normal(knoise, shape)),
        torch.from_numpy(np.array(jax.random.randint(
            kt, (2,), 0, jc.schedule.num_train_timesteps))).long())
    tpipe = TPipe(tc, device="cpu")
    tpipe.load_jax_params(_np(params))
    tsec = TEnc(bits, grid, 16, 4)
    tsec.load_state_dict(jax_params_to_torch(_np(sec_params)), strict=True)
    tsec.requires_grad_(False)
    groups = tt.trainable_groups(tpipe)
    assert set(groups) == {"lora", "mapper", "te_lora"}
    t_loss, _ = tt.make_loss_fn(tpipe, tsec, train_text_encoder=True)(
        pixels, ids, draws)
    t_loss.backward()
    t_grads = {f"te.{n}": p.grad.clone()
               for n, p in tt.split_lora(tpipe.clip)[1].items()}
    t_grads.update({n: p.grad.clone()
                    for n, p in tt.split_lora(tpipe.unet)[1].items()})
    j_grads = j_state[0]
    want = {f"te.{k}": v for k, v in
            jax_params_to_torch(_np(j_grads["te_lora"])).items()}
    want.update(jax_params_to_torch(_np(j_grads["lora"])))
    optimizer, scheduler = tt.make_optimizer(groups, LR, 0, 10)
    t_metrics = tt.make_train_step(tpipe, tsec, optimizer, scheduler, 1.0,
                                   train_text_encoder=True)(pixels, ids,
                                                            draws)
    new = {f"te.{k}": v for k, v in
           jax_params_to_torch(_np(j_new["te_lora"])).items()}
    new.update(jax_params_to_torch(_np(j_new["lora"])))
    got = {f"te.{n}": p.detach() for n, p in
           tt.split_lora(tpipe.clip)[1].items()}
    got.update({n: p.detach() for n, p in
                tt.split_lora(tpipe.unet)[1].items()})
    return {"j_loss": float(j_metrics["ppft_loss"]), "t_loss": t_loss.item(),
            "j_norm": float(j_metrics["grad_norm"]), "t_metrics": t_metrics,
            "t_grads": t_grads, "j_grads": want, "new": new, "got": got}


def test_te_step_loss_and_grads_match_jax(te_step):
    assert te_step["j_loss"] > 1e-3
    np.testing.assert_allclose(te_step["t_loss"], te_step["j_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(te_step["t_metrics"]["ppft_loss"]),
                               te_step["j_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(te_step["t_metrics"]["grad_norm"]),
                               te_step["j_norm"], rtol=1e-5)
    want = te_step["j_grads"]
    assert set(te_step["t_grads"]) == set(want)
    assert sum(k.startswith("te.") for k in want) == 24
    for name, g in want.items():
        g = g.numpy()
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(te_step["t_grads"][name].numpy(), g,
                                   atol=1e-4 * scale, err_msg=name)


def test_te_step_update_matches_jax(te_step):
    """The text-encoder and U-Net LoRA after one AdamW step: where the
    gradient is resolved (above 1e-3 of its leaf's max), within 1e-6 +
    1e-6 |p| (as tests/test_torch_port_train.py holds the U-Net step)."""
    for name, want in te_step["new"].items():
        want, p = want.numpy(), te_step["got"][name].numpy()
        g = np.abs(te_step["j_grads"][name].numpy())
        resolved = g > 1e-3 * g.max()
        np.testing.assert_allclose(p[resolved], want[resolved], atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        assert np.abs(p - want).max() <= 2 * LR * (1 + 1e-2), name
