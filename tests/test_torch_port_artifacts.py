"""The port's artifact I/O and the publisher's chain against the JAX package,
on the CPU at the tiny config: the hand-written safetensors reader and
writer against the `safetensors` package, the LoRA export and import
against `aqualora_tpu.core.io` (and the SD-1.5 layout on the meta device),
the diffusers-directory loaders of PPFT and stage 1 against JAX's,
`--start_from_pretrain`, DPM-Solver++(2M) against the goldens and the
diffusers 0.24.0 transcription, the per-image generators, the tiny chain
through the CLIs, and the JAX pipeline generating from the port's files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core import io as tio
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_tpu.core import io as jio

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


def _zero_lora(tree):
    """The same tree with every LoRA leaf zero."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (np.zeros_like(v) if any(
            getattr(k, "key", None) == "lora" for k in path) else v), tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX pipeline and seeded weights (every LoRA up non-zero),
    shared by the tests below."""
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    jpipe = JPipe(jcfg.PipelineConfig.tiny())
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, 32, 32)), 5)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jpipe, params


def _tpipe(params=None):
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    if params is not None:
        pipe.load_jax_params(params)
    return pipe


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w32": torch.randn(3, 5, generator=g),
            "w16": torch.randn(7, generator=g).half(),
            "wbf": torch.randn(2, 2, 3, generator=g).bfloat16(),
            "i64": torch.randint(-2 ** 40, 2 ** 40, (4,), generator=g),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_round_trip_with_the_package(tmp_path, dtype):
    """Each way between the hand-written reader and writer and the
    `safetensors` package, for F32, F16, BF16 and I64 next to the other
    types and with metadata: the same tensors, bit for bit, and the same
    file bytes."""
    from safetensors.torch import load_file, save_file

    ts = _tensors(int(torch.tensor([], dtype=dtype).element_size()))
    ts["main"] = (torch.arange(24).reshape(2, 3, 4) * 7 - 5).to(dtype)
    meta = {"format": "pt"}     # one key: the package orders keys by hash
    ours, theirs = tmp_path / "ours.st", tmp_path / "theirs.st"
    tio.save_safetensors(ts, str(ours), metadata=meta)
    save_file(ts, str(theirs), metadata=meta)
    assert ours.read_bytes() == theirs.read_bytes()
    for got in (load_file(str(ours)), tio.load_safetensors(str(theirs))):
        assert set(got) == set(ts)
        for k, v in ts.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k
    assert tio.read_safetensors_header(str(theirs))[1] == meta


def _write_raw(path, header, data: bytes):
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + data)


@pytest.mark.parametrize("case", ["overlap", "past_the_end", "wrong_size",
                                  "header_past_file", "not_json"])
def test_safetensors_rejects_a_malformed_header(tmp_path, case):
    """Offsets that overlap, run past the data or disagree with the dtype
    and shape, a header length past the file, a header that is not JSON."""
    p = tmp_path / "bad.safetensors"
    f32 = lambda lo, hi, shape=(2,): {"dtype": "F32", "shape": list(shape),
                                      "data_offsets": [lo, hi]}
    if case == "overlap":
        _write_raw(p, {"a": f32(0, 8), "b": f32(4, 12)}, bytes(12))
    elif case == "past_the_end":
        _write_raw(p, {"a": f32(0, 8), "b": f32(8, 16)}, bytes(12))
    elif case == "wrong_size":
        _write_raw(p, {"a": f32(0, 8, (3,))}, bytes(8))
    elif case == "header_past_file":
        p.write_bytes((1000).to_bytes(8, "little") + b"{}")
    else:
        p.write_bytes((4).to_bytes(8, "little") + b"{no}")
    with pytest.raises(ValueError):
        tio.load_safetensors(str(p))


# ---------------------------------------------------------------------------
# the LoRA layout
# ---------------------------------------------------------------------------

def test_lora_export_matches_jax(tiny):
    """The port's export of the tiny U-Net's LoRA equals
    `aqualora_tpu.core.io.export_lora_safetensors` on the same weights: the
    same keys and exactly the same arrays."""
    jpipe, params = tiny
    want = jio.export_lora_safetensors(params["unet"], jpipe.config.unet)
    got = tio.export_lora_safetensors(_tpipe(params).unet,
                                      tcfg.PipelineConfig.tiny().unet)
    assert set(got) == set(want) and len(want) == 96
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert max(np.abs(v).max() for k, v in want.items() if ".up." in k) > 0


def test_lora_import_of_a_jax_written_file(tiny, tmp_path):
    """A file JAX writes (through the `safetensors` package), imported by
    the port into a U-Net whose LoRA is zero, gives what JAX's import
    gives; the import is strict about keys and shapes."""
    jpipe, params = tiny
    path = str(tmp_path / tio.LORA_FILE)
    jio.export_lora_safetensors(params["unet"], jpipe.config.unet, path)
    want = jio.import_lora_safetensors(_zero_lora(params["unet"]),
                                       jpipe.config.unet,
                                       jio.load_safetensors(path))
    pipe = _tpipe(dict(params, unet=_zero_lora(params["unet"])))
    cfg = tcfg.PipelineConfig.tiny().unet
    state = tio.load_safetensors(path)
    tio.import_lora_safetensors(pipe.unet, cfg, state)
    want_t = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, want))
    got = pipe.unet.state_dict()
    assert set(got) == set(want_t)
    for k, v in want_t.items():
        assert torch.equal(got[k], v), k
    key = next(iter(state))
    with pytest.raises(KeyError):
        tio.import_lora_safetensors(pipe.unet, cfg, {k: v for k, v in
                                                    state.items() if k != key})
    with pytest.raises(ValueError):
        tio.import_lora_safetensors(pipe.unet, cfg,
                                    dict(state, **{key: state[key][:1]}))


def test_sd15_lora_layout_on_meta():
    """At SD-1.5's widths and rank 320, built on the meta device: the port's
    384 keys and shapes are `_lora_torch_key` over `unet_module_keys` of the
    JAX package, in torch layout; 135,659,520 parameters."""
    from aqualora_torch.models.unet import UNet2DConditionModel

    cfg = tcfg.PipelineConfig.sd15(320).unet
    with torch.device("meta"):
        unet = UNet2DConditionModel(cfg)
    state = tio.export_lora_safetensors(unet, cfg)
    jkeys = [jio._lora_torch_key(mk, w) for mk in
             jio.unet_module_keys(jcfg.PipelineConfig.sd15(320).unet)
             for w in ("down", "up")]
    assert list(state) == jkeys and len(jkeys) == 384
    assert sum(v.numel() for v in state.values()) == 135_659_520
    for k, v in state.items():
        rank_dim = 0 if ".down." in k else 1
        assert v.shape[rank_dim] == 320, k
        assert v.dim() == (4 if ("proj_in" in k or "proj_out" in k) else 2), k


# ---------------------------------------------------------------------------
# diffusers checkpoints and the stage-1 hand-off
# ---------------------------------------------------------------------------

def _clip_diffusers_key(k):
    """The inverse of the loaders' CLIP renames."""
    if k.startswith(("token_embedding", "position_embedding")):
        return "text_model.embeddings." + k
    if k.startswith("layers."):
        return "text_model.encoder." + k
    return "text_model." + k


def _write_diffusers_dir(root, params):
    """A diffusers-layout checkpoint of JAX weights, written with the
    `safetensors` package: the U-Net without its LoRA, the VAE, and the
    text encoder under diffusers' CLIP names with `position_ids`."""
    from safetensors.numpy import save_file

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
        save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
                  os.path.join(root, sub))


def test_diffusers_directory_loaders_match_jax(tiny, tmp_path):
    """`_load_sd_checkpoint` (PPFT) and `_load_vae_params` (stage 1) on a
    directory the test writes, in both packages: the same weights, the
    LoRA kept at its values, and a missing or extra key refused."""
    from aqualora_torch.train import latent_wm_pretrain as ts1
    from aqualora_torch.train import ppft_train as tpt
    from aqualora_tpu.train import latent_wm_pretrain as js1
    from aqualora_tpu.train import ppft_train as jpt

    jpipe, params = tiny
    ckpt = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, 32, 32)), 6)
    ckpt = jax.tree_util.tree_map(np.asarray, ckpt)
    root = str(tmp_path / "sd")
    _write_diffusers_dir(root, ckpt)
    want = jpt._load_sd_checkpoint(root, params)

    pipe = _tpipe(params)
    lora_before = {k: v.clone() for k, v in
                   tpt.split_lora(pipe.unet)[1].items()}
    tpt._load_sd_checkpoint(root, pipe)
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae),
                         ("text_encoder", pipe.clip)):
        ref = jax_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                         want[name]))
        got = module.state_dict()
        assert set(got) == set(ref), name
        for k, v in ref.items():
            assert torch.equal(got[k], v), (name, k)
    for k, v in lora_before.items():        # the LoRA: the template's values
        assert torch.equal(pipe.unet.state_dict()[k], v), k
    before = jax_params_to_torch(params["vae"])      # the load replaced it
    assert all(not torch.equal(v, before[k]) for k, v in
               pipe.vae.state_dict().items() if v.dim() > 1)

    vae_t = _tpipe().vae
    ts1._load_vae_params(root, vae_t)
    vae_j = js1._load_vae_params(root, params["vae"])
    for k, v in jax_params_to_torch(jax.tree_util.tree_map(
            np.asarray, vae_j)).items():
        assert torch.equal(vae_t.state_dict()[k], v), k

    vae_file = os.path.join(root, "vae/diffusion_pytorch_model.safetensors")
    state = tio.load_safetensors(vae_file)
    for bad in ({k: v for k, v in list(state.items())[1:]},
                dict(state, extra=torch.zeros(1))):
        tio.save_safetensors(bad, vae_file)
        with pytest.raises(ValueError):
            ts1._load_vae_params(root, vae_t)
    with pytest.raises(FileNotFoundError):
        tpt._load_sd_checkpoint(str(tmp_path / "none"), pipe)


def test_start_from_pretrain_reads_a_stage1_file(tmp_path):
    """A tiny stage-1 run's `pretrained_latentwm.pt`, read by the PPFT
    trainer's `--start_from_pretrain` under bf16: the SecretEncoder and the
    SecretDecoder (BatchNorm statistics included) equal the file bit for
    bit and stay float32."""
    from aqualora_torch.train import latent_wm_pretrain as ts1
    from aqualora_torch.train import ppft_train as tpt

    ts1.run(ts1.build_argparser().parse_args(
        ["--tiny", "--max_train_steps", "1", "--batch_size", "2", "--device",
         "cpu", "--output_dir", str(tmp_path)]))
    path = str(tmp_path / "pretrained_latentwm.pt")
    art = torch.load(path, weights_only=True)
    tr = tpt.build_trainer(tpt.build_argparser().parse_args(
        ["--tiny", "--device", "cpu", "--mixed_precision", "bf16",
         "--start_from_pretrain", path]))
    for module, want in ((tr.sec_encoder, art["sec_encoder"]),
                         (tr.msgdecoder, art["sec_decoder"])):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert tr.sec_encoder.conv_out.weight.dtype == torch.float32
    assert tr.sec_encoder.conv_out.weight.abs().max() > 0   # trained, not init
    assert not tr.msgdecoder.training


# ---------------------------------------------------------------------------
# DPM-Solver++(2M) and the per-image generators
# ---------------------------------------------------------------------------

MU = 3.0


def _schedule():
    from aqualora_torch.diffusion.schedule import NoiseSchedule
    return NoiseSchedule.create(tcfg.ScheduleConfig(), "cpu")


def _optimal_denoise(sched):
    """`optimal_denoise` of tests/test_samplers.py in torch: E[eps | x_t]
    for x0 ~ N(mu, 1), float32."""
    acp_all = sched.alphas_cumprod
    t_max = sched.config.num_train_timesteps - 1

    def denoise(x, t):
        t_lo = torch.clamp(torch.floor(t).long(), 0, t_max)
        t_hi = torch.clamp(t_lo + 1, 0, t_max)
        frac = t - t_lo
        acp = (1 - frac) * acp_all[t_lo] + frac * acp_all[t_hi]
        alpha, sig = torch.sqrt(acp), torch.sqrt(1 - acp)
        x0_mean = (MU * sig ** 2 + alpha * x) / (alpha ** 2 + sig ** 2)
        return (x - alpha * x0_mean) / sig

    return denoise


@pytest.mark.parametrize("steps", [8, 25])
def test_dpms_m_matches_the_goldens(steps):
    """`sample("dpms_m")` on the analytic denoiser against
    tests/goldens/sampler_goldens.npz, z drawn from PRNGKey(123) as the
    goldens were, within 1e-5."""
    from aqualora_torch.diffusion.samplers import sample

    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "sampler_goldens.npz"))[f"dpms_m_{steps}"]
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(123), (8, 4)))
    sched = _schedule()
    out = sample("dpms_m", sched, _optimal_denoise(sched), torch.tensor(z),
                 steps)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), golden, rtol=0, atol=1e-5)
    assert np.abs(golden - z).max() > 1.0             # it moved


@pytest.mark.parametrize("steps", [8, 25])
def test_dpms_m_matches_diffusers_transcription(steps):
    """Against the float64 numpy transcription of diffusers 0.24.0's
    DPMSolverMultistepScheduler.step of tests/test_samplers.py:197-245,
    within its 1e-3: second order from the second step, the final step
    first order below 15 steps, the final boundary at alphas_cumprod[0]."""
    from aqualora_torch.diffusion.samplers import sample

    sched = _schedule()
    denoise = _optimal_denoise(sched)
    acp_full = sched.alphas_cumprod.double().numpy()
    z0 = np.random.RandomState(2).randn(8, 1).astype(np.float32)

    ts = np.linspace(0, 999, steps + 1).round()[::-1][:-1].astype(np.int64)
    sig_k = np.sqrt((1 - acp_full) / acp_full)
    sig = np.append(sig_k[ts], sig_k[0])
    alpha_t = 1.0 / np.sqrt(1 + sig ** 2)
    sigma_t = sig * alpha_t
    lam = np.log(alpha_t / sigma_t)
    x = z0.astype(np.float64)
    m = []
    for i, t in enumerate(ts):
        e = denoise(torch.tensor(x, dtype=torch.float32),
                    torch.tensor(float(t))).double().numpy()
        m.append((x - sigma_t[i] * e) / alpha_t[i])
        h = lam[i + 1] - lam[i]
        if i == 0 or (i == steps - 1 and steps < 15):
            x = (sigma_t[i + 1] / sigma_t[i]) * x \
                - alpha_t[i + 1] * (np.exp(-h) - 1.0) * m[-1]
        else:
            r0 = (lam[i] - lam[i - 1]) / h
            d = m[-1] + 0.5 * (m[-1] - m[-2]) / r0
            x = (sigma_t[i + 1] / sigma_t[i]) * x \
                - alpha_t[i + 1] * (np.exp(-h) - 1.0) * d
    out = sample("dpms_m", sched, denoise, torch.tensor(z0), steps)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-3)


def test_per_image_generators(tiny):
    """With one generator per image, row i of the initial latent is the B1
    draw of generator i, whatever the batch; the same generators give the
    same images twice; a list of the wrong length is refused."""
    from aqualora_torch.diffusion import pipeline as pl

    drawn = []
    draw = pl.batch_randn
    pipe = _tpipe(tiny[1])
    gen = pipe.make_generate(num_steps=2, sampler="dpms_m", height=32,
                             width=32)
    ids = np.zeros((3, 77), np.int32)
    gens = lambda: [torch.Generator().manual_seed(40 + i) for i in range(3)]
    pl.batch_randn = lambda *a, **k: drawn.append(draw(*a, **k)) or drawn[-1]
    try:
        first = gen(ids, ids, 7.5, generator=gens())
        again = gen(ids, ids, 7.5, generator=gens())
        gen(ids[1:2], ids[1:2], 7.5, generator=gens()[1:2])
    finally:
        pl.batch_randn = draw
    assert torch.equal(first, again)
    for i in range(3):
        b1 = torch.randn((1, 16, 16, 4),
                         generator=torch.Generator().manual_seed(40 + i))
        assert torch.equal(drawn[0][i:i + 1], b1), i
    assert torch.equal(drawn[2], drawn[0][1:2])
    with pytest.raises(ValueError):
        gen(ids, ids, 7.5, generator=gens()[:2])


def test_make_generate_defaults_to_dpms_m():
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline

    import inspect
    sig = inspect.signature(StableDiffusionPipeline.make_generate)
    assert sig.parameters["sampler"].default == "dpms_m"
    ids = np.zeros((1, 77), np.int32)
    # a name outside the menu is refused when the call runs
    generate = _tpipe().make_generate(num_steps=1, sampler="dpm_fast",
                                      height=32, width=32)
    with pytest.raises(ValueError, match="unknown sampler"):
        generate(ids, ids, 7.5, z=torch.zeros(1, 4, 4, 4))


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _cli(module, *args):
    """What `python -m <module> ARGS` runs (`main`), in this process."""
    module.run(module.build_argparser().parse_args(list(args)))


def test_tiny_chain_through_the_clis(tmp_path, capsys):
    """Stage 1, then PPFT from its file with --output_dir and the final
    sanity inference, each through its CLI's entry point on the CPU: the
    three artifacts are written in their formats, the sanity inference
    reads them back and prints a bit accuracy, a fresh pipeline loads them,
    and a bf16 PPFT trainer resumes from them (`--resume_from_lora`) in
    float32."""
    from aqualora_torch.train import latent_wm_pretrain as ts1
    from aqualora_torch.train import ppft_train as tpt

    s1_dir, out = tmp_path / "s1", tmp_path / "ppft"
    _cli(ts1, "--tiny", "--max_train_steps", "2", "--batch_size", "2",
         "--device", "cpu", "--output_dir", str(s1_dir))
    capsys.readouterr()
    _cli(tpt, "--tiny", "--max_train_steps", "2", "--train_batch_size", "2",
         "--device", "cpu", "--mixed_precision", "bf16",
         "--start_from_pretrain", str(s1_dir / "pretrained_latentwm.pt"),
         "--output_dir", str(out), "--validation_prompt", "a photo",
         "--num_validation_images", "2")
    stdout = capsys.readouterr().out
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2
    sanity = [ln for ln in stdout.splitlines()
              if ln.startswith("final sanity inference: bit_accuracy ")]
    assert len(sanity) == 1
    assert 0.0 <= float(sanity[0].split()[-1]) <= 1.0

    lora = tio.load_safetensors(str(out / tio.LORA_FILE))
    cfg = tcfg.PipelineConfig.tiny()
    assert list(lora) == sorted(tio.lora_key_map(cfg.unet))
    assert all(v.dtype == torch.float32 for v in lora.values())
    mapper = tio.load_safetensors(str(out / tio.MAPPER_FILE))
    assert list(mapper) == ["bit_embeddings.weight"]
    assert mapper["bit_embeddings.weight"].dtype == torch.float32
    dec = torch.load(out / tpt.MSGDECODER_FILE, weights_only=True)
    assert any("running_var" in k for k in dec)

    pipe = _tpipe()
    pipe.load_watermark_lora(str(out))
    got = tpt.split_lora(pipe.unet)[1]
    for tkey, name in tio.lora_key_map(cfg.unet).items():
        assert torch.equal(got[name], lora[tkey]), name
    ups = [v for k, v in lora.items() if ".up." in k]
    assert max(v.abs().max() for v in ups) > 0        # the LoRA trained
    assert torch.equal(pipe.mapper.bit_embeddings.weight,
                       mapper["bit_embeddings.weight"])
    # --resume_from_lora starts a PPFT run from the saved pair, float32
    tr = tpt.build_trainer(tpt.build_argparser().parse_args(
        ["--tiny", "--device", "cpu", "--mixed_precision", "bf16",
         "--resume_from_lora", str(out)]))
    got = tpt.split_lora(tr.pipe.unet)[1]
    for tkey, name in tio.lora_key_map(cfg.unet).items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], lora[tkey]), name
    assert torch.equal(tr.pipe.mapper.bit_embeddings.weight,
                       mapper["bit_embeddings.weight"])


def test_bf16_pipeline_keeps_the_loaded_lora_float32(tiny, tmp_path):
    """A bf16 pipeline holds its LoRA and MapperNet in float32, as the JAX
    package keeps every parameter: `load_watermark_lora` keeps the saved
    float32 values bit for bit (no bf16 rounding before the fold), and the
    fold adds the float32 delta to the bf16 base weight."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.lora import LoRALinear
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train import ppft_train as tpt

    jpipe, params = tiny
    tpt.save_artifacts(str(tmp_path), _tpipe(params), SecretDecoder(
        jpipe.config.watermark.msg_bits, tcfg.EfficientNetConfig.tiny(),
        device="cpu"))
    lora = tio.load_safetensors(str(tmp_path / tio.LORA_FILE))
    mapper = tio.load_safetensors(str(tmp_path / tio.MAPPER_FILE))
    cfg = tcfg.PipelineConfig.tiny()
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device="cpu")
    pipe.load_watermark_lora(str(tmp_path))
    got = tpt.split_lora(pipe.unet)[1]
    for tkey, name in tio.lora_key_map(cfg.unet).items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], lora[tkey]), name
    # the values do not survive a bf16 rounding: the rule is what keeps them
    assert any(not torch.equal(v, v.bfloat16().float()) for v in lora.values())
    emb = pipe.mapper.bit_embeddings.weight
    assert emb.dtype == torch.float32
    assert torch.equal(emb, mapper["bit_embeddings.weight"])
    assert pipe.unet.conv_in.weight.dtype == torch.bfloat16

    site = next(m for m in pipe.unet.modules()
                if isinstance(m, LoRALinear) and m.lora is not None)
    base = site.weight.detach().clone()
    msg = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, cfg.watermark.msg_bits).astype(np.float32))
    diag = (pipe.message_scale(msg[None])[0]
            * cfg.unet.lora.alpha_scale)
    want = (base.float() + (site.lora.up.weight * diag)
            @ site.lora.down.weight).bfloat16()
    pipe.fold_message(msg)
    assert site.weight.dtype == torch.bfloat16
    assert torch.equal(site.weight, want)


def test_jax_pipeline_generates_from_the_port_artifacts(tiny, tmp_path):
    """The port writes the LoRA and mapper; the JAX pipeline reads them
    into weights whose LoRA is zero, and a fresh port pipeline loads them
    the same way.  One message folded on each side, then dpms_m for 3 steps
    (so a second-order step runs) at CFG 7.5 from the same initial latent:
    the images agree within 2e-3, the tolerance of the DDIM slice test
    (tests/test_torch_port_pipeline.py)."""
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train import ppft_train as tpt

    jpipe, params = tiny
    src = _tpipe(params)
    tpt.save_artifacts(str(tmp_path), src, SecretDecoder(
        jpipe.config.watermark.msg_bits, tcfg.EfficientNetConfig.tiny(),
        device="cpu"))

    base = dict(params, unet=_zero_lora(params["unet"]),
                mapper={"bit_embeddings": np.zeros_like(
                    params["mapper"]["bit_embeddings"])})
    state = jio.load_safetensors(str(tmp_path / tio.LORA_FILE))
    jparams = dict(base, unet=jio.import_lora_safetensors(
        base["unet"], jpipe.config.unet, state), mapper={
        "bit_embeddings": jio.load_safetensors(str(
            tmp_path / tio.MAPPER_FILE))["bit_embeddings.weight"]})

    rng = np.random.default_rng(9)
    cfg = jpipe.config
    msg = rng.integers(0, 2, cfg.watermark.msg_bits).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                     (2, 16, 16, 4)))
    folded = jpipe.fold_message(jparams, jnp.asarray(msg))
    j_img = np.asarray(jpipe.make_generate(
        num_steps=3, sampler="dpms_m", height=32, width=32)(
        folded, jnp.asarray(ids), jnp.asarray(neg), key, 7.5, None))

    tpipe = _tpipe(base)
    tpipe.load_watermark_lora(str(tmp_path))
    tpipe.fold_message(torch.from_numpy(msg))
    t_img = tpipe.make_generate(num_steps=3, height=32, width=32)(
        ids, neg, 7.5, z=torch.tensor(z)).numpy()
    assert t_img.shape == j_img.shape == (2, 32, 32, 3)
    assert j_img.std() > 0.1
    np.testing.assert_allclose(t_img, j_img, atol=2e-3)
    # the LoRA and the mapper matter: without them the image differs
    plain = _tpipe(base)
    plain.fold_message(torch.from_numpy(msg))
    other = plain.make_generate(num_steps=3, height=32, width=32)(
        ids, neg, 7.5, z=torch.tensor(z)).numpy()
    assert np.abs(other - t_img).max() > 1e-2
