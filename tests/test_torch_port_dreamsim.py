"""The port's DreamSim (`aqualora_torch/models/vit.py`, `eval/dreamsim.py`,
`ops/resize.bicubic_resize`, the ViT readers of `tools/torch_import.py`,
`eval/run_dreamsim.py`) against the JAX package, on the CPU.

- Every `BACKBONES` variant at tiny widths (dim 32, depth 2, heads 2 at
  64^2 or 56^2: T = 17 or 5, both ragged), every tap, and the 'cls' tap
  of block 11 in a 13-deep model; one depth-2 stack at full width (dim 768, 12
  heads, 224^2: T = 197, d = 64, the card's shape).  The taps within
  1e-4 * max|ref| + 1e-5.
- The antialiased bicubic resize against `jax.image.resize` at 512, 768,
  300, 32 and 64 -> 224 within 2e-5.
- The ensemble's distance (and a single backbone with the MLP head) within
  1e-5, and the tables against the originals.
- The readers on synthetic files in the published layouts: a DINO training
  checkpoint (`student` and `teacher`, `backbone.` prefixes, a head, `args`
  an argparse.Namespace), CLIP-as-DINO `.pth.tar` with `pos_drop` and
  `proj`, peft adapters as safetensors with adapter_config.json and as
  adapter_model.bin, an HF ViTMAE state dict (built with `transformers`),
  and `dreamsim_from_torch` over a cache directory; each through JAX's
  reader into JAX's model and the port's into the port's.
- `run_dreamsim --tiny --device cpu`: its distances against JAX's DreamSim
  on the port's two image sets, with the same weights; its guards.

Weights cross over through `jax_params_to_torch`; the JAX trees come from
shape trees filled with numpy (no flax init).
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
from aqualora_torch.core import io as tio
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.eval import dreamsim as tds
from aqualora_torch.models.vit import ViTB16
from aqualora_torch.ops.resize import bicubic_resize

TINY = {"dim": 32, "depth": 2, "heads": 2}
BACKBONE_PATCH = {n: kw["patch"] for n, kw in tds.BACKBONES.items()}
DIST_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tap_tol(ref) -> float:
    return 1e-4 * float(np.abs(np.asarray(ref)).max()) + 1e-5


def _fill(shapes, seed):
    """Seeded leaves for a ViT shape tree: LayerNorm scales 1 + N(0,
    0.1^2), biases and cls_token N(0, 0.1^2), pos_embed and proj N(0,
    0.02^2), kernels N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("pos_embed", "proj"):
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "bias", "cls_token"):
            base = 1.0 if name == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_vit(name, image_size, overrides, seed):
    """(JAX module, variables) of backbone `name`."""
    from aqualora_tpu.eval.dreamsim import BACKBONES
    from aqualora_tpu.models.vit import ViTB16 as JViT
    kw = {k: v for k, v in BACKBONES[name].items() if k not in ("mean", "std")}
    kw.update(overrides)
    m = JViT(image_size=image_size, **kw)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, image_size, image_size, 3)))
    return m, _fill(shapes, seed)


def _port_vit(name, image_size, overrides, variables):
    vit = ViTB16(image_size=image_size,
                 **tds.backbone_kwargs(name, overrides)).eval()
    vit.load_state_dict(jax_params_to_torch(variables["params"]), strict=True)
    return vit


def _images(seed, n, size):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


def _check_taps(jm, jvars, vit, x):
    ref = jax.jit(jm.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = vit(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(ref)
    for tap in ref:
        r = np.asarray(ref[tap])
        assert np.abs(got[tap].numpy() - r).max() <= tap_tol(r), tap


# ---------------------------------------------------------------------------
# the ViT, the resize, the distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(tds.BACKBONES))
def test_every_backbone_and_tap_matches_jax(name):
    """At 64^2 (56^2 for the 14-pixel patches, which must tile the image:
    flax pads a partial patch, torch drops it)."""
    size = 56 if BACKBONE_PATCH[name] == 14 else 64
    jm, jvars = _jax_vit(name, size, TINY, seed=len(name))
    x = _images(0, 2, size) * 2 - 1
    _check_taps(jm, jvars, _port_vit(name, size, TINY, jvars), x)


def test_cls_tap_is_block_11_in_a_deeper_model():
    over = {**TINY, "depth": 13}
    jm, jvars = _jax_vit("mae_vitl16", 32, over, seed=1)
    vit = _port_vit("mae_vitl16", 32, over, jvars)
    x = _images(1, 2, 32)
    _check_taps(jm, jvars, vit, x)
    with torch.no_grad():
        out = vit(torch.from_numpy(x).permute(0, 3, 1, 2))
        vit.blocks = vit.blocks[:12]        # block 11 the last one
        assert torch.equal(vit(torch.from_numpy(x).permute(0, 3, 1, 2))[
            "cls"], out["cls"])


def test_full_width_stack_matches_jax():
    """dim 768, 12 heads, 224^2 (T = 197, d = 64), depth 2: the shapes
    DreamSim's ViT-B/16 gives the attention kernel on the card."""
    over = {"depth": 2}
    jm, jvars = _jax_vit("clip_vitb16", 224, over, seed=2)
    _check_taps(jm, jvars, _port_vit("clip_vitb16", 224, over, jvars),
                _images(2, 2, 224))


@pytest.mark.parametrize("size", [512, 768, 300, 32, 64])
def test_bicubic_resize_matches_jax(size):
    x = _images(size, 2, size)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3),
                                      "bicubic"))
    got = bicubic_resize(torch.from_numpy(x).permute(0, 3, 1, 2), 224,
                         224).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def _jax_ensemble_params(dreamsim_type, image_size, overrides, seed=10):
    from aqualora_tpu.eval.dreamsim import MODEL_CONFIGS
    return {name: _jax_vit(name, image_size, overrides, seed + i)[1]
            for i, (name, _) in enumerate(MODEL_CONFIGS[dreamsim_type])}


def _to_port(jparams):
    return {name: jax_params_to_torch(v["params"])
            for name, v in jparams.items()}


def test_ensemble_distance_matches_jax():
    from aqualora_tpu.eval.dreamsim import DreamSim as JDS
    jparams = _jax_ensemble_params("ensemble", 64, TINY)
    ref_ds = JDS(params=jparams, image_size=64, vit_overrides=TINY)
    ds = tds.DreamSim(params=_to_port(jparams), image_size=64,
                      vit_overrides=TINY, device="cpu")
    assert ds.embed_size == ref_ds.embed_size == 32 + 2 * 512
    a, b = _images(3, 3, 96), _images(4, 3, 96)[::-1]   # a strided view
    ref = ref_ds(a, b)
    got = ds(a, b)
    assert got.shape == (3,) and np.abs(got - ref).max() <= DIST_TOL
    np.testing.assert_allclose(ds.embed(a).numpy(), np.asarray(
        ref_ds.embed(a)), rtol=0, atol=1e-5)
    assert np.abs(ds(a, a)).max() < 1e-5


def test_mlp_head_matches_jax():
    from aqualora_tpu.eval.dreamsim import DreamSim as JDS
    from aqualora_tpu.models.vit import DreamSimMLP as JMLP
    jparams = _jax_ensemble_params("dino_vitb16", 32, TINY)
    mlp_shapes = jax.eval_shape(JMLP(32, 16).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32)))
    jparams["mlp"] = _fill(mlp_shapes, 11)
    ref_ds = JDS(params=jparams, dreamsim_type="dino_vitb16", image_size=32,
                 use_mlp=True, hidden_size=16, vit_overrides=TINY)
    port = _to_port(jparams)
    ds = tds.DreamSim(params=port, dreamsim_type="dino_vitb16",
                      image_size=32, use_mlp=True, hidden_size=16,
                      vit_overrides=TINY, device="cpu")
    a, b = _images(5, 2, 40), _images(6, 2, 40)
    assert np.abs(ds(a, b) - ref_ds(a, b)).max() <= DIST_TOL
    rand = tds.DreamSim(dreamsim_type="dino_vitb16", image_size=32,
                        use_mlp=True, hidden_size=16, vit_overrides=TINY,
                        device="cpu")
    assert np.isfinite(rand(a, b)).all() and rand(a, a).max() < 1e-5


def test_tables_match_jax():
    from aqualora_tpu.eval import dreamsim as jds
    assert tds.MODEL_CONFIGS == jds.MODEL_CONFIGS
    assert tds.EMBED_DIMS == jds.EMBED_DIMS
    assert tds.BACKBONES.keys() == jds.BACKBONES.keys()
    for name, kw in jds.BACKBONES.items():
        assert tds.BACKBONES[name].keys() == kw.keys(), name
        for k, v in kw.items():
            np.testing.assert_array_equal(tds.BACKBONES[name][k], v)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _dino_state(variables, pre_norm):
    """A DINO-layout torch state dict of JAX variables (the published
    layout: the port's keys), `proj` kept apart."""
    sd = jax_params_to_torch(variables["params"])
    proj = sd.pop("proj", None)
    if not pre_norm:
        assert not any(k.startswith("pos_drop") for k in sd)
    return sd, proj


def _adapter(depth, dim, rng):
    return {f"base_model.model.model.blocks.{i}.attn.qkv.lora_{ab}.weight":
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for i in range(depth)
            for ab, shape in (("A", (4, dim)), ("B", (3 * dim, 4)))}


def _write_cache(root, jparams, rng):
    """The reference's unzipped checkpoint layout for the ensemble: DINO as
    a training checkpoint, the CLIP variants as .pth.tar with a
    `state_dict`; one adapter as safetensors with its config, the others
    as adapter_model.bin."""
    for name, v in jparams.items():
        sd, proj = _dino_state(v, pre_norm=name != "dino_vitb16")
        lora = root / f"{name}_lora"
        lora.mkdir()
        adapter = _adapter(2, 32, rng)
        if name == "dino_vitb16":
            student = {f"module.backbone.{k}": t for k, t in sd.items()}
            student["module.head.mlp.0.weight"] = torch.zeros(4, 32)
            teacher = {f"backbone.{k}": torch.zeros_like(t)
                       for k, t in sd.items()}
            torch.save({"student": student, "teacher": teacher,
                        "args": argparse.Namespace(arch="vit_base")},
                       root / "dino_vitb16_pretrain.pth")
        else:
            torch.save({"state_dict": {**sd, "proj": proj}},
                       root / f"{name}_pretrain.pth.tar")
        if name == "clip_vitb16":
            tio.save_safetensors(adapter,
                                 str(lora / "adapter_model.safetensors"))
            (lora / "adapter_config.json").write_text(
                json.dumps({"r": 8, "lora_alpha": 4.0}))
        else:
            torch.save(adapter, lora / "adapter_model.bin")


def test_dreamsim_from_torch_matches_jax(tmp_path):
    """The ensemble's cache directory read by both readers (DINO's student,
    not its teacher; the adapters folded with their own r and alpha): the
    same distances."""
    from aqualora_tpu.eval.dreamsim import DreamSim as JDS
    from aqualora_tpu.tools.torch_import import dreamsim_from_torch as jread

    from aqualora_torch.tools.torch_import import dreamsim_from_torch
    jparams = _jax_ensemble_params("ensemble", 64, TINY, seed=20)
    _write_cache(tmp_path, jparams, np.random.default_rng(0))
    port = dreamsim_from_torch(str(tmp_path))
    ds = tds.DreamSim(params=port, image_size=64, vit_overrides=TINY,
                      device="cpu")
    ref_ds = JDS(params=jread(str(tmp_path)), image_size=64,
                 vit_overrides=TINY)
    a, b = _images(7, 2, 64), _images(8, 2, 64)
    assert np.abs(ds(a, b) - ref_ds(a, b)).max() <= DIST_TOL
    plain = tds.DreamSim(params=_to_port(jparams), image_size=64,
                         vit_overrides=TINY, device="cpu")
    assert np.abs(plain(a, b) - ds(a, b)).max() > 1e-4   # folded in
    assert "pos_drop.weight" in port["clip_vitb16"]
    assert "proj" in port["open_clip_vitb16"]


def test_mae_readers_match_jax(tmp_path):
    """An HF ViTMAEModel state dict (q, k, v apart) through both readers,
    with a single_ adapter folded, into both models; ViT-L/H's DINO layout
    under 'model'."""
    transformers = pytest.importorskip("transformers")
    from aqualora_tpu.models.vit import ViTB16 as JViT
    from aqualora_tpu.tools import torch_import as jti

    from aqualora_torch.tools import torch_import as tti
    torch.manual_seed(0)
    hf = transformers.ViTMAEModel(transformers.ViTMAEConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=32, patch_size=16)).eval()
    torch.save(hf.state_dict(), tmp_path / "mae_vitb16_pretrain.pth")
    lora = tmp_path / "mae_vitb16_single_lora"
    lora.mkdir()
    torch.save(_adapter(2, 32, np.random.default_rng(1)),
               lora / "adapter_model.bin")
    port = tti.dreamsim_from_torch(str(tmp_path), "mae_vitb16")["mae_vitb16"]
    jvars = jti.dreamsim_from_torch(str(tmp_path), "mae_vitb16")["mae_vitb16"]
    x = _images(9, 2, 32)
    jm = JViT(dim=32, depth=2, heads=2, image_size=32)
    vit = ViTB16(dim=32, depth=2, heads=2, image_size=32).eval()
    vit.load_state_dict(port, strict=True)
    _check_taps(jm, jvars, vit, x)
    plain = tti.mae_as_vit_from_torch(hf.state_dict())
    assert not torch.equal(plain["blocks.0.attn.qkv.weight"],
                           port["blocks.0.attn.qkv.weight"])
    dino = dict(plain)
    got = tti.load_mae_as_vit("mae_vith14", {"model": dino})
    assert all(torch.equal(got[k], dino[k]) for k in dino)
    with pytest.raises(ValueError, match="not supported"):
        tti.load_mae_as_vit("mae_vits8", dino)


def test_fold_qkv_lora_matches_jax():
    from aqualora_tpu.tools.torch_import import fold_qkv_lora as jfold

    from aqualora_torch.tools.torch_import import fold_qkv_lora
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((96, 32)).astype(np.float32))
    adapter = _adapter(1, 32, rng)
    got = fold_qkv_lora({"blocks.0.attn.qkv.weight": w}, adapter, r=4,
                        alpha=2.0)["blocks.0.attn.qkv.weight"]
    ref = jfold({"blocks.0.attn.qkv.weight": w.numpy()},
                {k: v.numpy() for k, v in adapter.items()}, r=4,
                alpha=2.0)["blocks.0.attn.qkv.weight"]
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# run_dreamsim
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wm_folder(tmp_path_factory):
    """A tiny PPFT artifact folder written by the port: seeded weights,
    LoRA ups non-zero, so that the watermarked images differ."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train.ppft_train import save_artifacts
    root = tmp_path_factory.mktemp("ds_art")
    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.init_params(seed=0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            if ".lora.up" in n:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    dec = SecretDecoder(tcfg.WatermarkConfig.tiny().msg_bits,
                        tcfg.EfficientNetConfig.tiny(), device="cpu")
    save_artifacts(str(root / "wm"), pipe, dec)
    return str(root / "wm")


def test_run_dreamsim_tiny_matches_jax(wm_folder, tmp_path, monkeypatch,
                                       capsys):
    """The runner's distances equal JAX's DreamSim on the runner's own two
    image sets (watermarked, clean) with the same weights, carried over
    through --dreamsim_params."""
    from aqualora_tpu.eval.dreamsim import DreamSim as JDS

    from aqualora_torch.eval import run_dreamsim
    tiny = {"dim": 32, "depth": 1, "heads": 2}
    jparams = _jax_ensemble_params("ensemble", 224, tiny, seed=30)
    weights = str(tmp_path / "dreamsim.pt")
    torch.save(_to_port(jparams), weights)
    sets, real = [], run_dreamsim.utils_eval.simple_sample

    def keep(*a, **k):
        sets.append(real(*a, **k))
        return sets[-1]
    monkeypatch.setattr(run_dreamsim.utils_eval, "simple_sample", keep)
    dists = run_dreamsim.main(["--train_folder", wm_folder, "--num_prompts",
                               "3", "--batch_size", "2", "--tiny",
                               "--dreamsim_params", weights, "--device",
                               "cpu"])
    out = capsys.readouterr().out
    assert f"mean DreamSim distance: {float(dists.mean()):.6f}" in out
    wm, clean = (np.stack(s).astype(np.float32) / 255.0 for s in sets)
    assert wm.shape == clean.shape == (3, 32, 32, 3)
    assert np.abs(wm - clean).max() > 0           # the LoRA acts
    ref = JDS(params=jparams, vit_overrides=tiny)(wm, clean)
    assert dists.shape == (3,) and np.abs(dists - ref).max() <= DIST_TOL
    assert dists.min() > 0


def test_run_dreamsim_guards(wm_folder, monkeypatch):
    """No weights, --int8, and both LoRA sources stop before any
    generation."""
    from aqualora_torch.eval import run_dreamsim

    def no_generation(*a, **k):
        raise AssertionError("generation ran")
    monkeypatch.setattr(run_dreamsim.utils_eval, "simple_sample",
                        no_generation)
    base = ["--train_folder", wm_folder, "--tiny", "--device", "cpu"]
    with pytest.raises(SystemExit, match="no DreamSim weights"):
        run_dreamsim.main(base)
    with pytest.raises(SystemExit, match="A.8"):
        run_dreamsim.main(base + ["--int8", "--allow_random_weights"])
    with pytest.raises(SystemExit, match="exactly one"):
        run_dreamsim.main(base + ["--lora", "x.safetensors",
                                  "--allow_random_weights"])
    with pytest.raises(SystemExit, match="non-square"):
        run_dreamsim.main(base + ["--height", "32", "--width", "64",
                                  "--allow_random_weights"])
