"""The port's readers of the reference's release files, its synthesizer of
them and its porter (`aqualora_torch/tools/{torch_import,
synthetic_artifacts, port_reference_artifacts}.py`) against the JAX
package's, on the CPU.

- Each reader on the same seeded state dict: the JAX reader's tree,
  carried across by `jax_params_to_torch`, equals the port's state dict
  tensor for tensor (the full-width B1 decoder with and without `model.`
  and `num_batches_tracked`, the SecretEncoder, the mapper,
  `pretrained_latentwm.pth`, both LPIPS layouts), and the tiny decoder
  read by both gives the same logits.
- The synthesizer with the same seed writes the same tensors as JAX's;
  `perturb_zero_init` hits the same tensors.
- The porter's files load strictly into the port's modules; a release
  folder with none of the files raises.
- Every file under `aqualora_torch/csrc/` is package data.
"""

import fnmatch
import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.core.io import load_safetensors, unet_module_keys
from aqualora_torch.tools import synthetic_artifacts as tsyn
from aqualora_torch.tools import torch_import as ti
from aqualora_tpu.tools import synthetic_artifacts as jsyn
from aqualora_tpu.tools import torch_import as ji

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(port, ref):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:5]
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        assert torch.equal(port[k], ref[k]), k


def _random_b1_state(seed, bits=48, cfg=None):
    """A torchvision-layout efficientnet_b1 state dict (the port's module
    is that layout) with seeded random weights and statistics."""
    from aqualora_torch.models.efficientnet import EfficientNet
    cfg = cfg or tcfg.EfficientNetConfig.b1(num_classes=2 * bits)
    model = EfficientNet(cfg)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
        elif k.endswith("running_var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=gen)
        else:
            out[k] = 0.1 * torch.randn(v.shape, generator=gen)
    return out


def _jax_decoder_state(jvars):
    return jax_params_to_torch(_tree(jvars["params"]),
                               _tree(jvars["batch_stats"]))


@pytest.mark.parametrize("prefixed", [False, True])
@pytest.mark.parametrize("counters", [False, True])
def test_b1_decoder_reader_matches_jax(prefixed, counters):
    """The release's msgdecoder.pt at full B1 width: without the `model.`
    prefix (the release) or with it, with torchvision's
    `num_batches_tracked` or without it (the synthesizer's)."""
    state = _random_b1_state(1)
    if not counters:
        state = {k: v for k, v in state.items()
                 if not k.endswith("num_batches_tracked")}
    if prefixed:
        state = {f"model.{k}": v for k, v in state.items()}
    cfg = tcfg.EfficientNetConfig.b1(num_classes=96)
    port = ti.secret_decoder_from_torch(state, cfg=cfg)
    ref = _jax_decoder_state(ji.secret_decoder_from_torch(
        _numpy(state), cfg=jcfg.EfficientNetConfig.b1(num_classes=96)))
    _assert_same(port, ref)
    backbone = ti.efficientnet_b1_from_torch(state, cfg)
    params, stats = ji.efficientnet_b1_from_torch(
        _numpy(state), jcfg.EfficientNetConfig.b1(num_classes=96))
    _assert_same(backbone, jax_params_to_torch(_tree(params), _tree(stats)))
    from aqualora_torch.models.watermark import SecretDecoder
    own = SecretDecoder(48, cfg, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in port.items()}


def test_tiny_decoder_logits_match_jax():
    """The same file read by both packages: the tiny decoder's logits on
    the same images, float32."""
    from aqualora_torch.models.watermark import SecretDecoder as TDec
    from aqualora_tpu.models.watermark import SecretDecoder as JDec
    state = _random_b1_state(2, BITS, tcfg.EfficientNetConfig.tiny())
    jvars = ji.secret_decoder_from_torch(
        _numpy(state), cfg=jcfg.EfficientNetConfig.tiny())
    dec = TDec(BITS, tcfg.EfficientNetConfig.tiny(), device="cpu")
    dec.load_state_dict(ti.secret_decoder_from_torch(
        state, cfg=tcfg.EfficientNetConfig.tiny()), strict=True)
    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3))).astype(np.float32)
    with torch.no_grad():
        out = dec.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = jax.jit(lambda v, x: JDec(BITS, jcfg.EfficientNetConfig.tiny(
    )).apply(v, x, False))(jvars, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _encoder_state(seed, bits=48):
    g = torch.Generator().manual_seed(seed)
    return {"secret_scaler.0.weight": torch.randn(1024, bits, generator=g),
            "secret_scaler.0.bias": torch.randn(1024, generator=g),
            "secret_scaler.5.weight": torch.randn(4, 4, 3, 3, generator=g),
            "secret_scaler.5.bias": torch.randn(4, generator=g)}


def test_encoder_and_mapper_readers_match_jax():
    enc = _encoder_state(4)
    port = ti.secret_encoder_from_torch(enc)
    _assert_same(port, jax_params_to_torch(_tree(
        ji.secret_encoder_from_torch(_numpy(enc)))))
    from aqualora_torch.models.watermark import MapperNet, SecretEncoder
    SecretEncoder(48).load_state_dict(port, strict=True)
    mapper = {"bit_embeddings.weight": torch.randn(
        48, 320, generator=torch.Generator().manual_seed(5))}
    port = ti.mapper_from_torch(mapper)
    _assert_same(port, jax_params_to_torch(_tree(
        ji.mapper_from_torch(_numpy(mapper)))))
    MapperNet(48, 320).load_state_dict(port, strict=True)


def test_latentwm_reader_matches_jax(tmp_path):
    """pretrained_latentwm.pth at full width -> the port's stage-1 file,
    which `ppft_train.load_pretrain` loads strictly."""
    from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
    from aqualora_torch.train.ppft_train import load_pretrain
    dec = {f"model.{k}": v for k, v in _random_b1_state(6).items()
           if not k.endswith("num_batches_tracked")}
    path = str(tmp_path / "pretrained_latentwm.pth")
    torch.save({"sec_encoder": _encoder_state(7), "sec_decoder": dec}, path)
    port = ti.latentwm_from_torch(path)
    ref = ji.latentwm_from_torch(path)
    _assert_same(port["sec_encoder"],
                 jax_params_to_torch(_tree(ref["sec_encoder"])))
    _assert_same(port["sec_decoder"], _jax_decoder_state(ref["sec_decoder"]))
    torch.save(port, str(tmp_path / "pretrained_latentwm.pt"))
    load_pretrain(str(tmp_path / "pretrained_latentwm.pt"),
                  SecretEncoder(48), SecretDecoder(48, device="cpu"))


def _lpips_states():
    """One seeded LPIPS in the lpips package's layout, and the same weights
    in torchvision's `features.N` with `lins.{i}` heads."""
    from aqualora_torch.models.lpips import LPIPS
    gen = torch.Generator().manual_seed(8)
    lp = {k: torch.randn(v.shape, generator=gen)
          for k, v in LPIPS().state_dict().items()}
    tv = {}
    for k, v in lp.items():
        parts = k.split(".")
        if parts[0] == "net":               # net.sliceS.N.leaf
            tv[f"features.{parts[2]}.{parts[3]}"] = v
        else:                               # linI.model.1.weight
            tv[f"lins.{k[3]}.model.1.weight"] = v
    return lp, tv


@pytest.mark.parametrize("layout", ["lpips", "torchvision", "net.features"])
def test_lpips_reader_matches_jax(layout):
    from aqualora_torch.models.lpips import LPIPS
    lp, tv = _lpips_states()
    state = {"lpips": lp, "torchvision": tv,
             "net.features": {("net." + k if k.startswith("features") else k
                               ): v for k, v in tv.items()}}[layout]
    port = ti.lpips_from_torch(state)
    _assert_same(port, jax_params_to_torch(_tree(
        ji.lpips_from_torch(_numpy(state)))))
    _assert_same(port, lp)
    LPIPS().load_state_dict(port, strict=True)


def test_synthesizer_matches_jax(tmp_path):
    """The same seed writes the same tensors as the JAX synthesizer: the
    three pickles tensor for tensor, the LoRA file array for array."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsyn.synthesize_reference_artifacts(
        jdir, msg_bits=BITS, rank=4, unet=jcfg.UNetConfig.tiny(),
        backbone=jcfg.EfficientNetConfig.tiny(num_classes=2 * BITS), seed=3)
    tsyn.synthesize_reference_artifacts(
        tdir, msg_bits=BITS, rank=4, unet=tcfg.UNetConfig.tiny(),
        backbone=tcfg.EfficientNetConfig.tiny(num_classes=2 * BITS), seed=3)
    for rel in ("pretrained_latentwm.pth", "ppft_trained/mapper.pt",
                "ppft_trained/msgdecoder.pt"):
        a = torch.load(os.path.join(tdir, rel), weights_only=True)
        b = torch.load(os.path.join(jdir, rel), weights_only=True)
        flat_a = a if "sec_encoder" not in a else {
            f"{o}/{k}": v for o in a for k, v in a[o].items()}
        flat_b = b if "sec_encoder" not in b else {
            f"{o}/{k}": v for o in b for k, v in b[o].items()}
        assert list(flat_a) == list(flat_b), rel
        for k in flat_b:
            assert torch.equal(flat_a[k], flat_b[k]), (rel, k)
    lora = "ppft_trained/pytorch_lora_weights.safetensors"
    a = load_safetensors(os.path.join(tdir, lora))
    b = load_safetensors(os.path.join(jdir, lora))
    assert set(a) == set(b)
    assert len(a) == 2 * len(unet_module_keys(tcfg.UNetConfig.tiny()))
    for k in b:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_perturb_zero_init_hits_jax_leaves():
    """The same leaves as JAX's, on the tiny pipeline and a SecretEncoder:
    every LoRA up and every conv_out (zero trees, so a hit is a non-zero
    tensor); a tree with none raises in both."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.models.watermark import SecretEncoder
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: StableDiffusionPipeline(
        jcfg.PipelineConfig.tiny()).init_params(key, 32, 32))
    shapes = {"unet": shapes["unet"], "vae": shapes["vae"],
              "sec_encoder": jax.eval_shape(lambda: SecretEncoder(
                  BITS, base_res=8, resolution=8).init(
                  key, jnp.zeros((1, 8, 8, 4)),
                  jnp.zeros((1, BITS))))["params"]}
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = jax_params_to_torch(_tree(jsyn.perturb_zero_init(zeros, seed=1)))
    port = tsyn.perturb_zero_init(jax_params_to_torch(zeros), seed=1)
    assert set(port) == set(ref)
    hit_ref = {k for k, v in ref.items() if v.abs().sum() > 0}
    hit_port = {k for k, v in port.items() if v.abs().sum() > 0}
    assert hit_port == hit_ref
    assert any(k.endswith("lora.up.weight") for k in hit_port)
    assert "sec_encoder.conv_out.weight" in hit_port
    bare = {"vae": zeros["vae"]["decoder"]["mid_block"]}
    with pytest.raises(ValueError):
        jsyn.perturb_zero_init(bare)
    with pytest.raises(ValueError):
        tsyn.perturb_zero_init(jax_params_to_torch(bare))


def test_ported_files_load_strictly(tmp_path):
    """The porter's four files at the tiny config load strictly: the
    stage-1 file through `load_pretrain`, the decoder through
    `load_msgdecoder`, the mapper, and the LoRA (copied byte for byte)."""
    from aqualora_torch.core.io import assign_state
    from aqualora_torch.eval.utils_eval import load_msgdecoder
    from aqualora_torch.models.watermark import MapperNet, SecretEncoder
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.tools.port_reference_artifacts import port
    from aqualora_torch.train.ppft_train import load_pretrain
    rel = str(tmp_path / "release")
    backbone = tcfg.EfficientNetConfig.tiny(num_classes=2 * BITS)
    tsyn.synthesize_reference_artifacts(rel, msg_bits=BITS, rank=4,
                                        unet=tcfg.UNetConfig.tiny(),
                                        backbone=backbone, seed=0)
    out = str(tmp_path / "ported")
    port(out, latentwm=os.path.join(rel, "pretrained_latentwm.pth"),
         train_folder=os.path.join(rel, "ppft_trained"), backbone=backbone)
    load_pretrain(os.path.join(out, "pretrained_latentwm.pt"),
                  SecretEncoder(BITS), SecretDecoder(BITS, backbone,
                                                     device="cpu"))
    load_msgdecoder(os.path.join(out, "msgdecoder.pt"), BITS, backbone,
                    device="cpu")
    assign_state(MapperNet(BITS, 4), load_safetensors(
        os.path.join(out, "mapper.safetensors")))
    lora = "pytorch_lora_weights.safetensors"
    with open(os.path.join(out, lora), "rb") as a, open(os.path.join(
            rel, "ppft_trained", lora), "rb") as b:
        assert a.read() == b.read()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="ppft_trained"):
        port(str(tmp_path / "nothing"), train_folder=str(empty))


def test_every_csrc_file_is_package_data():
    """An installed aqualora_torch builds its kernels from csrc/: each
    source and header there must match a package-data pattern."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "aqualora_torch"]
    csrc = os.path.join(REPO, "aqualora_torch", "csrc")
    files = sorted(os.listdir(csrc))
    assert {"tensor_core.cuh", "jpeg_decode.cpp", "flash_fwd.cu"} <= set(
        files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", p) for p in patterns)]
    assert not missing, missing
