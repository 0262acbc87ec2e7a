"""The port's host-side release tools against the JAX package's, on the
CPU, on the same arrays: the LoRA layouts (`tools/lora_layouts.py`), SAI
modelspec metadata and hashes (`tools/sai_model_spec.py`), the LoRA merge
(`tools/merge_lora.py`) and the LDM <-> diffusers conversion
(`tools/ldm_convert.py`).  The full SD-1.5 and SD-2.1 states are built
from the port's modules on the meta device as zero-stride tensors, as
`tests/test_ldm_convert.py` builds the JAX side's from `eval_shape`.
"""

import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
from aqualora_torch.core.io import (load_safetensors, lora_torch_key,
                                    save_safetensors, unet_module_keys)
from aqualora_torch.tools import ldm_convert as tldm
from aqualora_torch.tools import lora_layouts as tlay
from aqualora_torch.tools import merge_lora as tmerge
from aqualora_torch.tools import sai_model_spec as tsai
from aqualora_tpu.tools import ldm_convert as jldm
from aqualora_tpu.tools import lora_layouts as jlay
from aqualora_tpu.tools import merge_lora as jmerge
from aqualora_tpu.tools import sai_model_spec as jsai


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _numpy(state):
    return {k: _np(v) for k, v in state.items()}


def _assert_values(port, ref, exact=True):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:5]
    for k in ref:
        a, b = port[k].float().numpy(), np.asarray(ref[k], np.float32)
        assert a.shape == b.shape, k
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:       # float32 sums in other orders: 1e-6 of the tensor
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# LoRA layouts
# ---------------------------------------------------------------------------

def test_sd15_lora_keys_round_trip_as_jax():
    """The 384 keys of the SD-1.5 watermark LoRA: to the webui layout and
    back, each direction as JAX's; the attention sites come back as they
    were, the proj and ff sites are dropped (the reference's converter)."""
    keys = [lora_torch_key(mk, w) for mk in unet_module_keys(
        tcfg.UNetConfig.sd15()) for w in ("down", "up")]
    assert len(keys) == 384
    state = {k: i for i, k in enumerate(keys)}
    webui = tlay.diffusers_to_webui(state)
    assert webui == jlay.diffusers_to_webui(state)
    assert len(webui) == 384
    back = tlay.webui_to_diffusers(webui)
    assert back == jlay.webui_to_diffusers(webui)
    attn = {f"unet.{k}": i for k, i in back.items()}
    assert attn == {k: i for k, i in state.items()
                    if ".processor." in k}
    assert len(attn) == 256


def test_webui_file_converts_as_jax(tmp_path):
    """A webui file with text-encoder, ff, alpha and proj keys: both
    converters (and the two CLIs, through files) give JAX's keys."""
    names = ["lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_"
             "attn1_to_q", "lora_unet_mid_block_attentions_0_transformer_"
             "blocks_0_attn2_to_out_0", "lora_unet_up_blocks_3_attentions_2_"
             "proj_in", "lora_unet_up_blocks_1_attentions_0_transformer_"
             "blocks_0_ff_net_2", "lora_te_text_model_encoder_layers_0_"
             "self_attn_q_proj"]
    state = {}
    for i, n in enumerate(names):
        state[f"{n}.lora_down.weight"] = torch.full((2, 3), float(i))
        state[f"{n}.lora_up.weight"] = torch.full((3, 2), -float(i))
        state[f"{n}.alpha"] = torch.tensor(float(i + 1))
    ref = jlay.webui_to_diffusers(_numpy(state))
    _assert_values(tlay.webui_to_diffusers(state), ref)
    assert len(ref) == 4          # only the two attention sites survive
    src, w2d, d2w = (str(tmp_path / n) for n in ("src.safetensors",
                                                  "w2d.safetensors",
                                                  "d2w.safetensors"))
    save_safetensors(state, src)
    tlay.main_w2d(["--src_lora", src, "--tgt_lora", w2d])
    _assert_values(load_safetensors(w2d), ref)
    tlay.main_d2w(["--src_lora", w2d, "--tgt_lora", d2w])
    _assert_values(load_safetensors(d2w), jlay.diffusers_to_webui(ref))


# ---------------------------------------------------------------------------
# SAI modelspec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(v2=False, v_parameterization=False, sdxl=False, lora=False,
         textual_inversion=False, title="merged", merged_from="a, b",
         is_stable_diffusion_ckpt=True),
    dict(v2=True, v_parameterization=False, sdxl=False, lora=False,
         textual_inversion=False, is_stable_diffusion_ckpt=True),
    dict(v2=True, v_parameterization=True, sdxl=False, lora=False,
         textual_inversion=False, title="merged-v2", merged_from="x",
         is_stable_diffusion_ckpt=True),
    dict(v2=False, v_parameterization=False, sdxl=False, lora=True,
         textual_inversion=False, title="wm-lora", reso="512,512",
         author="someone", description="d", license="L", tags="t",
         timesteps=(0, 1000), clip_skip=2),
    dict(v2=False, v_parameterization=False, sdxl=False, lora=False,
         textual_inversion=True, reso=(640,), timesteps=500),
])
def test_sai_metadata_matches_jax(case):
    kw = dict(case)
    flags = [kw.pop(k) for k in ("v2", "v_parameterization", "sdxl", "lora",
                                 "textual_inversion")]
    ts = 1700000000.5
    assert (tsai.build_metadata(None, *flags, ts, **kw)
            == jsai.build_metadata(None, *flags, ts, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_sai_hash_matches_jax(dtype):
    gen = torch.Generator().manual_seed(11)
    state = {"b": torch.randn(7, 5, generator=gen).to(dtype),
             "a": torch.randn(3, generator=gen).to(dtype),
             "s": torch.tensor(2.5).to(dtype)}
    got = tsai.precalculate_safetensors_hashes(state)
    assert got == jsai.precalculate_safetensors_hashes(_numpy(state))
    assert got != tsai.precalculate_safetensors_hashes(
        dict(reversed(list(state.items()))))


def test_sai_file_metadata_and_merged_from_match_jax(tmp_path):
    titled = str(tmp_path / "base.safetensors")
    save_safetensors({"w": torch.zeros(2)}, titled,
                     metadata={"modelspec.title": "Base Model", "x": "1"})
    bare = str(tmp_path / "lora.safetensors")
    save_safetensors({"w": torch.zeros(2)}, bare)
    for p in (titled, bare, str(tmp_path / "absent.safetensors"),
              str(tmp_path / "dir")):
        assert (tsai.load_metadata_from_safetensors(p)
                == jsai.load_metadata_from_safetensors(p))
    models = [titled, bare, str(tmp_path / "sd_dir")]
    assert tsai.build_merged_from(models) == jsai.build_merged_from(models)
    assert tsai.build_merged_from(models) == "Base Model, lora, sd_dir"


# ---------------------------------------------------------------------------
# merge_lora
# ---------------------------------------------------------------------------

def _site(mk):
    """The webui module name of a U-Net LoRA site."""
    return next(iter(tlay.diffusers_to_webui({lora_torch_key(mk, "down"):
                                              None}))).replace(
        ".lora_down.weight", "")


Q = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
K = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k"
PIN = "down_blocks.0.attentions.0.proj_in"
POUT = "down_blocks.0.attentions.0.proj_out"
FF = "mid_block.attentions.0.transformer_blocks.0.ff.net.2"


def _merge_case(gen):
    """Base states and a webui LoRA of every kind: linear into linear
    (with an alpha, and a float16 weight), 1x1 into 1x1, 3x3 into a 3x3
    conv, 1x1 into linear, linear into 1x1, a text-encoder layer, a module
    outside the table and a text-encoder layer the base lacks."""
    def r(*shape):
        return torch.randn(*shape, generator=gen)
    unet = {f"{Q}.weight": r(6, 6), f"{K}.weight": r(6, 6).half(),
            f"{PIN}.weight": r(6, 6, 1, 1), f"{POUT}.weight": r(6, 6),
            f"{FF}.weight": r(5, 6, 1, 1),
            "down_blocks.1.attentions.0.proj_in.weight": r(4, 3, 3, 3)}
    te = {"text_model.encoder.layers.0.self_attn.q_proj.weight": r(4, 4)}
    lora = {}

    def put(name, down, up, alpha=None):
        lora[f"{name}.lora_down.weight"] = down
        lora[f"{name}.lora_up.weight"] = up
        if alpha is not None:
            lora[f"{name}.alpha"] = torch.tensor(alpha)
    put(_site(Q), r(2, 6), r(6, 2), alpha=1.0)
    put(_site(K), r(2, 6), r(6, 2))
    put(_site(PIN), r(2, 6, 1, 1), r(6, 2, 1, 1))
    put(_site(POUT), r(2, 6, 1, 1), r(6, 2, 1, 1))            # 1x1 -> linear
    put(_site(FF), r(2, 6), r(5, 2))                          # linear -> 1x1
    put(_site("down_blocks.1.attentions.0.proj_in"), r(2, 3, 3, 3),
        r(4, 2, 1, 1), alpha=4.0)                             # 3x3
    put("lora_te_text_model_encoder_layers_0_self_attn_q_proj", r(2, 4),
        r(4, 2))
    put("lora_unet_conv_in", r(2, 4, 3, 3), r(4, 2, 1, 1))     # no site
    put("lora_te_text_model_encoder_layers_20_mlp_fc1", r(2, 4), r(4, 2))
    return unet, te, lora


def test_merge_matches_jax(capsys):
    unet, te, lora = _merge_case(torch.Generator().manual_seed(12))
    j_unet, j_te = _numpy(unet), _numpy(te)
    jmerge.merge_lora_into_states(j_unet, j_te, _numpy(lora), ratio=0.7)
    ref_out = capsys.readouterr().out
    t_unet, t_te = dict(unet), dict(te)
    tmerge.merge_lora_into_states(t_unet, t_te, lora, ratio=0.7)
    out = capsys.readouterr().out
    assert out == ref_out
    assert out.count("no module found for LoRA weight:") == 2
    assert "lora_unet_conv_in" in out and "layers_20_mlp_fc1" in out
    _assert_values(t_unet, j_unet, exact=False)
    _assert_values(t_te, j_te, exact=False)
    assert t_unet[f"{K}.weight"].dtype == torch.float16
    assert all(not torch.equal(t_unet[k], unet[k]) for k in unet)
    assert not torch.equal(t_te[next(iter(te))], te[next(iter(te))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_gives_the_fold_bit_for_bit(dtype):
    """The host merge of a rank-320 LoRA equals the pipeline's fold
    (`fold_lora_tree`) bit for bit, in float32 and rounded to bf16: both
    sum over the rank in float64 and round the delta to float32 once."""
    from aqualora_torch.core.config import LoRAConfig
    from aqualora_torch.models.lora import (LoRAConv2d, LoRALinear,
                                            fold_lora_tree)
    gen = torch.Generator().manual_seed(16)
    lora = LoRAConfig(rank=320, enabled=True)
    module = torch.nn.ModuleDict({
        "lin": LoRALinear(96, 80, lora=lora),
        "conv": LoRAConv2d(64, 64, lora=lora)})
    for p in module.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.05
    names = {"lin": Q, "conv": PIN}
    unet = {f"{names[n]}.weight": m.weight.detach().clone()
            for n, m in module.items()}
    webui = {}
    for n, m in module.items():
        webui[f"{_site(names[n])}.lora_down.weight"] = m.lora.down.weight
        webui[f"{_site(names[n])}.lora_up.weight"] = m.lora.up.weight
    base = dict(unet)
    tmerge.merge_lora_into_states(unet, {}, webui)
    fold_lora_tree(module, torch.ones(320))
    for n, m in module.items():
        key = f"{names[n]}.weight"
        assert torch.equal(unet[key].to(dtype), m.weight.detach().to(dtype)), n
        assert not torch.equal(unet[key], base[key]), n


def test_merge_refuses_3x3_into_linear():
    gen = torch.Generator().manual_seed(13)
    unet = {f"{Q}.weight": torch.randn(4, 3, generator=gen)}
    lora = {f"{_site(Q)}.lora_down.weight": torch.randn(2, 3, 3, 3,
                                                        generator=gen),
            f"{_site(Q)}.lora_up.weight": torch.randn(4, 2, 1, 1,
                                                      generator=gen)}
    for merge, state, lr in ((tmerge, unet, lora),
                             (jmerge, _numpy(unet), _numpy(lora))):
        with pytest.raises(ValueError, match="3x3-conv LoRA"):
            merge.merge_lora_into_states(state, {}, lr)


# ---------------------------------------------------------------------------
# ldm_convert
# ---------------------------------------------------------------------------

def _meta_states(pcfg, dtype=torch.float32):
    """The U-Net (without its LoRA), VAE and text encoder state dicts of
    the port's modules as zero-stride tensors of the real shapes."""
    from aqualora_torch.models.clip import CLIPTextModel
    from aqualora_torch.models.unet import UNet2DConditionModel
    from aqualora_torch.models.vae import AutoencoderKL
    with torch.device("meta"):
        mods = (UNet2DConditionModel(pcfg.unet), AutoencoderKL(pcfg.vae),
                CLIPTextModel(pcfg.clip))

    def zeros(m, prefix=""):
        return {prefix + k: torch.zeros((), dtype=dtype).expand(v.shape)
                for k, v in m.state_dict().items() if ".lora." not in k}
    return (zeros(mods[0]), zeros(mods[1]), zeros(mods[2], "text_model."))


def _np_zeros(state):
    return {k: np.broadcast_to(np.zeros((), torch.empty(
        (), dtype=v.dtype).numpy().dtype), tuple(v.shape))
        for k, v in state.items()}


def _same_layout(port, ref):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:5]
    for k in ref:
        assert tuple(port[k].shape) == tuple(np.shape(ref[k])), k


@pytest.mark.parametrize("model", ["sd15", "sd21"])
def test_full_checkpoint_layouts_match_jax(model):
    """A whole SD-1.5 or SD-2.1 state (v2: the open-CLIP tower, linear
    proj_in/out, dummy weights) to the single-file layout and back: every
    key and shape as JAX's, in both directions; nothing is copied on the
    way but the fused qkv and the dummy weights."""
    v2 = model == "sd21"
    pcfg = (tcfg.PipelineConfig.sd21(320) if v2
            else tcfg.PipelineConfig.sd15(320))
    unet, vae, te = _meta_states(pcfg, torch.float16)
    ldm = tldm.diffusers_to_ldm(unet, vae, te, v2=v2, make_dummy_weights=v2)
    ref = jldm.diffusers_to_ldm(_np_zeros(unet), _np_zeros(vae),
                                _np_zeros(te), v2=v2, make_dummy_weights=v2)
    _same_layout(ldm, ref)
    assert tldm.detect_v2(ldm) is v2 is jldm.detect_v2(ref)
    inputs = {v.untyped_storage().data_ptr()
              for st in (unet, vae, te) for v in st.values()}
    materialized = {k for k, v in ldm.items()
                    if v.untyped_storage().data_ptr() not in inputs}
    assert materialized == {k for k in ldm if "in_proj" in k
                            or "resblocks.23." in k
                            or k.endswith(("text_projection",
                                           "logit_scale"))}
    back = tldm.ldm_to_diffusers(ldm)
    ref_back = jldm.ldm_to_diffusers(ref)
    for port, jax_side, orig in zip(back, ref_back, (unet, vae, None)):
        _same_layout(port, jax_side)
        if orig is not None:
            _same_layout(port, _np_zeros(orig))
    norm = {k.replace(".encoder.", ".").replace(".embeddings.", "."): v
            for k, v in back[2].items()}
    _same_layout(norm, _np_zeros(te))


def test_vae_reshape_and_open_clip_qkv_values_match_jax():
    """Seeded values through the VAE's mid-attention reshape (linear <->
    1x1 conv) and the open-CLIP q/k/v fuse and split."""
    gen = torch.Generator().manual_seed(14)
    vae = {f"decoder.mid_block.attentions.0.{n}.weight":
           torch.randn(8, 8, generator=gen)
           for n in ("to_q", "to_k", "to_v", "to_out.0")}
    vae["decoder.mid_block.attentions.0.to_q.bias"] = torch.randn(
        8, generator=gen)
    ldm = tldm.vae_diffusers_to_ldm(vae)
    _assert_values(ldm, jldm.vae_diffusers_to_ldm(_numpy(vae)))
    _assert_values(tldm.vae_ldm_to_diffusers(ldm), _numpy(vae))
    te = {f"text_model.layers.{i}.self_attn.{n}.{leaf}":
          torch.randn(*((6, 6) if leaf == "weight" else (6,)), generator=gen)
          for i in range(2) for n in ("q_proj", "k_proj", "v_proj")
          for leaf in ("weight", "bias")}
    te["text_model.token_embedding.weight"] = torch.randn(10, 6,
                                                          generator=gen)
    ldm = tldm.clip_v2_diffusers_to_ldm(te, make_dummy_weights=True)
    ref = jldm.clip_v2_diffusers_to_ldm(_numpy(te), make_dummy_weights=True)
    _assert_values(ldm, ref)
    back = tldm.clip_v2_ldm_to_diffusers(ldm)
    _assert_values(back, jldm.clip_v2_ldm_to_diffusers(ref))
    norm = {k.replace(".encoder.", ".").replace(".embeddings.", "."): v
            for k, v in back.items()}
    _assert_values(norm, _numpy(te))


def _write_tiny_diffusers(root):
    """A tiny diffusers-layout checkpoint of the port's seeded modules."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.init_params(seed=3)
    te = {f"text_model.{k}": v for k, v in pipe.clip.state_dict().items()}
    for sub, state in (("unet/diffusion_pytorch_model.safetensors",
                        {k: v for k, v in pipe.unet.state_dict().items()
                         if ".lora." not in k}),
                       ("vae/diffusion_pytorch_model.safetensors",
                        pipe.vae.state_dict()),
                       ("text_encoder/model.safetensors", te)):
        os.makedirs(os.path.dirname(os.path.join(root, sub)), exist_ok=True)
        save_safetensors(state, os.path.join(root, sub))


def _run_jax_main(fn, argv):
    old = sys.argv
    sys.argv = ["prog"] + argv
    try:
        fn()
    finally:
        sys.argv = old


@pytest.mark.parametrize("v2", [False, True])
def test_converter_clis_and_half_match_jax(tmp_path, v2):
    """Both CLIs with --half on a tiny diffusers directory: the port's
    files hold JAX's keys, float16 types and values."""
    src = str(tmp_path / "sd")
    _write_tiny_diffusers(src)
    flags = ["--v2"] if v2 else []
    outs = {}
    for name, mod, run in (("t", tldm, lambda f, a: f(a)),
                           ("j", jldm, _run_jax_main)):
        single = str(tmp_path / f"{name}.safetensors")
        run(mod.main_to_original, ["--model_path", src, "--checkpoint_path",
                                   single, "--half"] + flags)
        dump = str(tmp_path / f"{name}_dump")
        run(mod.main_to_diffusers, ["--checkpoint_path", single,
                                    "--dump_path", dump, "--half"])
        outs[name] = [load_safetensors(single)] + [
            load_safetensors(os.path.join(dump, sub)) for sub in (
                "unet/diffusion_pytorch_model.safetensors",
                "vae/diffusion_pytorch_model.safetensors",
                "text_encoder/model.safetensors")]
    for port, ref in zip(outs["t"], outs["j"]):
        assert set(port) == set(ref)
        for k in ref:
            assert port[k].dtype == ref[k].dtype == torch.float16, k
            assert torch.equal(port[k], ref[k]), k
    assert tldm.detect_v2(outs["t"][0]) is v2


def test_merge_cli_matches_jax(tmp_path, capsys):
    """`merge_lora` from a diffusers directory with two LoRAs at given
    ratios, fp16, to one single file: JAX's tensors, JAX's metadata but
    the date and title stamps, the content hash of the tensors in the
    order the merge wrote them; --no_metadata
    writes none; a --ratios count that does not match exits."""
    from safetensors import safe_open
    src = str(tmp_path / "sd")
    _write_tiny_diffusers(src)
    gen = torch.Generator().manual_seed(15)
    loras = []
    for i in range(2):
        lo = {}
        for mk in unet_module_keys(tcfg.UNetConfig.tiny())[:6]:
            sd = load_safetensors(os.path.join(
                src, "unet/diffusion_pytorch_model.safetensors"))[
                f"{mk}.weight"]
            d = torch.randn(2, *sd.shape[1:], generator=gen) * 0.1
            u = torch.randn(sd.shape[0], 2, *sd.shape[2:], generator=gen)
            lo[lora_torch_key(mk, "down")], lo[lora_torch_key(mk, "up")] = d, u
        loras.append(str(tmp_path / f"lora{i}.safetensors"))
        save_safetensors(tlay.diffusers_to_webui(lo), loras[-1])
    res = {}
    for name, mod in (("t", tmerge), ("j", jmerge)):
        out = str(tmp_path / f"{name}_merged.safetensors")
        argv = ["--sd_model", src, "--save_to", out, "--models", *loras,
                "--ratios", "0.5", "1.5", "--precision", "fp16"]
        if mod is tmerge:
            mod.main(argv)
        else:
            _run_jax_main(mod.main, argv)
        with safe_open(out, "np") as f:
            meta = f.metadata()
        res[name] = (load_safetensors(out), meta)
    (tt, tmeta), (jt, jmeta) = res["t"], res["j"]
    assert set(tt) == set(jt)
    for k in jt:
        # the deltas' float32 sums may differ in their last bit (the port
        # sums in float64): within one float16 ulp
        assert tt[k].dtype == jt[k].dtype == torch.float16
        ulp = jt[k].float().abs().clamp_min(2.0 ** -14) * 2.0 ** -10
        assert ((tt[k].float() - jt[k].float()).abs() <= ulp).all(), k
    stamps = ("modelspec.date", "modelspec.title", "modelspec.hash_sha256")
    assert {k: v for k, v in tmeta.items() if k not in stamps} == {
        k: v for k, v in jmeta.items() if k not in stamps}
    assert tmeta["modelspec.title"] == "t_merged"
    order = tldm.diffusers_to_ldm(*tmerge.load_sd_states(src))
    assert tmeta["modelspec.hash_sha256"] == \
        tsai.precalculate_safetensors_hashes({k: tt[k] for k in order})
    assert tmeta["modelspec.merged_from"] == "sd, lora0, lora1"
    bare = str(tmp_path / "bare.safetensors")
    tmerge.main(["--sd_model", src, "--save_to", bare, "--models", loras[0],
                 "--no_metadata"])
    assert json.loads(open(bare, "rb").read()[8:8 + int.from_bytes(
        open(bare, "rb").read(8), "little")]).get("__metadata__") is None
    with pytest.raises(SystemExit, match="--ratios"):
        tmerge.main(["--sd_model", src, "--save_to", bare, "--models",
                     *loras, "--ratios", "1.0"])
    capsys.readouterr()
