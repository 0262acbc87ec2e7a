"""Module parity: the port's torch modules against the JAX package's, on the
same weights (moved across by `jax_params_to_torch`) and the same inputs,
float32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch, torch_layout

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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, params, batch_stats=None):
    state = jax_params_to_torch(_np(params), _np(batch_stats or {}))
    module.load_state_dict(state, strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_vars(module, *init_args, seed=0):
    """Variables of the module's own structure (jax.eval_shape, no JAX
    init), filled with seeded random numbers: norm scales near 1, small
    biases, kernels N(0, 1/fan_in), nonzero LoRA ups (zero at init, which
    would make every LoRA test vacuous), and BatchNorm statistics away from
    0 / 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(KEY, *init_args))

    def fill(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _run(module, variables, *args, **kw):
    """module.apply under jit (one XLA compile instead of op-by-op)."""
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *args))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _lora(rank=4):
    from aqualora_torch.core.config import LoRAConfig as TL
    from aqualora_tpu.core.config import LoRAConfig as JL
    return JL(rank=rank), TL(rank=rank)


def test_resnet_block_parity():
    from aqualora_torch.models.layers import ResnetBlock2D as TRes
    from aqualora_tpu.models.layers import ResnetBlock2D as JRes

    x, temb = _rand(1, 2, 8, 8, 16), _rand(2, 2, 12)
    blk = JRes(24, 8)
    params = _random_vars(blk, x, temb, seed=3)["params"]
    port = _load(TRes(16, 24, 8, 1e-5, temb_dim=12), params)
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(_nhwc(out), _run(blk, {"params": params}, x,
                                                temb), atol=2e-5)


@pytest.mark.parametrize("scale_kind", ["none", "float", "diag"])
def test_attention_lora_parity(scale_kind):
    """LoRA's three DiagScale meanings: None skips the branch, a float is
    standard LoRA, [B, rank] modulates per sample."""
    from aqualora_torch.models.layers import Attention as TAttn
    from aqualora_tpu.models.layers import Attention as JAttn

    jl, tl = _lora()
    x, ctx = _rand(3, 2, 10, 32), _rand(4, 2, 7, 24)
    attn = JAttn(32, 4, 24, lora=jl)
    params = _random_vars(attn, x, ctx, 1.0, seed=5)["params"]
    diag = _rand(6, 2, 4)
    j_scale, t_scale = {"none": (None, None), "float": (0.7, 0.7),
                        "diag": (jnp.asarray(diag), torch.from_numpy(diag))
                        }[scale_kind]
    port = _load(TAttn(32, 4, 24, lora=tl), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(ctx), t_scale)
    ref = attn.apply({"params": params}, x, ctx, j_scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    if scale_kind != "none":        # the LoRA branch really contributes
        plain = attn.apply({"params": params}, x, ctx, None)
        assert np.abs(np.asarray(ref) - np.asarray(plain)).max() > 1e-3


def test_transformer2d_lora_parity():
    """GroupNorm eps 1e-6, LoRA convs (proj_in/out), LayerNorms, GEGLU with
    the tanh GELU, under a per-sample diagonal."""
    from aqualora_torch.models.layers import Transformer2DModel as TT
    from aqualora_tpu.models.layers import Transformer2DModel as JT

    jl, tl = _lora()
    x, ctx, diag = _rand(7, 2, 4, 4, 16), _rand(8, 2, 5, 8), _rand(9, 2, 4)
    t2d = JT(16, 2, 8, groups=4, lora=jl)
    params = _random_vars(t2d, x, ctx, jnp.ones((2, 4)), seed=10)["params"]
    port = _load(TT(16, 2, 8, groups=4, lora=tl), params)
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(ctx), torch.from_numpy(diag))
    ref = _run(t2d, {"params": params}, x, ctx, jnp.asarray(diag))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def tiny_unet():
    from aqualora_tpu.core.config import PipelineConfig
    from aqualora_tpu.models.unet import UNet2DConditionModel

    cfg = PipelineConfig.tiny().unet
    unet = UNet2DConditionModel(cfg)
    x = jnp.zeros((1, 8, 8, 4))
    ctx = jnp.zeros((1, 77, cfg.cross_attention_dim))
    params = _random_vars(unet, x, jnp.zeros((1,)), ctx,
                          jnp.ones((1, cfg.lora.rank)), seed=11)["params"]
    return cfg, unet, params


@pytest.mark.parametrize("with_diag", [False, True])
def test_unet_tiny_parity(tiny_unet, with_diag):
    from aqualora_torch.core.config import PipelineConfig as TPC
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet

    cfg, unet, params = tiny_unet
    x, ctx = _rand(12, 2, 8, 8, 4), _rand(13, 2, 77, cfg.cross_attention_dim)
    t = np.array([981.0, 21.0], np.float32)
    diag = _rand(14, 2, cfg.lora.rank) if with_diag else None
    port = _load(TUNet(TPC.tiny().unet), params)
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   None if diag is None else torch.from_numpy(diag))
    ref = _run(unet, {"params": params}, x, t, ctx,
               None if diag is None else jnp.asarray(diag))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4)


def test_fold_equals_runtime_lora(tiny_unet):
    """Folding one message's diagonal into the weights equals applying it
    at run time, in the port; stripping afterwards changes nothing."""
    from aqualora_torch.core.config import PipelineConfig as TPC
    from aqualora_torch.models.lora import fold_lora_tree, strip_lora_params
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet

    cfg, _, params = tiny_unet
    port = _load(TUNet(TPC.tiny().unet), params)
    x = _nchw(_rand(15, 1, 8, 8, 4))
    ctx = torch.from_numpy(_rand(16, 1, 77, cfg.cross_attention_dim))
    t = torch.tensor([100.0])
    diag = torch.from_numpy(_rand(17, cfg.lora.rank)) + 1.0
    with torch.no_grad():
        base = port(x, t, ctx, None)
        runtime = port(x, t, ctx, diag[None] * 1.03)
        fold_lora_tree(port, diag, multiplier=1.03)
        folded = port(x, t, ctx, None)
        strip_lora_params(port)
        stripped = port(x, t, ctx, None)
    np.testing.assert_allclose(folded.numpy(), runtime.numpy(), atol=1e-4)
    assert (folded - base).abs().max() > 1e-2
    assert torch.equal(stripped, folded)
    assert not any("lora" in k for k in port.state_dict())


CLIP_VARIANTS = {
    "sd15": lambda c: c.CLIPTextConfig.tiny(),
    # the SD-2 tower's switches: GELU (tanh, as flax's) and the penultimate
    # layer's output
    "sd2": lambda c: dataclasses.replace(c.CLIPTextConfig.tiny(),
                                         hidden_act="gelu", penultimate=True),
    # the text-encoder LoRA, applied at float scale 1.0 as the pipelines do
    "te_lora": lambda c: c.CLIPTextConfig.tiny().with_lora(4),
}


@pytest.mark.parametrize("variant", sorted(CLIP_VARIANTS))
def test_clip_parity(variant):
    import aqualora_torch.core.config as tcfg
    import aqualora_tpu.core.config as jcfg
    from aqualora_torch.models.clip import CLIPTextModel as TClip
    from aqualora_tpu.models.clip import CLIPTextModel as JClip

    jc, tc = CLIP_VARIANTS[variant](jcfg), CLIP_VARIANTS[variant](tcfg)
    scale = 1.0 if variant == "te_lora" else None
    ids = np.random.default_rng(18).integers(0, 1000, (2, 77)).astype(np.int32)
    clip = JClip(jc)
    params = _random_vars(clip, jnp.asarray(ids), scale, seed=18)["params"]
    port = _load(TClip(tc), params)
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), scale)
    np.testing.assert_allclose(out.numpy(), _run(
        clip, {"params": params}, jnp.asarray(ids), scale), atol=1e-4)


def test_vae_decoder_parity():
    from aqualora_torch.core.config import VAEConfig as TV
    from aqualora_torch.models.vae import AutoencoderKL as TVae
    from aqualora_tpu.core.config import VAEConfig as JV
    from aqualora_tpu.models.vae import AutoencoderKL as JVae

    vae = JVae(JV.tiny())
    params = _random_vars(vae, jnp.zeros((1, 16, 16, 3)), KEY,
                          seed=19)["params"]
    z = _rand(19, 2, 8, 8, 4)
    port = _load(TVae(TV.tiny()), params)
    with torch.no_grad():
        out = port.decode(_nchw(z))
    ref = _run(vae, {"params": params}, z, method="decode")
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4)


def test_secret_decoder_parity():
    """Tiny EfficientNet SecretDecoder in eval mode, with non-trivial
    BatchNorm statistics moved across as running_mean / running_var."""
    from aqualora_torch.core.config import EfficientNetConfig as TE
    from aqualora_torch.models.watermark import SecretDecoder as TDec
    from aqualora_tpu.core.config import EfficientNetConfig as JE
    from aqualora_tpu.models.watermark import SecretDecoder as JDec

    dec = JDec(8, JE.tiny())
    x = np.tanh(_rand(20, 2, 32, 32, 3))
    variables = _random_vars(dec, jnp.asarray(x), False, seed=21)
    port = _load(TDec(8, TE.tiny(), device="cpu"), variables["params"],
                 variables["batch_stats"])
    with torch.no_grad():
        out = port(_nchw(x))
    ref = _run(dec, variables, jnp.asarray(x), train=False)
    assert out.shape == (2, 8, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_mapper_parity():
    from aqualora_torch.models.watermark import MapperNet as TMap
    from aqualora_tpu.models.watermark import MapperNet as JMap

    msg = (np.random.default_rng(22).random((3, 48)) > 0.5).astype(np.float32)
    mapper = JMap(48, 320, std=0.5)
    params = mapper.init(KEY, jnp.asarray(msg))["params"]
    port = _load(TMap(48, 320, std=0.5), params)
    with torch.no_grad():
        out = port(torch.from_numpy(msg))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        mapper.apply({"params": params}, jnp.asarray(msg))), atol=1e-5)
    # the port's own init bakes std into the weight, as the JAX one does
    w = TMap(48, 320, std=0.5).bit_embeddings.weight
    np.testing.assert_allclose(w.std(dim=1).detach().numpy(), 0.5, rtol=1e-4)


def test_bilinear_resize_parity():
    from aqualora_torch.ops.resize import bilinear_resize as tresize
    from aqualora_tpu.ops.resize import bilinear_resize as jresize

    x = _rand(23, 2, 13, 17, 3)
    for h, w in ((32, 24), (7, 9), (13, 17)):
        out = tresize(_nchw(x), h, w)
        np.testing.assert_allclose(_nhwc(out), np.asarray(jresize(
            jnp.asarray(x), h, w)), atol=1e-5)


def _shape_layout(shapes, batch_stats=None):
    """torch-layout keys and shapes of an eval_shape tree, no memory."""
    def zeros(s):
        return np.broadcast_to(np.zeros((), np.float32), s.shape)
    layout = torch_layout(jax.tree_util.tree_map(zeros, shapes),
                          jax.tree_util.tree_map(zeros, batch_stats or {}))
    return {k: tuple(a.shape) for k, a in layout.items()}


def test_sd21_full_size_keys_and_shapes():
    """SD-2.1's U-Net (64-dim heads, 1024-wide context) and OpenCLIP-H
    text tower at full width, on the meta device."""
    from aqualora_torch.core.config import PipelineConfig as TPC
    from aqualora_torch.models.clip import CLIPTextModel as TClip
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_tpu.core.config import PipelineConfig as JPC
    from aqualora_tpu.models.clip import CLIPTextModel as JClip
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet

    jcfg, tcfg = JPC.sd21(lora_rank=320), TPC.sd21(lora_rank=320)
    u_shapes = jax.eval_shape(lambda: JUNet(jcfg.unet).init(
        KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 1024)), jnp.ones((1, 320))))["params"]
    c_shapes = jax.eval_shape(lambda: JClip(jcfg.clip).init(
        KEY, jnp.zeros((1, 77), jnp.int32)))["params"]
    with torch.device("meta"):
        unet, clip = TUNet(tcfg.unet), TClip(tcfg.clip)
    for module, shapes in ((unet, u_shapes), (clip, c_shapes)):
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == _shape_layout(shapes)


def test_sd15_full_size_keys_and_shapes():
    """The port's SD-1.5 modules, built on the meta device at full width
    (rank-320 LoRA, EfficientNet-B1), hold exactly the JAX package's
    parameters under the converted names."""
    from aqualora_torch.core.config import (EfficientNetConfig as TE,
                                            PipelineConfig as TPC)
    from aqualora_torch.models.clip import CLIPTextModel as TClip
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_torch.models.vae import AutoencoderKL as TVae
    from aqualora_torch.models.watermark import (MapperNet as TMap,
                                                 SecretDecoder as TDec)
    from aqualora_tpu.core.config import (EfficientNetConfig as JE,
                                          PipelineConfig as JPC)
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.models.watermark import SecretDecoder as JDec

    jcfg, tcfg = JPC.sd15(lora_rank=320), TPC.sd15(lora_rank=320)
    pipe = StableDiffusionPipeline(jcfg)
    shapes = jax.eval_shape(lambda: pipe.init_params(KEY, 64, 64))
    dec_shapes = jax.eval_shape(lambda: JDec(48, JE.b1()).init(
        KEY, jnp.zeros((1, 64, 64, 3)), False))
    with torch.device("meta"):
        port = {"unet": TUNet(tcfg.unet), "text_encoder": TClip(tcfg.clip),
                "vae": TVae(tcfg.vae), "mapper": TMap(48, 320),
                "decoder": TDec(48, TE.b1(), device="meta")}
    expected = {name: _shape_layout(shapes[name]) for name in
                ("unet", "text_encoder", "vae", "mapper")}
    expected["decoder"] = _shape_layout(dec_shapes["params"],
                                        dec_shapes["batch_stats"])
    for name, module in port.items():
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == expected[name], name
    n_unet = sum(p.numel() for p in port["unet"].parameters())
    assert n_unet == sum(int(np.prod(s)) for s in expected["unet"].values())
    assert sum(1 for k in expected["unet"] if k.endswith("lora.down.weight")
               ) == 192     # the reference's 192 LoRA sites


def test_vae_encoder_parity():
    """The tiny VAE encoder (asymmetric-padded downsamplers, mid-block
    attention, eps 1e-6), quant_conv, the clipped posterior and its
    sampling formula against the JAX module's methods."""
    from aqualora_torch.core.config import VAEConfig as TV
    from aqualora_torch.models.vae import AutoencoderKL as TVae
    from aqualora_tpu.core.config import VAEConfig as JV
    from aqualora_tpu.models.vae import AutoencoderKL as JVae

    vae = JVae(JV.tiny())
    params = _random_vars(vae, jnp.zeros((1, 16, 16, 3)), KEY,
                          seed=24)["params"]
    x = np.tanh(_rand(25, 2, 16, 16, 3))
    noise = _rand(26, 2, 8, 8, 4)
    port = _load(TVae(TV.tiny()), params)
    with torch.no_grad():
        mean, logvar = port.encode_moments(_nchw(x))
        sample = port.sample_from_moments(mean, logvar, _nchw(noise))
        mode = port.encode(_nchw(x))
    j_mean, j_logvar = _run_pair(vae, params, x)
    j_sample = vae.sample_from_moments(jnp.asarray(j_mean),
                                       jnp.asarray(j_logvar),
                                       jnp.asarray(noise))
    for got, want in ((mean, j_mean), (logvar, j_logvar), (mode, j_mean),
                      (sample, j_sample)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)
    assert np.abs(j_mean).max() > 0.1 and mean.shape == (2, 4, 8, 8)


def _run_pair(vae, params, x):
    return [np.asarray(a) for a in jax.jit(lambda p, x: vae.apply(
        {"params": p}, x, method="encode_moments"))(params, jnp.asarray(x))]


@pytest.mark.parametrize("resolution,latent", [(16, 16), (32, 12)])
def test_secret_encoder_parity(resolution, latent):
    """SecretEncoder: dense, SiLU, channel repeat, nearest upsample, the
    3x3 conv (made non-zero here) and the bilinear resize to the latent,
    loaded strictly from the JAX tree (`secret_dense`, `conv_out`)."""
    from aqualora_torch.models.watermark import SecretEncoder as TEnc
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc

    enc = JEnc(8, base_res=8, resolution=resolution)
    x = _rand(27, 2, latent, latent, 4)
    msg = (np.random.default_rng(28).random((2, 8)) > 0.5).astype(np.float32)
    params = _random_vars(enc, jnp.asarray(x), jnp.asarray(msg),
                          seed=29)["params"]
    port = _load(TEnc(8, base_res=8, resolution=resolution), params)
    with torch.no_grad():
        out, c = port(_nchw(x), torch.from_numpy(msg))
    j_out, j_c = enc.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(msg))
    np.testing.assert_allclose(_nhwc(out), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(_nhwc(c), np.asarray(j_c), atol=1e-5)
    assert np.abs(np.asarray(j_c)).max() > 1e-2


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_lora_float32_weights_under_bf16(kind):
    """float32 LoRA weights under bfloat16 compute: the LoRA layers cast
    their weights to the activation's type at every call, as flax's `dtype=`
    does (the PPFT trainer keeps float32 trainables over a bf16 U-Net).  The
    float32 diagonal multiplies in float32 before the up layer, as on the
    JAX side.  Both sides round to bf16 at other places, so the limit is
    four bf16 ulps at the reference's largest value."""
    from aqualora_torch.models.lora import LoRAConv2d, LoRALinear
    from aqualora_tpu.models.lora import LoRAConv, LoRADense

    jl, tl = _lora()
    diag = 1.0 + _rand(30, 2, 4)
    if kind == "dense":
        x = _rand(31, 2, 6, 16)
        jmod = LoRADense(24, lora=jl, dtype=jnp.bfloat16)
        port = LoRALinear(16, 24, lora=tl)
        to_t = torch.from_numpy
        back = lambda t: t.float().numpy()
    else:
        x = _rand(31, 2, 5, 5, 16)
        jmod = LoRAConv(24, lora=jl, dtype=jnp.bfloat16)
        port = LoRAConv2d(16, 24, lora=tl)
        to_t = _nchw
        back = lambda t: _nhwc(t.float())
    params = _random_vars(jmod, jnp.asarray(x), jnp.asarray(diag),
                          seed=32)["params"]
    _load(port, params)
    for name, p in port.named_parameters():     # bf16 base, f32 LoRA
        if ".lora." not in f".{name}":
            p.data = p.data.bfloat16()
    assert port.lora.up.weight.dtype == torch.float32
    with torch.no_grad():
        out = port(to_t(x).bfloat16(), torch.from_numpy(diag))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jmod.apply({"params": params},
                                jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(diag))).astype(np.float32)
    tol = 4 * 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(back(out), ref, atol=tol)
