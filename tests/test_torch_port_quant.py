"""The port's w8a8 int8 path (`aqualora_torch/ops/quant.py` and the modules
that take it) against the JAX package's `aqualora_tpu/ops/quant.py`, on the
CPU.

The quantizer and the int8 products are exact arithmetic (the absmax, one
IEEE division, round half to even, int32 sums), so the port's plain path is
held to JAX's bit for bit: weight and activation codes and scales, the
int8 convolution and dense outputs, a quantized layer with its bias, the
sites each rule selects and JAX's int8 tree loaded strictly.  Through a
whole network the two sides' float32 arithmetic differs in the last bits
(GroupNorm, attention), and an activation on a rounding boundary of its
int8 grid then takes the neighbouring code: the tiny U-Net is held at the
tolerances stated with its test.  The card's kernels are held to the plain path by
`chip_smoke.py` (phase 24) and tests/test_torch_port_cuda.py.
`simple_sample`'s modes and the `--teacher_int8` loss are in
tests/test_torch_port_quant_paths.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch, torch_key
from aqualora_torch.ops import quant as tq
from aqualora_tpu.ops import quant as jq

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill(shapes, seed):
    """Seeded random leaves for an eval_shape tree: norm scales 1, biases
    N(0, 0.1^2), everything else N(0, 1/fan_in), so every LoRA up weight is
    non-zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = torch.from_numpy(np.asarray(jnp.asarray(want).astype(jnp.float32))
                            if np.asarray(want).dtype.name == "bfloat16"
                            else np.array(want))
    return torch.equal(got.float() if got.dtype == torch.bfloat16 else got,
                       want)


# ---------------------------------------------------------------------------
# the quantizer and the products, bit for bit
# ---------------------------------------------------------------------------

def _weight(kind):
    """A weight in JAX's layout (HWIO or [in, out]) with an all-zero output
    channel, a channel whose values sit exactly half-way between codes
    (absmax 127, scale 1: 0.5, 1.5, 2.5 ... round half to even) and random
    channels."""
    rng = np.random.default_rng(1)
    shape = (3, 3, 16, 6) if kind == "conv" else (24, 6)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    w[..., 0] = 0.0
    half = np.arange(w[..., 1].size, dtype=np.float32) % 9 - 4.5
    half.flat[0] = 127.0
    w[..., 1] = half.reshape(w[..., 1].shape)
    return w


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_weight_codes_and_scales_match_jax(kind):
    """Per output channel: JAX's HWIO / [in, out] codes transposed to
    OIHW / [out, in] and its scale, bit for bit, the all-zero channel at
    the 1e-12 floor and the half-way values rounded to even."""
    w = _weight(kind)
    jcodes, jscale = jq.quantize_kernel_int8(w)
    tw = _t(w).permute(3, 2, 0, 1) if kind == "conv" else _t(w).T
    codes, scale = tq.quantize_weight(tw)
    want = (_t(jcodes).permute(3, 2, 0, 1) if kind == "conv"
            else _t(jcodes).T)
    assert codes.dtype == torch.int8 and torch.equal(codes, want)
    assert scale.dtype == torch.float32 and torch.equal(scale, _t(jscale))
    assert scale[0].item() == np.float32(np.float32(1e-12) / 127)
    assert scale[1].item() == 1.0
    assert set(codes[1].flatten().tolist()) >= {-4, -2, 0, 2, 4, 127}
    if kind == "conv":          # the kernel's channels-last order
        assert codes.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per", ["image", "token"])
def test_activation_codes_and_scales_match_jax(dtype, per):
    """Per image over C*H*W (a convolution's input) and per token over the
    last axis (a dense layer's), in float32 and bfloat16, with an all-zero
    image or token: codes and scales bit for bit."""
    rng = np.random.default_rng(2)
    if per == "image":
        x = rng.standard_normal((3, 6, 5, 16)).astype(np.float32)   # NHWC
        x[1] = 0.0
        jx = jnp.asarray(x, dtype)
        jcodes, jscale = jq._quantize_activations(jx, axes=(1, 2, 3))
        tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype)).permute(0, 3, 1, 2)
        codes, scale = tq.quantize_activations(tx)
        assert torch.equal(codes, _t(jcodes).permute(0, 3, 1, 2))
        assert codes.is_contiguous(memory_format=torch.channels_last)
    else:
        x = rng.standard_normal((4, 7, 24)).astype(np.float32)
        x[2, 3] = 0.0
        jx = jnp.asarray(x, dtype)
        jcodes, jscale = jq._quantize_activations(jx, axes=-1)
        tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype))
        codes, scale = tq.quantize_activations_plain(tx.reshape(-1, 24))
        assert torch.equal(codes, _t(jcodes).reshape(-1, 24))
    assert torch.equal(scale, _t(jscale).reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_int8_conv_matches_jax(dtype, k, stride, pad):
    """`int8_conv` (3x3 stride 1 and 2 with padding 1, 1x1) on the same
    float input and int8 weight: the output bit for bit in the activation's
    type, on odd sides (ragged stride 2)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 7, 16)).astype(np.float32)
    w = (rng.standard_normal((k, k, 16, 24)) / (4 * k)).astype(np.float32)
    jcodes, jscale = jq.quantize_kernel_int8(w)
    jx = jnp.asarray(x, dtype)
    ref = jq.int8_conv(jx, jcodes, jscale, (stride, stride),
                       ((pad, pad), (pad, pad)), out_dtype=jnp.dtype(dtype))
    codes, scale = tq.quantize_weight(_t(w).permute(3, 2, 0, 1))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    out = tq.int8_conv(tx, codes, scale, None, stride, pad)
    assert out.dtype == getattr(torch, dtype)
    assert _bits_equal(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(dtype):
    """`int8_dense` over [B, T, in]: one activation scale per token, the
    output bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) / 6).astype(np.float32)
    jcodes, jscale = jq.quantize_kernel_int8(w)
    jx = jnp.asarray(x, dtype)
    ref = jq.int8_dense(jx, jcodes, jscale, out_dtype=jnp.dtype(dtype))
    codes, scale = tq.quantize_weight(_t(w).T)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = tq.int8_dense(tx, codes, scale)
    assert out.shape == (2, 5, 24) and _bits_equal(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_layers_with_bias_match_jax(dtype):
    """`layers.Conv2d` and `lora.LoRALinear` holding JAX's int8 params
    (loaded strictly) against `layers.Conv2D` and `LoRADense`: the int8
    result, then the bias in the module's type, bit for bit."""
    from aqualora_torch.models.layers import Conv2d
    from aqualora_torch.models.lora import LoRALinear
    from aqualora_tpu.models.layers import Conv2D
    from aqualora_tpu.models.lora import LoRADense

    rng = np.random.default_rng(5)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 6, 6, 16)), jdt)
    jconv = Conv2D(24, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                   dtype=jdt)
    cp = _fill(jax.eval_shape(lambda: jconv.init(KEY, x)), 6)["params"]
    q, s = jq.quantize_kernel_int8(cp["kernel"])
    cp = {"kernel": q, "kernel_scale": s, "bias": cp["bias"]}
    conv = Conv2d(16, 24, 3, stride=2, padding=1)
    tq.quantize_layer_(conv)
    conv.load_state_dict(jax_params_to_torch(_np(cp)), strict=True)
    conv.bias.data = conv.bias.data.to(getattr(torch, dtype))
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    out = conv(tx)
    assert _bits_equal(out.permute(0, 2, 3, 1),
                       jconv.apply({"params": cp}, x))

    xd = jnp.asarray(rng.standard_normal((2, 5, 16)), jdt)
    jdense = LoRADense(24, dtype=jdt)
    dp = _fill(jax.eval_shape(lambda: jdense.init(KEY, xd)), 7)["params"]
    q, s = jq.quantize_kernel_int8(dp["kernel"])
    dp = {"kernel": q, "kernel_scale": s, "bias": dp["bias"]}
    dense = LoRALinear(16, 24)
    tq.quantize_layer_(dense)
    dense.load_state_dict(jax_params_to_torch(_np(dp)), strict=True)
    out = dense(torch.from_numpy(np.asarray(xd.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert _bits_equal(out, jdense.apply({"params": dp}, xd))


def test_weight_scale_stays_float32_through_casts():
    """`module.to(bfloat16)` keeps a quantized layer's codes int8 and its
    scale float32 (JAX keeps `kernel_scale` float32), the bias cast."""
    from aqualora_torch.models.layers import Conv2d
    conv = Conv2d(16, 8, 3, padding=1)
    tq.quantize_layer_(conv)
    scale = conv.weight_scale.detach().clone()
    conv.to(torch.bfloat16)
    assert conv.weight.dtype == torch.int8
    assert conv.weight_scale.dtype == torch.float32
    assert torch.equal(conv.weight_scale, scale)
    assert conv.bias.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the conversions: the sites, the int8 tree, the tiny U-Net
# ---------------------------------------------------------------------------

def _jax_int8_keys(shapes, fn):
    """torch keys of the weights JAX's conversion quantizes, from shapes
    alone (jax.eval_shape)."""
    import flax.traverse_util as tu
    out = jax.eval_shape(fn, shapes)
    return {torch_key(p[:-1] + ("weight",)) for p in tu.flatten_dict(out)
            if p[-1] == "kernel_scale"}


def _unet_shapes(cfg):
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet
    return jax.eval_shape(lambda: JUNet(cfg.unet).init(
        KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, cfg.unet.cross_attention_dim)),
        jnp.ones((1, cfg.unet.lora.rank))))["params"]


TOGGLES = [(True, True), (True, False), (False, True)]


def _tiny(cfgmod, model):
    """The tiny pipeline config; as SD-2.1, its U-Net with SD-2.1's
    switches (heads of a fixed width, v-prediction)."""
    cfg = cfgmod.PipelineConfig.tiny()
    if model == "sd21":
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, head_dim=16, prediction_type="v_prediction"))
    return cfg


@pytest.mark.parametrize("model", ["sd15", "sd21"])
def test_quantized_sites_match_jax(model):
    """The weights each rule quantizes, under each include toggle, equal
    JAX's mapped through `torch_key` (rank and name: a 2-D `proj_in` would
    stay float), for the tiny U-Net as SD-1.5 and as SD-2.1, and for the
    VAE decoder (JAX's from shapes alone, `jax.eval_shape`)."""
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_torch.models.vae import AutoencoderKL as TVae
    from aqualora_tpu.models.vae import AutoencoderKL as JVae

    jc, tc = _tiny(jcfg, model), _tiny(tcfg, model)
    shapes = _unet_shapes(jc)
    unet, vae = TUNet(tc.unet), TVae(tc.vae)
    for conv, dense in TOGGLES:
        want = _jax_int8_keys(shapes, functools.partial(
            jq.quantize_unet_params_int8, include_convs=conv,
            include_dense=dense))
        got = {f"{n}.weight" for n, _ in tq.int8_sites(unet, conv, dense)}
        assert got == want, (conv, dense)
    vshapes = jax.eval_shape(lambda: JVae(jc.vae).init(
        KEY, jnp.zeros((1, 16, 16, 3)), KEY))["params"]
    want = _jax_int8_keys(vshapes, jq.quantize_vae_decoder_params_int8)
    got = {f"decoder.{n}.weight" for n, _ in
           tq.int8_sites(vae.decoder, include_dense=False)}
    assert got == want and all(k.startswith("decoder.") for k in got)


@pytest.mark.parametrize("model", ["sd15", "sd21"])
def test_full_width_site_counts(model):
    """At full width (on the meta device) the rule finds what JAX's finds
    in SD-1.5 and SD-2.1: 96 conv sites (50 3x3, 46 1x1), 160 dense sites
    and 33 VAE-decoder convs; every one an int8-aware layer."""
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_torch.models.vae import AutoencoderKL as TVae
    cfg = getattr(tcfg.PipelineConfig, model)(lora_rank=320)
    with torch.device("meta"):
        unet, vae = TUNet(cfg.unet), TVae(cfg.vae)
    convs = tq.int8_sites(unet, include_dense=False)
    dense = tq.int8_sites(unet, include_convs=False)
    k3 = sum(m.weight.shape[-1] == 3 for _, m in convs)
    dec = tq.int8_sites(vae.decoder, include_dense=False)
    assert (len(convs), k3, len(dense), len(dec)) == (96, 50, 160, 33)


@pytest.fixture(scope="module")
def pipe_params():
    """Seeded float weights of the tiny pipeline (numpy leaves); the U-Net's
    from seed 11, whose int8 forward at `_unet_inputs` puts no activation
    on a rounding boundary with convs or dense layers alone (see
    UNET_TOL)."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    jpipe = StableDiffusionPipeline(jcfg.PipelineConfig.tiny())
    params = _np(_fill(jax.eval_shape(lambda: jpipe.init_params(
        KEY, 32, 32)), 5))
    params["unet"] = _np(_fill(_unet_shapes(jcfg.PipelineConfig.tiny()), 11))
    return params


@pytest.fixture(scope="module")
def jax_int8(pipe_params):
    """JAX's conversions of `pipe_params`, run eagerly once each and
    shared: ("unet", include_convs, include_dense) and ("vae",).  JAX's
    simple_sample runs them under jit, where XLA:CPU computes absmax / 127
    as a product with the reciprocal and some scales come out one ulp apart
    (60 of the tiny U-Net's 71 sites); the port computes the division as
    written, as the eager conversion does."""
    cache = {}

    def get(*key):
        if key not in cache:
            cache[key] = _np(
                jq.quantize_unet_params_int8(pipe_params["unet"], *key[1:])
                if key[0] == "unet" else
                jq.quantize_vae_decoder_params_int8(pipe_params["vae"]))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def tiny_unet(pipe_params):
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet
    return JUNet(jcfg.PipelineConfig.tiny().unet), pipe_params["unet"]


def test_jax_int8_tree_loads_strictly_and_equals_the_ports(tiny_unet,
                                                           jax_int8):
    """JAX's quantized tree crosses through `jax_params_to_torch` (int8
    HWIO -> int8 OIHW, kernel_scale -> weight_scale) into a quantized port
    U-Net strictly, and equals the port's own quantization of the float
    weights tensor for tensor; a float U-Net refuses it, and its own float
    state dict loads back into it."""
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    _, params = tiny_unet
    jtree = jax_int8("unet", True, True)
    mine = TUNet(tcfg.PipelineConfig.tiny().unet)
    mine.load_state_dict(jax_params_to_torch(params), strict=True)
    floats = {k: v.clone() for k, v in mine.state_dict().items()}
    keys = tq.quantize_unet_int8(mine)
    port = TUNet(tcfg.PipelineConfig.tiny().unet)
    tq.quantize_unet_int8(port)
    state = jax_params_to_torch(jtree)
    port.load_state_dict(state, strict=True)
    assert all(port.state_dict()[k].dtype == torch.int8 for k in keys)
    ours = mine.state_dict()
    assert set(ours) == set(state)
    assert all(torch.equal(ours[k], state[k]) for k in state)
    fresh = TUNet(tcfg.PipelineConfig.tiny().unet)
    with pytest.raises(RuntimeError, match="weight_scale"):
        fresh.load_state_dict(state, strict=True)
    fresh.load_state_dict(floats, strict=True)


def _unet_inputs(cfg):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.unet.cross_attention_dim)
                              ).astype(np.float32)
    return x, np.array([981.0, 21.0], np.float32), ctx


# The tiny int8 U-Net, port against JAX (float32).  With convs or dense
# layers quantized alone, at these seeded weights and inputs, no activation
# sits on a rounding boundary of its int8 grid and the two agree to float32
# rounding (measured: max |d| 1.7e-6 and 2.1e-6 over outputs up to 1.5):
# the float U-Net's parity tolerance holds.  (Elsewhere an activation on a
# boundary takes the neighbouring code when the float32 arithmetic before
# it differs in its last bit, and the flip cascades through the network:
# JAX against itself under a one-ulp nudge of its input moves as much.)
# With both quantized, the network flips at these inputs too: the port is
# held within CHAOS_FACTOR of the largest change JAX's own output makes
# under nudges of its input by -2, -1, +1 and +2 ulps (measured: JAX's own
# max 0.060, mean 0.016; the port against JAX max 0.054, mean 0.015).
UNET_TOL = 1e-4
CHAOS_FACTOR = 4.0
NUDGES = (-2, -1, 1, 2)


@pytest.mark.parametrize("mode", ["conv", "dense", "all"])
def test_tiny_unet_int8_forward_matches_jax(tiny_unet, jax_int8, mode):
    """The tiny U-Net loaded from JAX's int8 tree (the convs, the dense
    layers, or both) on the same inputs against the JAX U-Net, the convs
    also under the LoRA diagonal (the delta added on top of the int8 base,
    as stage 3's --int8_gen runs it); and away from the float path (the
    port's float U-Net equals JAX's to 2e-6)."""
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    junet, params = tiny_unet
    cfg = jcfg.PipelineConfig.tiny()
    toggles = (mode != "dense", mode != "conv")
    jtree = jax_int8("unet", *toggles)
    port = TUNet(tcfg.PipelineConfig.tiny().unet)
    floats = TUNet(tcfg.PipelineConfig.tiny().unet)
    floats.load_state_dict(jax_params_to_torch(params), strict=True)
    tq.quantize_unet_int8(port, *toggles)
    port.load_state_dict(jax_params_to_torch(jtree), strict=True)
    x, t, ctx = _unet_inputs(cfg)
    diag = np.random.default_rng(13).standard_normal(
        (2, cfg.unet.lora.rank)).astype(np.float32)
    run = jax.jit(lambda x, d: junet.apply({"params": jtree}, x, t, ctx, d))
    for d in (None, diag) if mode == "conv" else (None,):
        jd = None if d is None else jnp.asarray(d)
        ref = np.asarray(run(x, jd))
        args = (_t(x).permute(0, 3, 1, 2), _t(t), _t(ctx),
                None if d is None else _t(d))
        with torch.no_grad():
            out = port(*args).permute(0, 2, 3, 1).numpy()
            flt = floats(*args).permute(0, 2, 3, 1).numpy()
        err = np.abs(out - ref)
        if mode == "all":
            own = np.stack([np.abs(np.asarray(run(
                x * np.float32(1 + k * 2 ** -23), jd)) - ref)
                for k in NUDGES])
            assert err.max() <= CHAOS_FACTOR * own.max() + UNET_TOL
            assert err.mean() <= CHAOS_FACTOR * own.mean(
                axis=(1, 2, 3, 4)).max() + UNET_TOL
        else:
            assert err.max() <= UNET_TOL, err.max()
        assert np.abs(flt - ref).max() > 1e-2
