"""int8 attention (`aqualora_torch/ops/quant.int8_attention`, selected by
`ops/attention.attention_impl("int8")` or `AQUALORA_ATTN_IMPL=int8`)
against the JAX package's (`aqualora_tpu/ops/quant.int8_attention`, its
dispatcher `aqualora_tpu/ops/attention.py`), on the CPU.

The plain version follows JAX's op order; JAX runs jitted on XLA:CPU, whose
exp and division can round a float32 value of S, P or a scale one ulp
apart, and so a P code on a tie the other way.  The tolerances:
- float32: every element within 2e-6 * max|O| but at most 0.1% of them,
  and those within one P code (max|v| / 127: one code of the row's P moves
  O by at most absmax(P) * |v| / 127 <= max|v| / 127);
- bfloat16: the same with one bfloat16 ulp of O (2^-8 * max|O|) in place
  of 2e-6.
The card's kernel is held to the plain version in
`tests/test_torch_port_cuda.py` and `chip_smoke.py` (phase 27a)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.ops import attention as ta
from aqualora_torch.ops import quant as tq
from aqualora_tpu.ops import attention as ja
from aqualora_tpu.ops import quant as jq

KEY = jax.random.PRNGKey(0)
OTHER_VALUES = ("sdpa", "bf16_scores", "identity", "flash_jax")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(q_shape, k_shape, dtype, seed=0):
    """The same q, k, v for both packages (bf16 rounded once, by JAX)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, k_shape, k_shape)]
    if dtype == "bfloat16":
        j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        t = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
             for x in j]
    else:
        j = [jnp.asarray(a) for a in arrays]
        t = [torch.from_numpy(a) for a in arrays]
    return j, t


def _assert_int8_close(got: torch.Tensor, want, v: torch.Tensor, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    top = np.abs(want).max()
    near = (2 ** -8 if dtype == "bfloat16" else 2e-6) * top
    err = np.abs(got - want)
    assert (err > near).mean() <= 1e-3, (err > near).mean()
    assert err.max() <= near + v.float().abs().max().item() / 127, err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_shape,k_shape", [
    ((2, 4, 64, 40), (2, 4, 77, 40)),       # SD-1.5's cross-attention width
    ((2, 2, 64, 64), (2, 2, 64, 64)),       # SD-2.1's heads, self
    ((1, 1, 64, 512), (1, 1, 64, 512))])    # the VAE's single head
def test_int8_attention_plain_matches_jax(q_shape, k_shape, dtype):
    """`int8_attention_plain` against JAX's `int8_attention` under jit (as
    its dispatcher runs it) on the same inputs, in q's type."""
    (jq_, jk, jv), (tq_, tk, tv) = _qkv(q_shape, k_shape, dtype)
    scale = q_shape[-1] ** -0.5
    want = jax.jit(jq.int8_attention, static_argnums=3)(jq_, jk, jv, scale)
    got = tq.int8_attention_plain(tq_, tk, tv, scale)
    assert got.dtype == tq_.dtype
    _assert_int8_close(got, want, tv, dtype)
    # and away from the float attention
    flt = ta.plain_attention(tq_, tk, tv, None, scale).float()
    assert (got.float() - flt).abs().max() > 1e-3


@pytest.mark.parametrize("select", ["env", "context"])
def test_dispatch_sends_unmasked_calls_to_int8_and_masked_to_plain(
        select, monkeypatch):
    """Under AQUALORA_ATTN_IMPL=int8 or inside attention_impl("int8"), in
    both packages: an unmasked call is the int8 attention (the port's
    equal to its plain version, JAX's to its own), a masked call (CLIP's
    causal mask) the plain attention; the two packages agree on both;
    the context wins over the variable, and leaving it restores it."""
    (jq_, jk, jv), (tq_, tk, tv) = _qkv((2, 2, 16, 8), (2, 2, 16, 8),
                                        "float32", seed=1)
    mask = np.tril(np.ones((16, 16), bool))[None, None]
    scale = 8 ** -0.5
    if select == "env":
        monkeypatch.setenv("AQUALORA_ATTN_IMPL", "int8")
        jctx = tctx = None
    else:
        monkeypatch.setenv("AQUALORA_ATTN_IMPL", "xla")
        jctx, tctx = ja.attention_impl("int8"), ta.attention_impl("int8")
    with (jctx or contextlib.nullcontext()), \
            (tctx or contextlib.nullcontext()):
        j_un = ja.dot_product_attention(jq_, jk, jv)
        j_m = ja.dot_product_attention(jq_, jk, jv, mask=jnp.asarray(mask))
        t_un = ta.dot_product_attention(tq_, tk, tv)
        t_m = ta.dot_product_attention(tq_, tk, tv,
                                       mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(
        np.asarray(j_un), np.asarray(jax.jit(
            jq.int8_attention, static_argnums=3)(jq_, jk, jv, scale)))
    torch.testing.assert_close(t_un, tq.int8_attention_plain(tq_, tk, tv,
                                                             scale),
                               rtol=0, atol=0)
    _assert_int8_close(t_un, j_un, tv, "float32")
    torch.testing.assert_close(t_m, ta.plain_attention(
        tq_, tk, tv, torch.from_numpy(mask), scale), rtol=0, atol=0)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=1e-6)
    assert (t_un - t_m).abs().max() > 1e-2
    # outside the context (or with the variable gone) the default path
    monkeypatch.delenv("AQUALORA_ATTN_IMPL")
    assert ta.current_impl() == "auto"
    torch.testing.assert_close(
        ta.dot_product_attention(tq_, tk, tv),
        ta.plain_attention(tq_, tk, tv, None, scale), rtol=1e-5, atol=1e-6)


def test_int8_attention_is_forward_only_in_both_packages(monkeypatch):
    """A gradient through the int8 attention raises NotImplementedError
    naming the forward-only path: JAX's while it traces the gradient, the
    port's when autograd reaches it."""
    (jq_, jk, jv), (tq_, tk, tv) = _qkv((1, 2, 8, 8), (1, 2, 8, 8),
                                        "float32", seed=2)
    monkeypatch.setenv("AQUALORA_ATTN_IMPL", "int8")
    with pytest.raises(NotImplementedError, match="forward-only"):
        jax.grad(lambda q: ja.dot_product_attention(q, jk, jv).sum())(jq_)
    q = tq_.clone().requires_grad_(True)
    out = ta.dot_product_attention(q, tk, tv)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.parametrize("impl", OTHER_VALUES)
def test_unported_implementation_raises(impl, monkeypatch):
    """The JAX package's other values are taken, by the variable and the
    context (tests/test_torch_port_attention_impls.py holds each against
    JAX's); a value the JAX dispatcher does not name raises a ValueError
    naming it, from the variable at the call and from the context when it
    is entered."""
    _, (tq_, tk, tv) = _qkv((1, 1, 4, 8), (1, 1, 4, 8), "float32")
    unknown = impl + "_v2"
    for value, ok in ((impl, True), (unknown, False)):
        monkeypatch.setenv("AQUALORA_ATTN_IMPL", value)
        if ok:
            assert ta.current_impl() == impl
            ta.dot_product_attention(tq_, tk, tv)
            with ta.attention_impl(impl):
                assert ta.current_impl() == impl
            continue
        with pytest.raises(ValueError, match=repr(value)):
            ta.dot_product_attention(tq_, tk, tv)
        monkeypatch.delenv("AQUALORA_ATTN_IMPL")
        with pytest.raises(ValueError, match=repr(value)):
            with ta.attention_impl(value):
                pass
    assert ta.current_impl() == "auto"


def _fill(shapes, seed):
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


# The tiny U-Net with int8 attention, port against JAX, float32.  An
# attention input on a rounding boundary of its int8 grid takes the
# neighbouring code when the float32 arithmetic before it differs in its last
# bit, and the flip carries through the network: JAX against itself under a
# one-ulp nudge of its input moves as much.  So the port is held within
# CHAOS_FACTOR of the largest change JAX's own output makes under nudges of
# its input by -2, -1, +1 and +2 ulps, plus UNET_TOL (the float U-Net's
# parity tolerance), as the int8 convolutions are in
# tests/test_torch_port_quant.py.
UNET_TOL = 1e-4
CHAOS_FACTOR = 4.0
NUDGES = (-2, -1, 1, 2)


def test_tiny_unet_forward_under_int8_attention_matches_jax():
    """The tiny U-Net's forward with every unmasked attention on int8: the
    port inside attention_impl("int8") against JAX's forward traced inside
    its attention_impl("int8")."""
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet

    cfg = jcfg.PipelineConfig.tiny()
    junet = JUNet(cfg.unet)
    params = jax.tree_util.tree_map(np.asarray, _fill(jax.eval_shape(
        lambda: junet.init(KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                           jnp.zeros((1, 77, cfg.unet.cross_attention_dim)),
                           jnp.ones((1, cfg.unet.lora.rank))))["params"], 11))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([981.0, 21.0], np.float32)
    ctx = rng.standard_normal((2, 77, cfg.unet.cross_attention_dim)
                              ).astype(np.float32)
    with ja.attention_impl("int8"):
        run = jax.jit(lambda x: junet.apply({"params": params}, x, t, ctx,
                                            None))
        ref = np.asarray(run(x))
        own = np.stack([np.abs(np.asarray(run(
            x * np.float32(1 + k * 2 ** -23))) - ref) for k in NUDGES])
    port = TUNet(tcfg.PipelineConfig.tiny().unet)
    port.load_state_dict(jax_params_to_torch(params), strict=True)
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx), None)
    with torch.no_grad():
        with ta.attention_impl("int8"):
            out = port(*args).permute(0, 2, 3, 1).numpy()
        flt = port(*args).permute(0, 2, 3, 1).numpy()
    # measured: the port against JAX max 7.3e-4, mean 9.0e-5; JAX's own
    # under the nudges max 1.6e-3, mean 2.3e-4; the float attention 7.7e-3
    # away
    err = np.abs(out - ref)
    assert err.max() <= CHAOS_FACTOR * own.max() + UNET_TOL
    assert err.mean() <= CHAOS_FACTOR * own.mean(axis=(1, 2, 3, 4)).max() \
        + UNET_TOL
    assert np.abs(flt - ref).max() > 4 * (err.max() + UNET_TOL)
