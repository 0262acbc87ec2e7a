"""The attention dispatcher's values that JAX has beside the kernels
(`sdpa`, `bf16_scores`, `identity`, `flash_jax`; `aqualora_torch/ops/
attention.py`) and the PPFT trainer's `--attention_impl` and
`teacher_attn_impl`, against the JAX package on the CPU.

The JAX dispatcher runs as its own tests run it on the CPU, where `auto`,
`flash` and `flash_jax` take its XLA einsum; the port runs the plain
versions of its kernels (the card's are held against them by
`chip_smoke.py`, phase 29a).  The tiny PPFT step is held at the
tolerances of tests/test_torch_port_train.py: the loss and the gradient
norm to 1e-5 relative, each gradient to 1e-4 of its leaf's largest
value."""

import argparse
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.ops import attention as ta
from aqualora_tpu.ops import attention as ja

KEY = jax.random.PRNGKey(0)
# bf16_scores rounds QK^T, P and (in the backward) their gradients to bf16.
# The port does; XLA:CPU keeps float32 where JAX writes bf16 (its excess
# precision), so JAX's bf16_scores on the CPU is within float32 rounding of
# its float32 attention while the port's carries the method's own bf16
# error, as JAX's does on a TPU.  Measured on these inputs: the port
# against JAX 3.6e-3 (outputs) and 1.5e-2 (gradients, of largest 1.5: 1.0e-2
# of it); JAX's bf16_scores against JAX's xla 5.1e-3 and 7.3e-3.  The limit
# is 2^-6 (two bf16 ulps of a unit value) of the largest reference value,
# at least 1.
BF16_TOL = 2.0 ** -6
TOLS = {"identity": 1e-6, "flash_jax": 1e-6, "sdpa": 1e-5,
        "bf16_scores": BF16_TOL}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tq, tk, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 2, t, 8)).astype(np.float32)
               for t in (tq, tk, tk))
    w = rng.standard_normal((2, 2, tq, 8)).astype(np.float32)
    mask = None
    if masked:                       # causal, the first key always kept
        mask = np.tril(np.ones((tq, tk), bool))[None, None]
    return q, k, v, w, mask


def _jax(impl, q, k, v, w, mask, grad):
    def f(q, k, v):
        with ja.attention_impl(impl):
            out = ja.dot_product_attention(
                q, k, v, None if mask is None else jnp.asarray(mask),
                scale=0.3)
        return jnp.sum(out * w), out
    if not grad:
        return np.asarray(f(q, k, v)[1]), None
    (_, out), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in g]


def _port(impl, q, k, v, w, mask, grad):
    ts = [torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)]
    with ta.attention_impl(impl):
        out = ta.dot_product_attention(
            *ts, None if mask is None else torch.from_numpy(mask), scale=0.3)
    if not grad:
        return out.detach().numpy(), None
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tq,tk", [(6, 6), (5, 7)])
@pytest.mark.parametrize("impl", ["sdpa", "bf16_scores", "identity",
                                  "flash_jax"])
def test_dispatcher_value_matches_jax(impl, tq, tk, masked):
    """Each value, self- and cross-shaped, masked and not, against the JAX
    dispatcher inside its `attention_impl`, with the gradients of q, k and
    v for the three that training can differentiate: `identity` and
    `flash_jax` within 1e-6, `sdpa` 1e-5, `bf16_scores` BF16_TOL.  A masked
    call takes the mask under `bf16_scores` and the plain attention under
    the other three, as in JAX."""
    q, k, v, w, mask = _inputs(tq, tk, masked)
    grad = impl != "flash_jax"
    want, jg = _jax(impl, q, k, v, w, mask, grad)
    got, tg = _port(impl, q, k, v, w, mask, grad)
    tol = TOLS[impl]
    for a, b in zip([got] + (tg or []), [want] + (jg or [])):
        scale = max(1.0, np.abs(b).max()) if impl == "bf16_scores" else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)
    plain = _port("xla", q, k, v, w, mask, False)[0]
    if impl == "identity" and not masked:
        np.testing.assert_allclose(got, np.broadcast_to(
            v.mean(2, keepdims=True), got.shape), rtol=0, atol=1e-6)
        assert np.abs(got - plain).max() > 0.1
    elif impl == "bf16_scores":
        assert 0 < np.abs(got - plain).max() < BF16_TOL
    else:
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


def test_sdpa_takes_no_flash_call(monkeypatch):
    """Under `sdpa` an unmasked call is torch's SDPA, not the flash path,
    and a masked one the plain attention; `flash_jax` is the plain
    attention; `auto` takes the flash path."""
    calls = []
    monkeypatch.setattr(ta, "flash_attention",
                        lambda *a: calls.append("flash") or a[0])
    q, k, v, _, mask = _inputs(6, 6, True)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    for impl in ("sdpa", "flash_jax", "identity", "bf16_scores"):
        with ta.attention_impl(impl):
            ta.dot_product_attention(q, k, v)
            ta.dot_product_attention(q, k, v, torch.from_numpy(mask))
    assert calls == []
    with ta.attention_impl("auto"):
        ta.dot_product_attention(q, k, v)
    assert calls == ["flash"]


# ---------------------------------------------------------------------------
# the tiny PPFT step under each attention
# ---------------------------------------------------------------------------

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


# (the run's --attention_impl, teacher_attn_impl)
CASES = {"xla": ("xla", None), "sdpa": ("sdpa", None),
         "flash+sdpa_teacher": ("flash", "sdpa")}


@pytest.fixture(scope="module")
def steps():
    """The tiny PPFT loss and gradients at 32 px (the fused injection) for
    each case of CASES: JAX's `make_loss_fn(teacher_attn_impl=...)` under
    value_and_grad, jitted inside its `attention_impl`, and the port's on
    the same weights and draws (the JAX key split as `make_loss_fn` splits
    it), inside the port's."""
    import flax.traverse_util as tu

    import aqualora_torch.core.config as tcfg
    import aqualora_tpu.core.config as jcfg
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_torch.models.watermark import SecretEncoder as TEnc
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc
    from aqualora_tpu.train import ppft_train as jt

    cfg = jcfg.PipelineConfig.tiny()
    bits, grid = cfg.watermark.msg_bits, cfg.watermark.secret_grid
    jpipe = JPipe(cfg)
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, 32, 32)), 0)
    jsec = JEnc(bits, grid, 16, 4)
    sec_params = _fill(jax.eval_shape(lambda: jsec.init(
        KEY, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1, bits)))), 1)["params"]
    base_flat, lora_flat = jt.split_lora(params["unet"])
    trainable = {"lora": tu.unflatten_dict(lora_flat),
                 "mapper": params["mapper"]}
    frozen = {"vae": params["vae"], "text_encoder": params["text_encoder"],
              "sec_encoder": sec_params}
    rng = np.random.default_rng(2)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(42)
    kmsg, kvae, knoise, kt = jax.random.split(key, 7)[:4]
    shape = (2, 16, 16, 4)
    draws = tt.Draws(
        torch.from_numpy(np.array(jax.random.bernoulli(
            kmsg, 0.5, (2, bits)).astype(jnp.float32))),
        _nchw(jax.random.normal(kvae, shape, jnp.float32)),
        _nchw(jax.random.normal(knoise, shape)),
        torch.from_numpy(np.array(jax.random.randint(
            kt, (2,), 0, cfg.schedule.num_train_timesteps))).long())
    tpipe = TPipe(tcfg.PipelineConfig.tiny(), device="cpu")
    tpipe.load_jax_params(_np(params))
    tsec = TEnc(bits, grid, 16, 4)
    tsec.load_state_dict(jax_params_to_torch(_np(sec_params)), strict=True)
    tsec.requires_grad_(False)
    groups = tt.trainable_groups(tpipe)
    params_t = [p for g in groups.values() for p in g]

    # JAX's three programs are traced in turn (the override is trace-time
    # and global), compiled on threads of their own while the port runs
    args = (trainable, base_flat, frozen, pixels, ids, key)
    lowered = {}
    for case, (impl, teacher) in CASES.items():
        loss_fn = jt.make_loss_fn(jpipe, jsec, bits,
                                  teacher_attn_impl=teacher)
        with ja.attention_impl(impl):
            lowered[case] = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True)).lower(*args)
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        compiled = {case: pool.submit(lo.compile)
                    for case, lo in lowered.items()}
        for case, (impl, teacher) in CASES.items():
            for p in params_t:
                p.grad = None
            with ta.attention_impl(impl):
                t_loss, _ = tt.make_loss_fn(tpipe, tsec,
                                            teacher_attn_impl=teacher)(
                    pixels, ids, draws)
            t_loss.backward()
            got = {n: p.grad.clone()
                   for n, p in tt.split_lora(tpipe.unet)[1].items()}
            got["bit_embeddings.weight"] = \
                tpipe.mapper.bit_embeddings.weight.grad.clone()
            out[case] = {"t_loss": t_loss.item(), "got": got,
                         "t_norm": float(torch.sqrt(sum(
                             (g.double() ** 2).sum() for g in got.values())))}
        for case, fn in compiled.items():
            (j_loss, _), j_grads = fn.result()(*args)
            want = jax_params_to_torch(_np(j_grads["lora"]))
            want["bit_embeddings.weight"] = torch.from_numpy(np.array(
                j_grads["mapper"]["bit_embeddings"]))
            out[case].update(
                j_loss=float(j_loss), want=want,
                j_norm=float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                          jax.tree_util.tree_leaves(
                                              j_grads)))))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_ppft_step_under_attention_impl_matches_jax(steps, case):
    """The loss, the gradients' global norm and every LoRA leaf's and the
    mapper's gradient of the tiny PPFT step: under `--attention_impl xla`
    and `sdpa` (the whole step) and with the student on `flash` and the
    teacher on `sdpa` (`teacher_attn_impl`), against JAX's."""
    s = steps[case]
    assert s["j_loss"] > 1e-3
    np.testing.assert_allclose(s["t_loss"], s["j_loss"], rtol=1e-5)
    np.testing.assert_allclose(s["t_norm"], s["j_norm"], rtol=1e-5)
    assert set(s["got"]) == set(s["want"]) and len(s["want"]) > 20
    for name, g in s["want"].items():
        g = g.numpy()
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(s["got"][name].numpy(), g,
                                   atol=1e-4 * scale, err_msg=name)


def _record_impls(monkeypatch):
    seen = []
    real = ta.current_impl

    def spy():
        impl = real()
        seen.append(impl)
        return impl
    monkeypatch.setattr(ta, "current_impl", spy)
    return seen


@pytest.mark.parametrize("impl", ["sdpa", "xla"])
def test_run_trains_under_the_flag_and_validates_under_auto(impl,
                                                            monkeypatch):
    """`run` takes the training steps' attention from `--attention_impl`
    and validation's from `auto` (JAX `ppft_train.py:276-285,601`), and
    leaves the process's implementation as it found it; stage 3 takes the
    flag and runs as without it (JAX's never reads it)."""
    from aqualora_torch.train import ppft_train as tt
    from aqualora_torch.train import rob_enhance_finetune as s3

    seen = _record_impls(monkeypatch)
    argv = ["--tiny", "--max_train_steps", "1", "--train_batch_size", "2",
            "--device", "cpu", "--report_to", "none", "--attention_impl",
            impl]
    tt.run(tt.build_argparser().parse_args(argv))
    assert seen and set(seen) == {impl}
    seen.clear()
    tt.run(tt.build_argparser().parse_args(argv + ["--validation_steps",
                                                    "1"]))
    assert set(seen) == {impl, "auto"}
    assert seen[-1] == "auto"            # validation came after the step
    assert ta.current_impl() == "auto"
    args = s3.build_argparser().parse_args(
        ["--tiny", "--device", "cpu", "--output_dir", "unused",
         "--attention_impl", impl])
    assert isinstance(args, argparse.Namespace)
    s3._refuse_unported(args)
