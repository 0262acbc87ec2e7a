"""The port's PPFT training step and fused secret injection against the JAX
package, float32 on the CPU.

The JAX side runs jitted on the CPU (its injection takes the Pallas kernel
in interpret mode, or `_reference_inject` where the JAX package itself
does); the port runs the plain versions of its kernels, which the card's
kernels are held against by tests/test_torch_port_cuda.py and
chip_smoke.py."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch

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


@contextlib.contextmanager
def _interpret_pallas():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp_call
    try:
        yield
    finally:
        pl.pallas_call = orig


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


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


# ---------------------------------------------------------------------------
# fused secret injection
# ---------------------------------------------------------------------------

def _inject_inputs(seed=0, b=2, base=8, bits=8, c=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 2 * base, 2 * base, c), np.float32),
            (rng.random((b, bits)) > 0.5).astype(np.float32),
            (0.3 * rng.standard_normal((bits, base * base))).astype(np.float32),
            (0.1 * rng.standard_normal(base * base)).astype(np.float32),
            (0.1 * rng.standard_normal((3, 3, c, c))).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _torch_inject_args(latent, msg, dk, db, ck, cb):
    """JAX layouts (NHWC latent, Dense [in, out], conv HWIO) -> the port's
    (NCHW, Linear [out, in], conv OIHW)."""
    return (_nchw(latent), torch.from_numpy(msg),
            torch.from_numpy(dk.T.copy()), torch.from_numpy(db),
            torch.from_numpy(ck.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(cb))


def test_inject_matches_pallas_interpret():
    """`fused_secret_inject` on the CPU (its plain version) against the
    Pallas kernel `_pallas_inject` run in interpret mode."""
    from aqualora_torch.ops import secret_inject as si
    from aqualora_tpu.ops.secret_inject import _pallas_inject

    args = _inject_inputs()
    with _interpret_pallas():
        ref = np.asarray(_pallas_inject(*map(jnp.asarray, args), 8))
    before = si.launches.count
    out = si.fused_secret_inject(*_torch_inject_args(*args), base_res=8)
    assert si.launches.count == before      # no kernel launch on the CPU
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5)
    assert np.abs(ref - args[0]).max() > 1e-2      # the watermark is there


def test_inject_plain_with_bf16_weights_matches_pallas_interpret():
    """bf16 latent and bf16 SecretEncoder weights, as the PPFT trainer builds
    them, through `fused_secret_inject` on the CPU (`inject_plain`) and the
    Pallas kernel in interpret mode.  Both cast the weights to float32 and
    round the output to bf16 once, so they differ by one bf16 ulp at the
    output's largest value (2^-7 of it), plus what JAX's channel sum of the
    bf16 conv kernel rounds away (it sums in bf16, the port in float32) over
    the stencil's nine taps."""
    from aqualora_torch.ops import secret_inject as si
    from aqualora_tpu.ops.secret_inject import _pallas_inject

    t_args = [t.bfloat16() if i != 1 else t for i, t in enumerate(
        _torch_inject_args(*_inject_inputs(2, base=32, bits=48)))]
    latent, msg, dk, db, ck, cb = t_args
    j_args = (jnp.asarray(_nhwc(latent.float())).astype(jnp.bfloat16),
              jnp.asarray(msg.numpy()),
              jnp.asarray(dk.float().numpy().T).astype(jnp.bfloat16),
              jnp.asarray(db.float().numpy()).astype(jnp.bfloat16),
              jnp.asarray(ck.float().numpy().transpose(2, 3, 1, 0))
              .astype(jnp.bfloat16),
              jnp.asarray(cb.float().numpy()).astype(jnp.bfloat16))
    with _interpret_pallas():
        ref = np.asarray(_pallas_inject(*j_args, 32).astype(jnp.float32))
    out = si.fused_secret_inject(*t_args, base_res=32)
    assert out.dtype == torch.bfloat16
    k1_jax = np.asarray(jnp.sum(j_args[4], axis=2).astype(jnp.float32))
    k1_dk = np.abs(k1_jax - ck.float().sum(1).permute(1, 2, 0).numpy()).max()
    u = torch.nn.functional.silu(msg @ dk.float().T + db.float())
    tol = (2.0 ** -7 * np.abs(ref).max() + 9 * u.abs().max().item() * k1_dk
           + 1e-5)
    np.testing.assert_allclose(_nhwc(out.float()), ref, atol=tol)


def _inject_kernel_order(latent, msg, dense_w, dense_b, conv_w, conv_b,
                         base):
    """What csrc/secret_inject.cu computes, in its order: each cell's dense
    sum over the bits in order, then its bias and SiLU; k1 the conv kernel's
    input channels added in order; then latent + bias and the nine taps in
    order, over the zero-padded, nearest-x2 upsampled u; float32, the result
    in the latent's type."""
    b, c, h, w = latent.shape
    m, wd = msg.float(), dense_w.float()
    acc = torch.zeros(b, base * base)
    for n in range(msg.shape[1]):
        acc = acc + m[:, n:n + 1] * wd[:, n]
    acc = acc + dense_b.float()
    u = (acc / (1 + torch.exp(-acc))).reshape(b, base, base)
    grid = torch.nn.functional.pad(
        u.repeat_interleave(2, 1).repeat_interleave(2, 2), (1, 1, 1, 1))
    k1 = torch.zeros(c, 3, 3)
    for ci in range(conv_w.shape[1]):
        k1 = k1 + conv_w[:, ci].float()
    out = latent.float() + conv_b.float()[None, :, None, None]
    for dy in range(3):
        for dx in range(3):
            out = out + (grid[:, None, dy:dy + h, dx:dx + w]
                         * k1[None, :, dy, dx, None, None])
    return out.to(latent.dtype)


def test_inject_kernel_order_matches_pallas_interpret():
    """The one-launch kernel's order of arithmetic (48-term dense sums a
    cell, then the stencil), emulated in torch, against the Pallas kernel in
    interpret mode, float32, within 1e-5 (float32 sums in other orders)."""
    from aqualora_tpu.ops.secret_inject import _pallas_inject

    args = _inject_inputs(3, base=32, bits=48)
    with _interpret_pallas():
        ref = np.asarray(_pallas_inject(*map(jnp.asarray, args), 32))
    out = _inject_kernel_order(*_torch_inject_args(*args), 32)
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5)
    assert np.abs(ref - args[0]).max() > 1e-2      # the watermark is there


def test_inject_grads_match_jax():
    """The backward (inject_plain recomputed under autograd) gives
    `jax.grad`'s gradients of dense_w and conv_w."""
    from aqualora_torch.ops.secret_inject import fused_secret_inject
    from aqualora_tpu.ops.secret_inject import (
        fused_secret_inject as jax_inject)

    latent, msg, dk, db, ck, cb = _inject_inputs(1)

    def loss(dk, ck):
        return jnp.sum(jax_inject(jnp.asarray(latent), jnp.asarray(msg), dk,
                                  jnp.asarray(db), ck, jnp.asarray(cb),
                                  8) ** 2)

    g_dk, g_ck = jax.grad(loss, argnums=(0, 1))(jnp.asarray(dk),
                                                jnp.asarray(ck))
    t_args = list(_torch_inject_args(latent, msg, dk, db, ck, cb))
    t_args[2].requires_grad_(True)
    t_args[4].requires_grad_(True)
    (fused_secret_inject(*t_args, base_res=8) ** 2).sum().backward()
    np.testing.assert_allclose(t_args[2].grad.numpy().T, np.asarray(g_dk),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t_args[4].grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(g_ck), rtol=1e-5, atol=1e-4)
    assert np.abs(np.asarray(g_dk)).max() > 0


def test_inject_from_params_equals_secret_encoder():
    """At a latent of side 2 * base the fused injection equals the
    SecretEncoder module (whose resize is then the identity)."""
    from aqualora_torch.models.watermark import SecretEncoder
    from aqualora_torch.ops.secret_inject import inject_from_params

    enc = SecretEncoder(8, base_res=8, resolution=16)
    with torch.no_grad():
        enc.conv_out.weight.normal_(0.0, 0.1)
        enc.conv_out.bias.normal_(0.0, 0.1)
        latent = torch.randn(2, 4, 16, 16)
        msg = torch.bernoulli(torch.full((2, 8), 0.5))
        want, _ = enc(latent, msg)
        got = inject_from_params(enc.state_dict(), latent, msg, base_res=8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_bf16_ppft_injection_keeps_a_float32_encoder(monkeypatch):
    """Under `--mixed_precision bf16` the PPFT trainer's SecretEncoder keeps
    float32 parameters, as the JAX trainer's do (`sec_encoder.init`), and a
    bf16 step's injected latent is what JAX computes from the same bf16
    latent with those float32 parameters.

    Recorded inside `make_loss_fn`: the VAE's latent and the injected
    latent times the VAE scaling, as the step hands it to `add_noise`.
    - The module path (64 px, latent 32, not 2 * secret_grid): float32 on
      both sides, within 1e-6 * max|.| (float32 sums in other orders).  With
      the encoder cast to bf16, as the trainer did, the result is bf16 and
      misses by the rounding of the weights and of the sum, about 1e-2.
    - The fused path (32 px, latent 16) against `_pallas_inject` in
      interpret mode: each side computes in float32 and rounds to bf16
      once, then once more times the scaling, so within one bf16 ulp at the
      largest value, 2^-7 * max|.|."""
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc
    from aqualora_tpu.ops.secret_inject import _pallas_inject

    tr = tt.build_trainer(tt.build_argparser().parse_args(
        ["--tiny", "--device", "cpu", "--mixed_precision", "bf16"]))
    assert tr.pipe.unet.conv_in.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.sec_encoder.parameters())
    cfg = tr.pipe.config
    bits, grid = cfg.watermark.msg_bits, cfg.watermark.secret_grid
    rng = np.random.default_rng(8)
    jparams = {"secret_dense": {
        "kernel": (0.5 * rng.standard_normal((bits, grid * grid))),
        "bias": 0.1 * rng.standard_normal(grid * grid)},
        "conv_out": {"kernel": 0.3 * rng.standard_normal((3, 3, 4, 4)),
                     "bias": 0.1 * rng.standard_normal(4)}}
    jparams = jax.tree_util.tree_map(lambda v: v.astype(np.float32), jparams)
    tr.sec_encoder.load_state_dict(jax_params_to_torch(jparams), strict=True)

    latents, noised = [], []
    vae, sched = tr.pipe.vae, tr.pipe.schedule
    sample, add_noise = vae.sample_from_moments, sched.add_noise
    monkeypatch.setattr(vae, "sample_from_moments", lambda *a: latents.append(
        sample(*a)) or latents[-1])
    monkeypatch.setattr(sched, "add_noise", lambda x, *a: noised.append(x)
                        or add_noise(x, *a))
    loss_fn = tt.make_loss_fn(tr.pipe, tr.sec_encoder)
    scaling = cfg.vae.scaling_factor
    for res in (64, 32):
        pixels = rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
        draws = tt.draw(tr.pipe, tr.generator, pixels)
        with torch.no_grad():
            loss_fn(pixels, np.zeros((2, 77), np.int32), draws)
        lat = jnp.asarray(_nhwc(latents[-1].float())).astype(jnp.bfloat16)
        got = noised[-1]
        assert lat.shape[1] == res // 2 and latents[-1].dtype == torch.bfloat16
        msg = jnp.asarray(draws.msg.numpy())
        if res == 64:
            injected, _ = JEnc(bits, grid, 32, 4).apply({"params": jparams},
                                                        lat, msg)
            want = np.asarray(injected * scaling)
            assert want.dtype == np.float32 and got.dtype == torch.float32
            tol = 1e-6 * np.abs(want).max()
        else:
            with _interpret_pallas():
                injected = _pallas_inject(
                    lat, msg, *(jnp.asarray(jparams[m][k]) for m, k in (
                        ("secret_dense", "kernel"), ("secret_dense", "bias"),
                        ("conv_out", "kernel"), ("conv_out", "bias"))), grid)
            want = np.asarray((injected * scaling).astype(jnp.float32))
            assert got.dtype == torch.bfloat16
            tol = 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(_nhwc(got.float()), want, rtol=0, atol=tol,
                                   err_msg=f"{res} px")
        assert np.abs(want - np.asarray(lat.astype(jnp.float32)) * scaling
                      ).max() > 0.1             # the watermark is there


# ---------------------------------------------------------------------------
# the PPFT step, tiny config
# ---------------------------------------------------------------------------

LR = 1e-4


@pytest.fixture(scope="module")
def ppft():
    """One PPFT step of the tiny config through both trainers, at 32 px so
    the latent (16) is 2 * secret_grid and the fused injection is taken.
    The JAX draws (key split as `make_loss_fn` splits it) are handed to the
    port, NHWC permuted to NCHW."""
    import flax.traverse_util as tu
    import optax

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

    # JAX: one train step with the optimizer `run` builds (warmup 0); a
    # pass-through transform in front keeps the raw gradients in its state
    lr_fn = jt.cosine_with_warmup_lr_end(LR, 0, 10, 0.0)
    adamw = lambda: optax.adamw(lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                                weight_decay=1e-2)
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, state, params=None: (u, u))
    tx = optax.chain(record, optax.multi_transform(
        {"lora": optax.chain(optax.clip_by_global_norm(1.0), adamw()),
         "mapper": adamw()}, {"lora": "lora", "mapper": "mapper"}))
    j_step = jt.make_train_step(jpipe, jsec, tx, bits)
    j_new, j_state, j_metrics = j_step(trainable, tx.init(trainable),
                                       base_flat, frozen, jnp.asarray(pixels),
                                       jnp.asarray(ids), key)
    j_grads = j_state[0]

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
    t_loss, _ = tt.make_loss_fn(tpipe, tsec)(pixels, ids, draws)
    t_loss.backward()
    t_grads = {name: p.grad.clone()
               for name, p in tt.split_lora(tpipe.unet)[1].items()}
    t_grads["bit_embeddings.weight"] = tpipe.mapper.bit_embeddings.weight.grad
    optimizer, scheduler = tt.make_optimizer(groups, LR, 0, 10)
    t_metrics = tt.make_train_step(tpipe, tsec, optimizer, scheduler, 1.0)(
        pixels, ids, draws)
    return {"j_loss": float(j_metrics["ppft_loss"]), "t_loss": t_loss.item(),
            "j_grads": jax_params_to_torch(_np(j_grads["lora"])),
            "j_mapper_grad": np.array(j_grads["mapper"]["bit_embeddings"]),
            "t_grads": t_grads, "j_metrics": j_metrics,
            "t_metrics": t_metrics, "j_new": j_new, "tpipe": tpipe,
            "trainable": trainable, "params": params}


def test_ppft_loss_and_grad_norm_match_jax(ppft):
    """The loss of `make_loss_fn` on the same draws, alone and inside the
    train step, and the global norm of every gradient before clipping."""
    assert ppft["j_loss"] > 1e-3
    np.testing.assert_allclose(ppft["t_loss"], ppft["j_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(ppft["t_metrics"]["ppft_loss"]),
                               ppft["j_loss"], rtol=1e-5)
    j_norm = float(ppft["j_metrics"]["grad_norm"])
    assert j_norm > 1.0            # so the LoRA clip at 1.0 is exercised
    np.testing.assert_allclose(float(ppft["t_metrics"]["grad_norm"]), j_norm,
                               rtol=1e-5)


def test_ppft_every_trainable_gradient_matches_jax(ppft):
    """Every LoRA leaf's and the mapper's gradient within 1e-4 * max|g| of
    that leaf (float32 sums taken in other orders)."""
    t_grads = ppft["t_grads"]
    want = dict(ppft["j_grads"])
    want["bit_embeddings.weight"] = torch.from_numpy(ppft["j_mapper_grad"])
    assert set(t_grads) == set(want) and len(want) > 20
    for name, g in want.items():
        g = g.numpy()
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(t_grads[name].numpy(), g,
                                   atol=1e-4 * scale, err_msg=name)


def test_ppft_train_step_matches_jax(ppft):
    """The parameters after one AdamW step (warmup 0, so lr = 1e-4).  Adam's
    first step is lr * g / (|g| + eps), one normalised step per element: an
    element whose gradient is resolved (above 1e-3 * max|g| of its leaf,
    ten times the gradients' agreement) moves the same way on both sides,
    so it agrees to float32 rounding, 1e-6 + 1e-6 * |p|.  Elsewhere float
    noise near eps may flip the step, so those are held only to the bound
    any two first steps obey, 2 * lr * (1 + wd)."""
    from aqualora_torch.train.ppft_train import split_lora

    new = jax_params_to_torch(_np(ppft["j_new"]["lora"]))
    new["bit_embeddings.weight"] = torch.from_numpy(
        np.asarray(ppft["j_new"]["mapper"]["bit_embeddings"]))
    old = jax_params_to_torch(_np(ppft["trainable"]["lora"]))
    tpipe = ppft["tpipe"]
    got = {k: p.detach() for k, p in split_lora(tpipe.unet)[1].items()}
    got["bit_embeddings.weight"] = tpipe.mapper.bit_embeddings.weight.detach()
    grads = dict(ppft["j_grads"])
    grads["bit_embeddings.weight"] = torch.from_numpy(ppft["j_mapper_grad"])
    moved = 0
    for name, want in new.items():
        want, p = want.numpy(), got[name].numpy()
        g = np.abs(grads[name].numpy())
        resolved = g > 1e-3 * g.max()
        np.testing.assert_allclose(p[resolved], want[resolved],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(p - want).max() <= 2 * LR * (1 + 1e-2), name
        if name in old:
            moved += np.abs(want - old[name].numpy()).max() > 0.5 * LR
    assert moved == len(old)


def test_pipeline_loads_the_whole_vae(ppft):
    """`load_jax_params` loads the VAE strictly, its encoder and quant_conv
    included (the trainer encodes every batch with them)."""
    want = jax_params_to_torch(_np(ppft["params"]["vae"]))
    got = ppft["tpipe"].vae.state_dict()
    assert set(got) == set(want)
    assert sum(k.startswith(("encoder.", "quant_conv.")) for k in want) > 20
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_ppft_cli_runs_on_cpu():
    """The entry point as a user calls it, on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "aqualora_torch.train.ppft_train", "--tiny",
         "--max_train_steps", "2", "--train_batch_size", "2",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    for ln in lines:
        fields = dict(kv.split("=") for kv in ln.split()[2:6]
                      if "=" in kv)
        assert np.isfinite(float(fields["ppft_loss"]))
        assert np.isfinite(float(fields["grad_norm"]))


def test_synthetic_dataset_matches_jax():
    """The same batches as the JAX dataset for one process, across an
    epoch boundary (size 5 at batch 2: two batches an epoch)."""
    from aqualora_torch.train.data import SyntheticDataset
    from aqualora_tpu.train.data import SyntheticDataset as JaxDataset

    got = SyntheticDataset(resolution=4, size=5).batches(2, seed=3)
    want = JaxDataset(resolution=4, size=5).batches(2, seed=3)
    for _ in range(5):
        (imgs, caps), (jimgs, jcaps) = next(got), next(want)
        assert imgs.dtype == np.float32 and imgs.shape == (2, 4, 4, 3)
        np.testing.assert_array_equal(imgs, jimgs)
        assert caps == jcaps


def test_lr_schedule_matches_jax():
    from aqualora_torch.train.ppft_train import cosine_with_warmup_lr_end
    from aqualora_tpu.train.ppft_train import (
        cosine_with_warmup_lr_end as jax_schedule)

    for args in ((5e-4, 10, 50, 0.1), (1e-4, 0, 20, 0.0)):
        want = jax_schedule(*args)
        got = cosine_with_warmup_lr_end(*args)
        for step in (0, 1, 5, 10, 11, 30, 49, 60):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)
