"""The PPFT trainer's options of the port against the JAX package, on the
CPU at the tiny configuration: 8-bit AdamW, block-wise LR, the kohya
dropouts, gradient accumulation, the scale-0 teacher, remat, resume in the
middle of an accumulation window and `--debug_nans` (the text-encoder
LoRA: tests/test_torch_port_te_lora.py; the parsers and the documented
command: tests/test_torch_port_cli_flags.py).

The JAX side runs as its own tests run it on the CPU; the port runs the
plain versions of its kernels (the card's are held against them by
chip_smoke.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# 8-bit AdamW
# ---------------------------------------------------------------------------

def test_adamw8bit_codes_and_updates_match_jax():
    """Three updates of seeded leaves, one not a whole number of blocks:
    the int8 codes and float32 scales of both moments bit for bit (the
    port's flat buffer is the JAX leaves' blocks back to back), the
    parameters within 1e-6, the schedule read at the count before the
    increment.  The JAX function runs op by op (see the port's
    docstring for what jit changes)."""
    import optax

    from aqualora_torch.train.adamw8bit import AdamW8bit, padded
    from aqualora_tpu.train.adamw8bit import adamw8bit

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 100), "b": (2, 256)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    factor = lambda c: (c + 1) / 3.0          # noqa: E731
    tx = adamw8bit(lambda c: 1e-3 * factor(c), weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
          for k in sorted(shapes)]
    opt = AdamW8bit(tp, lr=1e-3, weight_decay=1e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)
                     ).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(g)
                                    for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, sorted(shapes)):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        (st,) = opt.state.values()
        for which, leaves in (("m", state.m), ("v", state.v)):
            np.testing.assert_array_equal(
                st[f"{which}_code"].numpy(),
                np.concatenate([np.asarray(q.code) for q in leaves]))
            np.testing.assert_array_equal(
                st[f"{which}_scale"].numpy(),
                np.concatenate([np.asarray(q.scale) for q in leaves]))
        for p, k in zip(tp, sorted(shapes)):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    n = sum(padded(int(np.prod(s))) for s in shapes.values())
    assert opt.state_bytes() == 2 * (n + 4 * n // 256)


# ---------------------------------------------------------------------------
# block-wise LR and rank dropout
# ---------------------------------------------------------------------------

def test_block_lr_parse_and_index_match_jax(capsys):
    from aqualora_torch.core import io as tio
    from aqualora_torch.core.config import UNetConfig
    from aqualora_torch.train import block_lr as tb
    from aqualora_tpu.core import io as jio
    from aqualora_tpu.train import block_lr as jb

    for spec in (None, "cosine", "sine+0.5", "linear", "reverse_linear+1",
                 "zeros", "zeros+0.25", "1,0.5,1e+2", "0.1," * 11 + "0.2",
                 "cosine+x", "not-a-spec", "1,2,x"):
        assert tb.parse_lr_weight_list(spec) == jb.parse_lr_weight_list(spec)
    assert capsys.readouterr().out.count("disabled") == 6
    down, up = jb.parse_lr_weight_list("cosine"), jb.parse_lr_weight_list(
        "linear+0.1")
    for mk in tio.unet_module_keys(UNetConfig.sd15()):
        path = jio._module_key_to_flax_path(mk)
        name = f"{mk}.lora.down.weight"
        assert tb.block_index(name) == jb.block_index(path), mk
        for thr in (0.0, 0.3):
            assert tb.lr_weight_for_path(name, down, 0.5, up, thr) == \
                jb.lr_weight_for_path(path, down, 0.5, up, thr), mk
    assert tb.block_index("layers.0.self_attn.q_proj.lora.down.weight") \
        is None


def test_block_lr_update_matches_jax():
    """The port's per-block groups (lr x w, decay inside) against JAX's
    clip -> AdamW -> scale by block, two updates, over a leaf for each
    LoRA tensor of the SD-1.5 transformers' proj_in sites (the weights come
    from the names); a zero weight leaves its parameters bit for bit."""
    import flax.traverse_util as tu
    import optax

    from aqualora_torch.core import io as tio
    from aqualora_torch.core.config import UNetConfig
    from aqualora_torch.train import block_lr as tb
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.core import io as jio
    from aqualora_tpu.train import block_lr as jb
    from aqualora_tpu.train import ppft_train as jt

    rng = np.random.default_rng(3)
    keys = [(mk, which) for mk in tio.unet_module_keys(UNetConfig.sd15())
            if mk.endswith("proj_in") for which in ("down", "up")]
    init = [rng.standard_normal((2, 3)).astype(np.float32) for _ in keys]
    trainable = tu.unflatten_dict({
        jio._module_key_to_flax_path(mk) + ("lora", which, "kernel"): v
        for (mk, which), v in zip(keys, init)})
    named = {f"{mk}.lora.{which}.weight": torch.nn.Parameter(
        torch.from_numpy(v.copy())) for (mk, which), v in zip(keys, init)}
    spec = ("cosine+0.1", 0.0, "1,1,1,0.5,0.25")
    weights = tb.lr_weights(named.items(), *spec, 0.3)
    assert {0.0, 0.5, 1.0} < set(weights.values())      # 0.25: under 0.3
    opt, sched = tt.make_optimizer({"lora": list(named.values())}, LR, 0, 10,
                                   lr_weights=weights)
    update = tt.make_update(opt, sched, 1.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jt.cosine_with_warmup_lr_end(LR, 0, 10, 0),
                                 weight_decay=1e-2),
                     jb.scale_lora_updates_by_block(
                         jb.parse_lr_weight_list(spec[0]), spec[1],
                         jb.parse_lr_weight_list(spec[2]), 0.3))
    jtrain = {"lora": trainable}
    jstate = tx.init(jtrain)
    tx_update = jax.jit(lambda g, st, p: (lambda u, st: (
        optax.apply_updates(p, u), st))(*tx.update(g, st, p)))
    for _ in range(2):
        grads = [(0.1 * rng.standard_normal((2, 3))).astype(np.float32)
                 for _ in keys]
        jgrads = {"lora": tu.unflatten_dict({
            jio._module_key_to_flax_path(mk) + ("lora", which, "kernel"): g
            for (mk, which), g in zip(keys, grads)})}
        jtrain, jstate = tx_update(jgrads, jstate, jtrain)
        for p, g in zip(named.values(), grads):
            p.grad = torch.from_numpy(g)
        update()
    flat = tu.flatten_dict(jtrain["lora"])
    for ((mk, which), v), (name, p) in zip(zip(keys, init), named.items()):
        want = np.asarray(flat[jio._module_key_to_flax_path(mk)
                               + ("lora", which, "kernel")])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6, err_msg=name)
        assert np.array_equal(p.detach().numpy(), v) == (
            weights[id(p)] == 0.0), name


def test_rank_dropout_with_jax_mask():
    from aqualora_torch.train.block_lr import rank_dropout_scale
    from aqualora_tpu.train import block_lr as jb

    diag = jax.random.normal(KEY, (3, 16))
    key = jax.random.PRNGKey(7)
    want = jb.rank_dropout_scale(key, diag, 0.3)
    mask = jax.random.bernoulli(key, 0.7, diag.shape)
    got = rank_dropout_scale(torch.from_numpy(np.array(diag)),
                             torch.from_numpy(np.array(mask)), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any() and (got != 0).any()


# ---------------------------------------------------------------------------
# the kohya dropouts, by their law (as tests/test_block_lr.py holds JAX's)
# ---------------------------------------------------------------------------

def _site(module_dropout=0.0, dropout=0.0, n=1):
    from aqualora_torch.core.config import LoRAConfig
    from aqualora_torch.models.lora import LoRALinear, number_sites
    torch.manual_seed(0)
    cfg = LoRAConfig(rank=4, module_dropout=module_dropout, dropout=dropout)
    mod = torch.nn.Sequential(*[LoRALinear(8, 8, lora=cfg)
                                for _ in range(n)])
    with torch.no_grad():
        for m in mod:
            m.lora.up.weight.normal_()
    assert number_sites(mod) == n
    return mod, torch.randn(2, 8), torch.ones(2, 4)


def _apply(mod, x, scale):
    for m in mod:
        x = m(x, scale)
    return x


def test_module_dropout_gates_whole_delta():
    """p = 1 under draws removes the delta (no rescale); outside
    `lora_dropout` (inference) the LoRA stays on; p = 0 is a no-op; two
    sites draw independently."""
    from aqualora_torch.models.lora import SiteDraws, lora_dropout
    from aqualora_torch.train.ppft_train import draw_sites

    mod, x, scale = _site(module_dropout=1.0)
    base, full = _apply(mod, x, None), _apply(mod, x, scale)
    assert (full - base).abs().max() > 1e-4
    gen = torch.Generator().manual_seed(0)
    with lora_dropout(draw_sites(_cfg(1.0), 1, gen)):
        assert torch.allclose(_apply(mod, x, scale), base, atol=1e-6)
    assert torch.equal(_apply(mod, x, scale), full)
    mod0, _, _ = _site(module_dropout=0.0)
    with lora_dropout(SiteDraws(keep=torch.zeros(1, dtype=torch.bool))):
        assert torch.equal(_apply(mod0, x, scale), full)
    two, _, _ = _site(module_dropout=0.5, n=2)
    full2, off2 = _apply(two, x, scale), _apply(two, x, None)
    outs = set()
    for s in range(16):
        d = draw_sites(_cfg(0.5), 2, torch.Generator().manual_seed(s))
        with lora_dropout(d):
            y = _apply(two, x, scale)
        outs.add(tuple(d.keep.tolist()))
        assert not torch.equal(y, full2) or d.keep.all()
    assert {(True, False), (False, True)} & outs
    del off2


def _cfg(module_dropout=0.0, dropout=0.0):
    from aqualora_torch.core.config import LoRAConfig
    return LoRAConfig(rank=4, module_dropout=module_dropout, dropout=dropout)


def test_elementwise_dropout_law_and_seeds():
    """Active only under draws, 1/(1-p) rescale keeps the expectation
    (JAX's bound), and the mask is a function of the site's seed."""
    from aqualora_torch.models.lora import SiteDraws, lora_dropout

    mod, x, scale = _site(dropout=0.5)
    ref = _apply(mod, x, scale)
    outs = []
    for s in range(64):
        with lora_dropout(SiteDraws(seeds=[s])):
            outs.append(_apply(mod, x, scale))
    assert any((o - ref).abs().max() > 1e-5 for o in outs)
    np.testing.assert_allclose(torch.stack(outs).mean(0).detach().numpy(),
                               ref.detach().numpy(), atol=0.35)
    with lora_dropout(SiteDraws(seeds=[5])):
        assert torch.equal(_apply(mod, x, scale), outs[5])


# ---------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """2k micro-steps of seeded gradients through the port's accumulator,
    clip (LoRA group only) and AdamW against optax.MultiSteps over the
    same chain: the parameters within 1e-6, unchanged between updates,
    and the schedule advanced once per window."""
    import optax

    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.train import ppft_train as jt

    rng = np.random.default_rng(k)
    init = {"lora": rng.standard_normal((5, 7)).astype(np.float32),
            "mapper": rng.standard_normal((3, 4)).astype(np.float32)}
    lr_fn = jt.cosine_with_warmup_lr_end(1e-2, 0, 4, 0.0)
    adamw = lambda: optax.adamw(lr_fn, weight_decay=1e-2)   # noqa: E731
    tx = optax.MultiSteps(optax.multi_transform(
        {"lora": optax.chain(optax.clip_by_global_norm(1.0), adamw()),
         "mapper": adamw()}, {"lora": "lora", "mapper": "mapper"}), k)
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in init.items()}
    opt, sched = tt.make_optimizer({n: [p] for n, p in tp.items()}, 1e-2, 0,
                                   4)
    acc = tt.GradientAccumulator(list(tp.values()), k)
    update = tt.make_update(opt, sched, 1.0, acc)
    step = jax.jit(lambda g, st, p: (lambda u, st: (
        optax.apply_updates(p, u), st))(*tx.update(g, st, p)))
    for i in range(2 * k):
        grads = {n: (3 * rng.standard_normal(v.shape)).astype(np.float32)
                 for n, v in init.items()}
        jp, state = step(grads, state, jp)
        before = {n: p.detach().clone() for n, p in tp.items()}
        for n, p in tp.items():
            p.grad = torch.from_numpy(grads[n])
        update()
        for n, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       rtol=0, atol=1e-6, err_msg=f"{i} {n}")
            assert torch.equal(p.detach(), before[n]) == ((i + 1) % k != 0)
        assert acc.mini_step == (i + 1) % k
        assert sched.last_epoch == (i + 1) // k


# ---------------------------------------------------------------------------
# the teacher at scale 0, remat with the dropouts on
# ---------------------------------------------------------------------------

def _tiny_pipe(remat=False, dropout=0.0, module_dropout=0.0, seed=0):
    import dataclasses

    import aqualora_torch.core.config as tcfg
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretEncoder
    from aqualora_torch.train import ppft_train as tt

    cfg = tcfg.PipelineConfig.tiny()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, remat=remat, lora=dataclasses.replace(
            cfg.unet.lora, dropout=dropout, module_dropout=module_dropout)))
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(seed)           # every LoRA up non-zero
    groups = tt.trainable_groups(pipe)
    sec = SecretEncoder(8, 8, 16, 4)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in sec.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    sec.requires_grad_(False)
    return pipe, sec, groups


def _loss_and_grads(pipe, sec, groups, draws, **kw):
    from aqualora_torch.train import ppft_train as tt
    rng = np.random.default_rng(9)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 1000, (2, 77))
    for ps in groups.values():
        for p in ps:
            p.grad = None
    loss, _ = tt.make_loss_fn(pipe, sec, **kw)(pixels, ids, draws)
    loss.backward()
    return loss.detach(), [p.grad.clone() for ps in groups.values()
                           for p in ps]


def test_teacher_at_scale_zero_equals_skipping_teacher():
    """`--teacher_skip_lora 0` runs the 192 sites (here the tiny config's)
    at a zero diagonal: y + 0 = y, so the loss is the skipping teacher's
    exactly."""
    from aqualora_torch.train import ppft_train as tt
    pipe, sec, groups = _tiny_pipe()
    d = tt.draw(pipe, torch.Generator().manual_seed(3),
                np.zeros((2, 32, 32, 3), np.float32))
    skip, g_skip = _loss_and_grads(pipe, sec, groups, d)
    zero, g_zero = _loss_and_grads(pipe, sec, groups, d,
                                   teacher_skip_lora=False)
    assert skip > 0 and torch.equal(skip, zero)
    assert all(torch.equal(a, b) for a, b in zip(g_skip, g_zero))


def test_remat_keeps_loss_and_grads_with_dropouts():
    """The same draws with all three dropouts on: the U-Net with its
    transformer blocks under checkpoint gives the loss and every gradient
    of the U-Net without, bit for bit (the recompute draws its masks from
    the same seeds)."""
    from aqualora_torch.train import ppft_train as tt
    plain = _tiny_pipe(dropout=0.3, module_dropout=0.3)
    remat = _tiny_pipe(remat=True, dropout=0.3, module_dropout=0.3)
    d = tt.draw(plain[0], torch.Generator().manual_seed(4),
                np.zeros((2, 32, 32, 3), np.float32), rank_dropout=0.25)
    assert d.unet_sites.seeds and d.unet_sites.keep is not None
    assert not d.unet_sites.keep.all() and not (d.rank_mask.all())
    a, ga = _loss_and_grads(*plain, d, rank_dropout=0.25)
    b, gb = _loss_and_grads(*remat, d, rank_dropout=0.25)
    c, _ = _loss_and_grads(*plain, tt.Draws(d.msg, d.vae_noise, d.noise,
                                            d.t), rank_dropout=0.0)
    assert a > 0 and not torch.equal(a, c)           # the dropouts act
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


# ---------------------------------------------------------------------------
# runs through the entry point
# ---------------------------------------------------------------------------

def _pretrain_file(path):
    """A stage-1 file with seeded random encoder and decoder weights, so
    that the PPFT loss is not 0 at the start."""
    from aqualora_torch.core.config import EfficientNetConfig
    from aqualora_torch.diffusion.pipeline import init_module_weights
    from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
    gen = torch.Generator().manual_seed(11)
    enc = SecretEncoder(8, 8, 32, 4)
    dec = SecretDecoder(8, EfficientNetConfig.tiny(), device="cpu")
    init_module_weights(enc, gen)
    init_module_weights(dec, gen)
    torch.save({"sec_encoder": enc.state_dict(),
                "sec_decoder": dec.state_dict()}, path)
    return path


def test_resume_mid_accumulation_window_is_bit_exact(tmp_path):
    """8-bit AdamW, accumulation 2, the three dropouts and the
    text-encoder LoRA: a run of 4 micro-steps against one resumed from
    micro-step 3, the middle of a window; every trainable bit for bit, and
    the resumed step's metrics equal."""
    from aqualora_torch.train import ppft_train as pt
    out = str(tmp_path / "run")
    base = ["--tiny", "--train_batch_size", "2", "--device", "cpu",
            "--output_dir", out, "--report_to", "none",
            "--checkpointing_steps", "1", "--lr_warmup_steps", "0",
            "--max_train_steps", "4", "--gradient_accumulation_steps", "2",
            "--use_8bit_adam", "--lora_dropout", "0.2", "--module_dropout",
            "0.2", "--rank_dropout", "0.1", "--train_text_encoder",
            "--start_from_pretrain", _pretrain_file(str(tmp_path / "s1.pt"))]

    def trained(res):
        tr = res["trainer"]
        return {n: p.detach().clone() for part in (tr.pipe.unet, tr.pipe.clip,
                                                   tr.pipe.mapper)
                for n, p in part.named_parameters()
                if p.requires_grad}

    full = pt.run(pt.build_argparser().parse_args(base))
    want = trained(full)
    ck = pt.CheckpointManager(os.path.join(out, "checkpoints")).restore(3)
    assert ck["accumulator"]["mini_step"] == 1
    assert any(a.abs().max() > 0 for a in ck["accumulator"]["acc"])
    assert any(st["m_code"].dtype == torch.int8
               for st in ck["optimizer"]["state"].values())
    res = pt.run(pt.build_argparser().parse_args(
        base + ["--resume_from_checkpoint", "3"]))
    assert res["start_step"] == 3
    got = trained(res)
    assert set(got) == set(want) and len(want) > 50
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert res["history"] == full["history"][3:]
    assert full["history"][-1]["ppft_loss"] > 0


def test_debug_nans_raises_on_a_non_finite_step():
    """`--debug_nans`: a learning rate of 1e30 sends the first update's
    weights (decay alone: the loss starts at 0) beyond what float32 holds
    through the LoRA branch, the second step's loss is not finite, and the
    run stops there naming the step."""
    from aqualora_torch.train import ppft_train as pt
    args = pt.build_argparser().parse_args(
        ["--tiny", "--train_batch_size", "2", "--device", "cpu",
         "--report_to", "none", "--max_train_steps", "3",
         "--lr_warmup_steps", "0", "--learning_rate", "1e30",
         "--debug_nans"])
    with pytest.raises(FloatingPointError, match="step 2"):
        pt.run(args)
