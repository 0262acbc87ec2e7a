"""The port's parallelism (`aqualora_torch/core/sharding.py`,
`parallel/partition.py`, `parallel/dryrun.py`) against the JAX package's,
on the CPU.

The pure rules (`make_data_mesh`'s device count, `fsdp_spec`, `_spec_for`)
are held against JAX's own functions on the same cases.  Two groups of two
spawned ranks (gloo, one torch thread each, a file rendezvous) run the
rest: the first the PPFT update data parallel, under `--fsdp` and tensor
parallel (1 x 2) against JAX's update on a 2-device data mesh with JAX's
own tolerances (`tests/test_multichip.py`), the data-parallel update with
the kohya dropouts and the stage-1 and stage-3 updates against the port's
one-process update, the `--fsdp` resume and the refusal
of a batch the world does not divide; the second `dryrun_multichip(2)`.
The workers live in `aqualora_torch.parallel.dryrun`: a spawned child
imports its target's module, and this one imports JAX."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aqualora_torch.core import sharding as tsh

KEY = jax.random.PRNGKey(0)
RES = 32
B = 4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# the pure rules, against JAX's functions
# ---------------------------------------------------------------------------

def test_data_mesh_size_matches_jax():
    """`data_axis_size` is JAX's `make_data_mesh` device count for batches
    1-12 on 1-8 devices (the conftest's 8 virtual CPU devices)."""
    from aqualora_tpu.core import sharding as jsh

    assert jax.device_count() >= 8
    for n in range(1, 9):
        for b in range(1, 13):
            want = jsh.make_data_mesh(b, jax.devices()[:n]).devices.size
            assert tsh.data_axis_size(b, n) == want, (b, n)


def _as_jax_spec(placement, ndim):
    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor import Shard

    if not isinstance(placement, Shard):
        return P()
    spec = [None] * ndim
    spec[placement.dim] = "data"
    return P(*spec)


@pytest.mark.parametrize("shape,dtype,n", [
    ((320, 2048), np.float32, 8), ((4096, 30), np.float32, 8),
    ((320,), np.float32, 8), ((), np.int32, 8),
    ((77, 1023, 9), np.float32, 8), ((320, 2048), np.float32, 1),
    ((64, 64), np.float32, 8), ((2048,), np.int8, 8),
    ((8, 1024), jnp.bfloat16, 8), ((8, 512), jnp.bfloat16, 8)])
def test_fsdp_spec_matches_jax(shape, dtype, n):
    """`fsdp_spec` on `tests/test_parallel.py`'s cases and a few more
    (a leaf at the 16 KiB edge, an int8 leaf, a 2-byte leaf) against
    JAX's `fsdp_spec` on an n-device mesh."""
    from aqualora_tpu.core import sharding as jsh

    mesh = jsh.make_mesh(jax.devices()[:n])
    x = np.zeros(shape, dtype)
    want = jsh.fsdp_spec(x, mesh)
    got = tsh.fsdp_spec(shape, np.dtype(dtype).itemsize, n)
    assert _as_jax_spec(got, len(shape)) == want


def test_spec_for_matches_jax_on_every_unet_weight():
    """`_spec_for` on every parameter name of the tiny U-Net against JAX's
    `_spec_for` on the flax path it converts from: JAX's column spec on a
    kernel [in, out] is the port's ("model", None) on a weight [out, in],
    its row spec (None, "model")."""
    import flax.traverse_util as tu
    from jax.sharding import PartitionSpec as P

    from aqualora_torch.core.config import UNetConfig as TCfg
    from aqualora_torch.core.convert import jax_params_to_torch
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_torch.parallel import partition as tp
    from aqualora_tpu.core.config import UNetConfig as JCfg
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet
    from aqualora_tpu.parallel.partition import _spec_for as j_spec

    cfg = JCfg.tiny()
    shapes = jax.eval_shape(lambda: JUNet(cfg).init(
        KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, cfg.cross_attention_dim)),
        jnp.ones((1, cfg.lora.rank)))["params"])
    flat = tu.flatten_dict(shapes)
    # one distinct value a leaf, to find each torch name's flax path
    tagged = tu.unflatten_dict({k: np.full(s.shape, i, np.float32)
                                for i, (k, s) in enumerate(flat.items())})
    names = {int(v.reshape(-1)[0]): k
             for k, v in jax_params_to_torch(tagged).items()}
    paths = list(flat)
    to_jax = {(): P(), tp.COLUMN: P(None, "model"), tp.ROW: P("model", None)}
    specs = tp.unet_partition_specs(TUNet(TCfg.tiny()))
    assert set(specs) == set(names.values())
    by_name = {name: paths[i] for i, name in names.items()}
    sharded = 0
    for name, spec in specs.items():
        assert to_jax[spec] == j_spec(by_name[name]), name
        sharded += spec != ()
    # q, k, v, out of both attentions and the feed-forward's two a block
    blocks = sum(n.endswith("attn1.to_q.weight") for n in specs)
    assert blocks > 0 and sharded == 10 * blocks


def test_world_that_does_not_divide_the_batch_is_refused():
    """JAX leaves devices idle; a torchrun rank cannot, so the batch must
    split evenly: a ValueError naming both numbers."""
    with pytest.raises(ValueError, match="global batch 6 .* 4 "):
        tsh.check_world_divides(6, 4)
    tsh.check_world_divides(8, 4)
    assert tsh.local_batch_size(8, 4) == 2
    assert tsh.batch_slice(8, 3, 4) == slice(6, 8)
    batch = (np.arange(8), ["a", "b", "c", "d", "e", "f", "g", "h"], None)
    got = tsh.shard_batch(batch, 1, 4)
    assert list(got[0]) == [2, 3] and got[1] == ["c", "d"] and got[2] is None


def test_batch_norm_without_a_group_is_unchanged():
    """With no process group (or a group of 1) train-mode BatchNorm is the
    one-process code: `F.batch_norm` and the biased running update, bit for
    bit."""
    from aqualora_torch.models.efficientnet import (BN_MOMENTUM, BatchNorm2d,
                                                    global_batch_norm)

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 7, 6, generator=g) * 2 + 1
    bn = BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(5, generator=g))
        bn.bias.copy_(torch.rand(5, generator=g))
        bn.running_var.fill_(0.5)
    want_y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                          bn.eps)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    want_mean = BN_MOMENTUM * torch.zeros(5) + (1 - BN_MOMENTUM) * mean
    want_var = BN_MOMENTUM * torch.full((5,), 0.5) + (1 - BN_MOMENTUM) * var
    with global_batch_norm(None):
        y = bn(x, train=True)
    assert torch.equal(y, want_y)
    assert torch.equal(bn.running_mean, want_mean)
    assert torch.equal(bn.running_var, want_var)


def test_entry_runs_on_the_cpu_at_the_tiny_config():
    """`entry()` -> (fn, args), the bf16 U-Net forward with its LoRA at a
    CFG batch of 2, run once at the tiny configuration."""
    from aqualora_torch.parallel.dryrun import entry

    fn, args = entry("cpu", tiny=True)
    out = fn(*args)
    assert out.shape == args[0].shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# spawn 1: the 2-rank updates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity():
    """JAX's PPFT update on a 2-device data mesh (global batch 4 at 32 px,
    the tiny config) and the port's 2-rank updates on the same weights and
    draws; the port's one-process stage-1 and stage-3 updates."""
    import flax.traverse_util as tu
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from aqualora_torch.parallel import dryrun
    from aqualora_tpu.core import sharding as jsh
    from aqualora_tpu.core.config import PipelineConfig
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.models.watermark import SecretEncoder
    from aqualora_tpu.train import ppft_train as jt

    cfg = PipelineConfig.tiny()
    bits, grid = cfg.watermark.msg_bits, cfg.watermark.secret_grid
    jpipe = StableDiffusionPipeline(cfg)
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, RES, RES)),
                   0)
    jsec = SecretEncoder(bits, grid, RES // 2, 4)
    sec = _fill(jax.eval_shape(lambda: jsec.init(
        KEY, jnp.zeros((1, RES // 2, RES // 2, 4)),
        jnp.zeros((1, bits)))), 1)["params"]
    base_flat, lora_flat = jt.split_lora(params["unet"])
    trainable = {"lora": tu.unflatten_dict(lora_flat),
                 "mapper": params["mapper"]}
    frozen = {"vae": params["vae"], "text_encoder": params["text_encoder"],
              "sec_encoder": sec}
    rng = np.random.default_rng(2)
    pixels = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (B, 77)).astype(np.int32)
    key = jax.random.PRNGKey(42)

    kmsg, kvae, knoise, kt = jax.random.split(key, 7)[:4]
    shape = (B, RES // 2, RES // 2, 4)
    draws = {"msg": torch.from_numpy(np.array(jax.random.bernoulli(
                 kmsg, 0.5, (B, bits)).astype(jnp.float32))),
             "vae_noise": _nchw(jax.random.normal(kvae, shape, jnp.float32)),
             "noise": _nchw(jax.random.normal(knoise, shape)),
             "t": torch.from_numpy(np.array(jax.random.randint(
                 kt, (B,), 0, cfg.schedule.num_train_timesteps))).long()}
    tmp = tempfile.TemporaryDirectory()
    inputs = os.path.join(tmp.name, "inputs.pt")
    out = os.path.join(tmp.name, "out.pt")
    torch.save({"params": _np(params), "sec": _np(sec), "pixels": pixels,
                "ids": ids.astype(np.int64), "draws": draws, "lr": LR},
               inputs)
    # the two ranks run while JAX compiles its step
    ranks = dryrun.Spawned(dryrun.parity_worker, 2, inputs, out)
    try:
        lr_fn = jt.cosine_with_warmup_lr_end(LR, 0, 10, 0.0)
        adamw = lambda: optax.adamw(lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                                    weight_decay=1e-2)
        tx = optax.multi_transform(
            {"lora": optax.chain(optax.clip_by_global_norm(1.0), adamw()),
             "mapper": adamw()}, {"lora": "lora", "mapper": "mapper"})
        mesh = jsh.make_mesh(jax.devices()[:2])
        put = lambda t: jax.device_put(t, NamedSharding(mesh, P()))
        batch = NamedSharding(mesh, P(jsh.DATA_AXIS))
        j_new, _, j_metrics = jt.make_train_step(jpipe, jsec, tx, bits)(
            put(trainable), put(tx.init(trainable)), put(base_flat),
            put(frozen), jax.device_put(pixels, batch),
            jax.device_put(ids, batch), key)
        one = dryrun.stage_updates(None)
        ranks.join(timeout=600)
        got = torch.load(out, weights_only=False)
    finally:
        tmp.cleanup()
    from aqualora_torch.core.convert import jax_params_to_torch
    want = jax_params_to_torch(_np(j_new["lora"]))
    want["bit_embeddings.weight"] = torch.from_numpy(
        np.array(j_new["mapper"]["bit_embeddings"]))
    return {"got": got, "j_params": want,
            "j_metrics": {k: float(v) for k, v in j_metrics.items()},
            "one": one}


def _assert_params(got, want, atol, rtol):
    assert set(got) == set(want) and len(want) > 20
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def test_dp_update_matches_jax_2_device_update(parity):
    """2-rank data parallelism against JAX's 2-device data mesh: the loss
    (rtol 1e-5), the gradient norm, and every LoRA and mapper weight after
    the update (atol 2e-5, rtol 1e-4: `test_multichip.py`'s)."""
    dp, jm = parity["got"]["dp"], parity["j_metrics"]
    assert jm["ppft_loss"] > 1e-3
    np.testing.assert_allclose(dp["loss"][0], jm["ppft_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(dp["grad_norm"][0], jm["grad_norm"],
                               rtol=1e-5)
    _assert_params(dp["params"], parity["j_params"], 2e-5, 1e-4)


def test_fsdp_update_matches_jax_and_shards_the_state(parity):
    """`--fsdp`'s layout gives the data-parallel numbers: JAX's within its
    tolerances, and the port's DP update to float32 rounding (the loss bit
    for bit; the weights within 1e-7: ZeRO's step is the DP step bit for
    bit, and FSDP2's backward hooks change only the order in which autograd
    sums the gradients of tensors used at many sites, the diagonal and the
    context).  Each rank holds about half of the frozen bytes and of the
    moments."""
    fs, dp = parity["got"]["fsdp"], parity["got"]["dp"]
    np.testing.assert_allclose(fs["loss"][0],
                               parity["j_metrics"]["ppft_loss"], rtol=1e-5)
    _assert_params(fs["params"], parity["j_params"], 2e-5, 1e-4)
    assert fs["loss"][0] == dp["loss"][0]
    _assert_params(fs["params"], dp["params"], 1e-7, 1e-6)
    assert 0.45 < fs["frozen_share"] < 0.75, fs["frozen_share"]
    assert 0.3 < fs["moment_share"] < 0.7, fs["moment_share"]


def test_tp_update_matches_jax(parity):
    """1 x 2 tensor parallelism (the GEGLU halves and the local heads as
    `partition.py` shards them) against JAX's update: loss rtol 1e-4,
    weights atol 5e-5, rtol 1e-3 (`test_multichip.py`'s TP tolerances)."""
    tp, jm = parity["got"]["tp"], parity["j_metrics"]
    np.testing.assert_allclose(tp["loss"][0], jm["ppft_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tp["grad_norm"][0], jm["grad_norm"],
                               rtol=1e-4)
    _assert_params(tp["params"], parity["j_params"], 5e-5, 1e-3)


def test_dp_update_with_lora_dropouts_matches_one_process(parity):
    """`--lora_dropout` and `--module_dropout` under 2-rank data
    parallelism: each rank's masks are its rows of the masks drawn for the
    global batch (`SiteDraws.part`), so the update equals the port's
    one-process update on the same draws (the stage tests' atol 1e-5,
    rtol 1e-4).  Both dropouts drew: some sites dropped, a seed a site."""
    d = parity["got"]["dropout"]
    dp, one = d["dp"], d["one"]
    assert d["sites"] > 0 and 0 < d["kept"] < d["sites"]
    np.testing.assert_allclose(dp["loss"][0], one["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(dp["grad_norm"][0], one["grad_norm"][0],
                               rtol=1e-5)
    _assert_params(dp["params"], one["params"], 1e-5, 1e-4)


@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_stage_dp_update_matches_one_process(parity, stage):
    """The 2-rank stage-1 and stage-3 updates against the port's own
    one-process update (which `test_torch_port_stage1.py` and
    `_stage3.py` hold against JAX): the metrics, every weight and the
    BatchNorm statistics, atol 1e-5, rtol 1e-4."""
    got, one = parity["got"][stage], parity["one"][stage]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert set(got["state"]) == set(one["state"])
    moved = 0
    for k, v in one["state"].items():
        np.testing.assert_allclose(got["state"][k].double().numpy(),
                                   v.double().numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
        moved += "running" in k
    assert moved > 0


def test_fsdp_resume_equals_the_uninterrupted_run(parity):
    """A 2-rank `--fsdp` run checkpointed at step 1 (the ZeRO moments
    consolidated on rank 0) and resumed equals the straight run bit for
    bit."""
    r = parity["got"]["resume"]
    assert r["resumed_start"] == 1
    assert r["straight_metrics"] == r["resumed_metrics"]
    assert r["straight_metrics"]["ppft_loss"] > 0
    for name, p in r["straight"].items():
        assert torch.equal(r["resumed"][name], p), name


def test_trainer_refuses_a_batch_the_world_does_not_divide(parity):
    """`build_trainer` at a global batch of 3 on 2 ranks raises ValueError
    on every rank before any collective (no hang)."""
    msg = parity["got"]["refusal"]
    assert "global batch 3" in msg and "2 data-parallel ranks" in msg


# ---------------------------------------------------------------------------
# spawn 2: the dryrun
# ---------------------------------------------------------------------------

def test_dryrun_multichip_2():
    """`dryrun_multichip(2)`: the four legs of `__graft_entry__.py`'s
    dryrun on two ranks, their asserts included."""
    from aqualora_torch.parallel.dryrun import dryrun_multichip

    r = dryrun_multichip(2)
    assert r["ppft_loss"] > 0 and r["grad_norm"] > 0
    assert abs(r["fsdp_loss"] - r["ppft_loss"]) <= 1e-5 * max(
        1.0, r["ppft_loss"])
    assert r["stage1_msgloss"] > 0 and r["stage3_loss"] > 0
    assert (r["data"], r["model"]) == (2, 1)


@pytest.mark.parametrize("center_crop", [False, True])
def test_dataset_parts_are_the_global_batch_rows(center_crop):
    """Each rank's `part` of an image folder's batch is that batch's rows,
    flips included (drawn for the whole batch), decoding only its own
    files; the synthetic dataset's likewise."""
    from aqualora_torch.train import data

    folder = os.path.join(os.path.dirname(__file__), "torch_port_images",
                          "realistic")
    ds = data.make_dataset(folder, 32, center_crop=center_crop,
                           random_flip=True, num_threads=1)
    for d in (ds, data.SyntheticDataset(16, size=8)):
        whole = next(d.batches(4, seed=3))
        for rank in range(2):
            imgs, caps = next(d.batches(4, seed=3, part=(rank, 2)))
            rows = slice(2 * rank, 2 * rank + 2)
            assert np.array_equal(imgs, whole[0][rows])
            assert caps == (None if whole[1] is None else whole[1][rows])
