"""The golden gate, run_parity and the demo across torchrun ranks
(`tools/golden_gate.py`, `tools/run_parity.py`, `run_demo.py`), and
tensor parallelism of int8 sites (`parallel/partition.py` with
`ops/quant.py`), on the CPU at the tiny config.

One spawned group of two gloo ranks (`_ranks_worker.ranks_worker`, one
torch thread each, a file rendezvous) runs every case; meanwhile this
process runs the references: the three entry points in one process at the
per-rank batch, whose images, JSON files and results the ranks' must equal
bit for bit (the same generators, the same batch shape: ROADMAP C, the
note after "Not port faults"); the tiny U-Net with the same int8 sites
unsharded, which the sharded one must equal bit for bit (the int32 sums
are exact and the scales the same); and JAX's int8 U-Net with its specs
on two of conftest's CPU devices, which the port's must meet within the
float U-Net's parity tolerance.  The worker lives in a helper module
beside this file that imports nothing of JAX: a spawned child imports its
target's module, and this one imports JAX."""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch

KEY = jax.random.PRNGKey(0)
BITS = jcfg.WatermarkConfig.tiny().msg_bits           # 8
SECRETS = "10110010,01100111"
# the float U-Net's parity tolerance (tests/test_torch_port_quant.py: the
# tiny U-Net with its dense layers in int8 agrees with JAX's to 2.1e-6 at
# these weights and inputs)
UNET_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, seed):
    """tests/test_torch_port_quant.py's seeded leaves: norm scales 1,
    biases N(0, 0.1^2), everything else N(0, 1/fan_in)."""
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


def _unet_inputs(cfg):
    """tests/test_torch_port_quant.py's `_unet_inputs` (NHWC)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.unet.cross_attention_dim)
                              ).astype(np.float32)
    return x, np.array([981.0, 21.0], np.float32), ctx


def _jax_int8_unet(params, x, t, ctx):
    """JAX's tiny U-Net with its dense sites in int8 (the eager conversion,
    as tests/test_torch_port_quant.py takes it), sharded by JAX's specs
    over a model axis of two CPU devices, and unsharded."""
    from jax.sharding import Mesh

    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet
    from aqualora_tpu.ops import quant as jq
    from aqualora_tpu.parallel import partition as jp

    tree = jax.tree_util.tree_map(np.asarray, jq.quantize_unet_params_int8(
        params, include_convs=False, include_dense=True))
    junet = JUNet(jcfg.PipelineConfig.tiny().unet)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    sharded = jp.shard_params(mesh, tree, jp.unet_partition_specs(tree))
    run = jax.jit(lambda p: junet.apply({"params": p}, x, t, ctx))
    return tree, np.asarray(run(sharded)), np.asarray(run(tree))


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' results and this process's references."""
    import _ranks_worker as worker

    from aqualora_torch import run_demo
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.models.unet import UNet2DConditionModel as TUNet
    from aqualora_torch.ops import quant as tq
    from aqualora_torch.parallel import dryrun
    from aqualora_torch.tools import golden_gate, run_parity
    from aqualora_tpu.models.unet import UNet2DConditionModel as JUNet

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    cfg = jcfg.PipelineConfig.tiny()
    params = jax.tree_util.tree_map(np.asarray, _fill(jax.eval_shape(
        lambda: JUNet(cfg.unet).init(
            KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 77, cfg.unet.cross_attention_dim)),
            jnp.ones((1, cfg.unet.lora.rank))))["params"], 11))
    x, t, ctx = _unet_inputs(cfg)
    states = {}
    for mode, convs in (("dense", False), ("all", True)):
        unet = TUNet(PipelineConfig.tiny().unet)
        unet.load_state_dict(jax_params_to_torch(params), strict=True)
        tq.quantize_unet_int8(unet, convs, True)
        states[mode] = unet.state_dict()

    gate_argv = ["--synthetic", "--tiny", "--via_merge", "--msg_bits",
                 str(BITS), "--num_prompts", "1", "--num_inference_steps",
                 "2", "--device", "cpu"]
    parity_argv = ["--synthetic", "--tiny", "--skip_int8", "--skip_merge",
                   "--gate_num_prompts", "1", "--eval_num_prompts", "2",
                   "--eval_num_seeds", "1", "--device", "cpu"]
    folder = os.path.join(root, "gate_one", "ported")
    demo_argv = ["--tiny", "--device", "cpu", "--aqualora_folder", folder,
                 "--steps", "2", "--seed", "5"]
    spec = {"root": os.path.join(root, "ranks"),
            "gate_argv": gate_argv + ["--batch_size", "2"],
            "parity_argv": parity_argv + ["--batch_size", "2"],
            "demo_argv": demo_argv + ["--secret", SECRETS],
            "gate_refused_argv": gate_argv + ["--batch_size", "3"],
            "parity_refused_argv": parity_argv + ["--batch_size", "3"],
            "demo_refused_argv": demo_argv + ["--secret", "10110010"],
            "int8_states": states,
            "unet_inputs": (torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(t), torch.from_numpy(ctx))}
    spec_path, out_path = (os.path.join(root, n) for n in ("spec.pt",
                                                            "out.pt"))
    # the demo reads the ported folder of this process's gate, which the
    # ranks' start after: the gate comes first here too
    ref = {"gate": golden_gate.main(gate_argv + [
        "--batch_size", "1", "--out", os.path.join(root, "gate_one")])}
    torch.save(spec, spec_path)
    group = dryrun.Spawned(worker.ranks_worker, 2, spec_path, out_path)
    try:
        ref["gate_files"] = worker.written(os.path.join(root, "gate_one"))
        where = os.path.join(root, "parity_one")
        ref["parity"] = run_parity.main(parity_argv + [
            "--batch_size", "1", "--out", where])
        ref["parity_files"] = worker.written(where)
        where = os.path.join(root, "demo_one")
        ref["demo"] = run_demo.process(
            None, folder, SECRETS, "a photo of a cat", steps=2, seed=5,
            msg_bits=BITS, resolution=64, output_dir=where,
            config=PipelineConfig.tiny(),
            backbone=EfficientNetConfig.tiny(), device="cpu", batch_size=1)
        ref["demo_files"] = worker.written(where)
        ref["unet_int8"] = {mode: worker.tp_int8_unet(spec, mode)
                            for mode in states}
        jtree, ref["jax_sharded"], ref["jax_whole"] = _jax_int8_unet(
            params, x, t, ctx)
        ref["jax_tree_state"] = jax_params_to_torch(jtree)
        ref["port_dense_state"] = states["dense"]
    finally:
        group.join()
    got = torch.load(out_path, weights_only=False)
    yield got, ref
    tmp.cleanup()


def _same_files(got: dict, want: dict, case: str) -> None:
    assert got and sorted(got) == sorted(want), case
    for name, data in want.items():
        if name.endswith(".json"):
            assert json.loads(got[name]) == json.loads(data), name
        else:
            assert got[name] == data, name


def test_gate_across_ranks_equals_one_process(ranks):
    """The golden gate (the synthetic release, the port, the fold, the
    merge workflow's files written by rank 0 and read by both) on two ranks
    at --batch_size 2: the same PNG bytes, golden_gate.json and result as
    one process at --batch_size 1."""
    got, ref = ranks
    assert got["gate"] == ref["gate"]
    assert any(n.startswith("images_merged") for n in ref["gate_files"])
    _same_files(got["gate_files"], ref["gate_files"], "gate")


def test_run_parity_across_ranks_equals_one_process(ranks):
    """run_parity (the gate, then run_eval_base) on two ranks at
    --batch_size 2 against one process at 1: PARITY.json, every leg's
    files and the result."""
    got, ref = ranks
    assert got["parity"] == ref["parity"]
    assert "PARITY.json" in ref["parity_files"]
    _same_files(got["parity_files"], ref["parity_files"], "parity")


def test_demo_across_ranks_equals_one_process(ranks):
    """The demo with two secrets (one image a rank) against `process` in
    one process at batch 1: the PNG bytes, the images, the secrets and the
    decoded bits."""
    got, ref = ranks
    images, bitstring, decoded = got["demo"]
    r_images, r_bitstring, r_decoded = ref["demo"]
    assert bitstring == r_bitstring == SECRETS.split(",")
    assert decoded == r_decoded and len(decoded) == 2
    np.testing.assert_array_equal(np.stack(images), np.stack(r_images))
    _same_files(got["demo_files"], ref["demo_files"], "demo")


def test_a_world_that_does_not_divide_is_refused(ranks):
    """Two ranks refuse the gate's and run_parity's --batch_size 3 and the
    demo's one image, naming the numbers, before any file is written."""
    got, _ = ranks
    gate, parity, demo = got["refusals"]
    assert "batch 3 is not divisible by the 2" in gate
    assert "batch 3 is not divisible by the 2" in parity
    assert "the demo's batch 1 is not divisible by the 2" in demo
    assert got["refused_files"] == []


@pytest.mark.parametrize("mode", ["dense", "all"])
def test_int8_tp_unet_equals_the_unsharded_one(ranks, mode):
    """The tiny U-Net with its dense sites in int8 (and its convolutions
    too, which stay whole), its column sites (to_q, to_k, to_v, GEGLU's
    proj) and row sites (to_out, ff's net.2) sharded over two ranks,
    against the same U-Net unsharded: bit for bit."""
    got, ref = ranks
    np.testing.assert_array_equal(got["unet_int8"][mode],
                                  ref["unet_int8"][mode])


def test_int8_tp_unet_matches_jax_sharded(ranks):
    """The port's sharded int8 U-Net (dense sites) against JAX's, sharded
    by JAX's specs on two CPU devices (GSPMD reduces the row sites' absmax
    and their int32 sums), within UNET_TOL; the port's int8 tree is JAX's
    eager conversion tensor for tensor."""
    got, ref = ranks
    state = ref["jax_tree_state"]
    assert all(torch.equal(ref["port_dense_state"][k], v)
               for k, v in state.items())
    want = ref["jax_sharded"]
    assert np.abs(want - ref["jax_whole"]).max() <= 1e-6
    np.testing.assert_allclose(
        np.transpose(got["unet_int8"]["dense"], (0, 2, 3, 1)), want,
        rtol=0, atol=UNET_TOL)


def test_int8_row_site_needs_the_absmax_all_reduce(ranks):
    """Without the max-reduction of the row sites' absmax each rank
    quantizes its half of a row at its own scale, and the output leaves
    the unsharded one by far more than the tolerance."""
    got, ref = ranks
    err = np.abs(got["unet_int8_local"] - ref["unet_int8"]["dense"]).max()
    assert err > 100 * UNET_TOL, err
