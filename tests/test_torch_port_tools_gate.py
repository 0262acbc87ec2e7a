"""The port's golden gate and parity runbook (`aqualora_torch/tools/
{golden_gate, run_parity}.py`) against the JAX package's
`scripts/golden_gate.py`, on the CPU at the tiny config.

Both gates run `--synthetic --tiny --via_merge --num_prompts 1
--batch_size 1` with `--sd_model` set to one tiny diffusers directory of
seeded JAX weights, and the port replays the JAX pipeline's initial
latents (`tests/test_torch_port_eval.py`'s helpers), so both denoise the
same numbers: the same message and decoded bits, images within the eval
tests' tolerance on the fold and the merge path, both merge differences
under 4/255, and the merged U-Net, VAE and text encoder equal to JAX's
merged tree.  Then the w8a8 legs (`--int8`, `--train_decoder_steps`)
and run_parity's int8 leg on the CPU, the refusals (a trained-decoder
leg without --int8, a release folder with none of the files) and
run_parity's PARITY.json.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import aqualora_tpu.core.config as jcfg
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.diffusion import pipeline as tpl
from aqualora_torch.eval import utils_eval as tu
from aqualora_torch.tools import golden_gate as tgate
from aqualora_torch.tools import run_parity as tparity
from test_torch_port_eval import (IMAGE_TOL, KEY, REPO, _fill, _jax_latents,
                                  _Recorder, _Replay, _skip_jax_eager_inits,
                                  _write_diffusers_dir)

GATE_ARGS = ["--synthetic", "--tiny", "--via_merge", "--num_prompts", "1",
             "--batch_size", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_gate():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_gate", os.path.join(REPO, "scripts", "golden_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Keep:
    """Wraps a function and keeps its results."""

    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, *a, **k):
        self.out.append(self.fn(*a, **k))
        return self.out[-1]


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    """Both gates on one tiny diffusers checkpoint, with the port's
    initial latents the JAX pipeline's (fold path, then merge path)."""
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_tpu.eval import utils_eval as ju
    root = tmp_path_factory.mktemp("gates")
    params = jax.tree_util.tree_map(np.asarray, _fill(jax.eval_shape(
        lambda: StableDiffusionPipeline(jcfg.PipelineConfig.tiny())
        .init_params(KEY, 32, 32)), 5))
    sd = str(root / "sd")
    _write_diffusers_dir(sd, params)
    jgate = _jax_gate()
    jrec, trec = _Recorder(ju.images_to_pil), _Recorder(tu.images_to_uint8)
    jmerged = _Keep(jgate._merged_params_via_ldm)
    tmerged = _Keep(tgate.merged_params_via_ldm)
    replay = _Replay(_jax_latents([0], 1, 1, shape=(32, 32, 4)) * 2)
    # the JAX gate turns on jax's persistent compile cache in the checkout,
    # which would stay on for every later test of this worker (putting the
    # setting back does not turn the cache off): it is kept off here
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda k, v: None if k in (
            "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs") else update(k, v))
        _skip_jax_eager_inits(mp, {"params": params})
        mp.setattr(ju, "images_to_pil", jrec)
        mp.setattr(tu, "images_to_uint8", trec)
        mp.setattr(tpl, "batch_randn", replay)
        mp.setattr(jgate, "_merged_params_via_ldm", jmerged)
        mp.setattr(tgate, "merged_params_via_ldm", tmerged)
        jres = jgate.run(jgate.build_argparser().parse_args(
            GATE_ARGS + ["--sd_model", sd, "--out", str(root / "j")]))
        tres = tgate.main(GATE_ARGS + ["--sd_model", sd, "--device", "cpu",
                                       "--out", str(root / "t")])
    assert replay.calls == len(replay.draws) == 2
    return {"j": jres, "t": tres, "root": root,
            "images": (np.concatenate(jrec.seen), np.concatenate(trec.seen)),
            "merged": (jmerged.out[0], tmerged.out[0])}


def test_gate_tiny_matches_jax(gates):
    """The same message and decoded bits, the same result keys and bit
    accuracy; the fold-path and merge-path images within IMAGE_TOL of
    JAX's; both merge differences under 4/255; the files of the merge
    workflow written."""
    j, t = gates["j"], gates["t"]
    assert set(t) == set(j)
    for key in ("message", "decoded", "bit_acc", "tpr", "synthetic",
                "model", "int8"):
        assert t[key] == j[key], key
    assert len(t["message"]) == 48 and t["model"] == "tiny"
    assert t["merge_img_diff"] < 4.0 and j["merge_img_diff"] < 4.0
    jimg, timg = gates["images"]
    assert timg.shape == jimg.shape == (2, 64, 64, 3)
    assert jimg.std() > 0.1
    np.testing.assert_allclose(timg, jimg, atol=IMAGE_TOL)
    out = gates["root"] / "t"
    for name in ("watermark.safetensors", "watermark_SDmodel.safetensors",
                 "golden_gate.json", "ported/msgdecoder.pt",
                 "ported/pretrained_latentwm.pt"):
        assert (out / name).exists(), name
    assert json.loads((out / "golden_gate.json").read_text()) == t


def test_gate_merged_states_match_jax(gates):
    """The merged single file read back: the U-Net's base weights, the VAE
    and the text encoder equal JAX's merged tree (rtol 1e-6, and 1e-6 of
    each tensor's largest element: the delta's float32 sums differ in their
    last bit); the merge moved every LoRA site's weight."""
    jm, tm = gates["merged"]
    for name in ("unet", "vae", "text_encoder"):
        ref = jax_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                         jm[name]))
        port = tm[name]
        assert set(port) == set(ref), name
        for k, v in ref.items():
            if ".lora." in k:
                continue
            np.testing.assert_allclose(
                port[k].numpy(), v.numpy(), rtol=1e-6,
                atol=1e-6 * v.abs().max().item(), err_msg=k)
    from aqualora_torch.core.config import UNetConfig
    from aqualora_torch.core.io import load_safetensors, unet_module_keys
    sd = load_safetensors(os.path.join(
        gates["root"], "sd", "unet", "diffusion_pytorch_model.safetensors"))
    for mk in unet_module_keys(UNetConfig.tiny()):
        assert not torch.equal(tm["unet"][f"{mk}.weight"],
                               sd[f"{mk}.weight"]), mk


# the int8 report's keys, as `scripts/golden_gate.py:332-360,470-488`
# writes them
INT8_KEYS = {"mode", "img_diff", "bit_acc", "tpr", "n_images",
             "decode_agreement_vs_bf16", "logit_sensitivity"}
SENSITIVITY_KEYS = {"mean_abs_margin", "min_abs_margin",
                    "int8_margin_delta_mean", "int8_margin_delta_max",
                    "cross_image_spread_mean", "max_delta_over_min_margin",
                    "mean_delta_over_spread", "release_decoder_bit_constant"}
TRAINED_KEYS = {"stage1_steps", "stage1_final_acc",
                "decode_agreement_vs_bf16", "jpeg50_control_agreement",
                "jpeg95_control_agreement", "margin_delta_int8",
                "margin_delta_jpeg50", "margin_delta_jpeg95",
                "int8_delta_over_jpeg50", "demotion_rule_met"}


@pytest.mark.parametrize("flag", [
    ["--int8"], ["--int8", "all+vae"],
    ["--int8", "conv", "--train_decoder_steps", "2"]])
def test_gate_runs_the_w8a8_legs(tmp_path, flag):
    """The gate's int8 leg on the CPU (the plain int8 path): the int8
    image written beside the bf16 one, JAX's report keys, agreements in
    [0, 1], the image changed by the quantization; the default agreement
    bound of 0.98 is asserted (the tiny synthetic decoder reads the same
    bits from both).  One prompt: two would run the FID smoke's 2048^2
    sqrtm.  With --train_decoder_steps the tiny stage-1 decoder
    is trained in a subprocess and read against its JPEG controls."""
    res = tgate.main(["--synthetic", "--tiny", "--num_prompts", "1",
                      "--batch_size", "1"] + flag
                     + ["--device", "cpu", "--out", str(tmp_path)])
    rep = res["int8"]
    mode = flag[1] if len(flag) > 1 else "conv"
    assert set(rep) - {"trained_decoder"} == INT8_KEYS
    assert set(rep["logit_sensitivity"]) == SENSITIVITY_KEYS
    assert rep["mode"] == mode and rep["n_images"] == 1
    assert 0.0 <= rep["decode_agreement_vs_bf16"] <= 1.0
    assert rep["img_diff"] > 0.0
    assert os.listdir(tmp_path / f"images_int8_{mode}") == ["0_0.png"]
    assert json.loads((tmp_path / "golden_gate.json").read_text()) == res
    if "--train_decoder_steps" in flag:
        td = rep["trained_decoder"]
        assert set(td) == TRAINED_KEYS and td["stage1_steps"] == 2
        assert (tmp_path / "trained_tiny_decoder" / "msgdecoder.pt").exists()
        for key in ("decode_agreement_vs_bf16", "jpeg50_control_agreement",
                    "jpeg95_control_agreement"):
            assert 0.0 <= td[key] <= 1.0
    else:
        assert "trained_decoder" not in rep


def test_gate_refuses_a_trained_decoder_leg_without_int8(tmp_path):
    """As JAX's gate: --train_decoder_steps only measures the int8
    agreement, so without --int8 it stops before anything runs."""
    with pytest.raises(SystemExit, match="requires --int8"):
        tgate.main(GATE_ARGS + ["--train_decoder_steps", "2", "--device",
                                "cpu", "--out", str(tmp_path)])
    assert not (tmp_path / "reference_release").exists()


def test_gate_refuses_a_folder_without_release_files(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="msgdecoder.pt"):
        tgate.main(["--tiny", "--train_folder", str(empty), "--device",
                    "cpu", "--out", str(tmp_path / "out")])


def test_run_parity_tiny_writes_parity_json(tmp_path):
    """The whole runbook on the CPU: the gate (port, fold, merge) and
    run_eval_base on its ported files, into PARITY.json."""
    out = tmp_path / "parity"
    res = tparity.main(["--synthetic", "--tiny", "--skip_int8", "--device",
                        "cpu", "--out", str(out), "--gate_num_prompts", "1",
                        "--batch_size", "1", "--eval_num_prompts", "2",
                        "--eval_num_seeds", "1"])
    parity = json.loads((out / "PARITY.json").read_text())
    assert parity == res
    assert parity["gate"]["merge_img_diff"] < 4.0
    assert parity["eval_base"]["n_images"] == 2
    # both legs fold with default_rng(seed 0): the same message
    assert parity["eval_base"]["message"] == parity["gate"]["message"]
    assert len(parity["gate"]["message"]) == \
        jcfg.WatermarkConfig.tiny().msg_bits
    assert parity["fid"] is None and parity["synthetic"] is True


def test_run_parity_tiny_runs_the_int8_leg(tmp_path):
    """Without --skip_int8 the gate runs its int8-conv leg, its agreement
    bound off on synthetic weights (`scripts/run_parity.py:135-140`)."""
    out = tmp_path / "parity"
    res = tparity.main(["--synthetic", "--tiny", "--skip_merge", "--device",
                        "cpu", "--out", str(out), "--gate_num_prompts", "1",
                        "--batch_size", "1", "--eval_num_prompts", "1",
                        "--eval_num_seeds", "1"])
    rep = res["gate"]["int8"]
    assert rep["mode"] == "conv" and rep["n_images"] == 1
    assert set(rep) == INT8_KEYS
    assert json.loads((out / "PARITY.json").read_text()) == res
    assert (out / "gate" / "images_int8_conv" / "0_0.png").exists()


@pytest.mark.parametrize("argv", [
    ["--synthetic", "--tiny", "--skip_int8", "--fid_meta", "x.json"]])
def test_run_parity_refusals(tmp_path, argv):
    """A --fid_meta without --fid_gt_dir stops before any leg starts."""
    with pytest.raises(SystemExit):
        tparity.main(argv + ["--device", "cpu", "--out",
                             str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()
