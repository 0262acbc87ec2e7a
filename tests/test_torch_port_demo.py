"""The port's demo (`aqualora_torch/run_demo.py`) against the JAX package's
top-level `run_demo.py`, on the CPU: the tiny end to end run on a tiny
artifact folder (the PPFT trainer's files), the blank secret's seeded draw
equal to JAX's for the same seed, and the comma-separated multi-secret
plumbing (the counterparts of tests/test_eval_runners.py,
tests/test_trainers.py and tests/test_fold.py's demo tests)."""

import argparse
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny PPFT output folder: seeded LoRA and mapper of the tiny
    pipeline and a seeded tiny SecretDecoder, written by the trainer's
    `save_artifacts`."""
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train.ppft_train import save_artifacts

    cfg = PipelineConfig.tiny()
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(seed=3)
    dec = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.tiny(),
                        device="cpu")
    init_module_weights(dec, torch.Generator().manual_seed(4))
    folder = str(tmp_path_factory.mktemp("ppft"))
    save_artifacts(folder, pipe, dec)
    return folder


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "run_demo", os.path.join(REPO, "run_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def test_run_demo_tiny_end_to_end(artifacts, tmp_path, capsys, monkeypatch):
    """`main_cli --tiny` drives fold -> DDIM generate -> decode on the CPU;
    a blank secret is drawn from --seed: the same seed gives the same
    bits, and they are the JAX demo's draw on the same folder."""
    from aqualora_torch import run_demo

    def cli(seed):
        run_demo.main_cli(argparse.Namespace(
            model_path=None, aqualora_folder=artifacts, secret="",
            prompt="a cat", negative_prompt="", steps=2, cfg=7.5,
            seed=seed, msg_bits=48, msgdecoder_path=None, resolution=512,
            output_dir=str(tmp_path / "demo"), int8=False, tiny=True,
            device="cpu"))
        out = capsys.readouterr().out
        assert "decoded" in out and "saved 1 image(s)" in out
        return re.search(r"embedded secret: (\d+)", out).group(1)

    first = cli(7)
    assert first == cli(7)           # blank secret is seed-reproducible
    assert sorted(os.listdir(tmp_path / "demo")) == ["7_0.png"]
    # the JAX demo on the same folder (its generate and decode stubbed)
    jdemo = _jax_demo()
    monkeypatch.setattr(jdemo, "simple_sample", lambda *a, **k: ["img"])
    bits = len(first)
    _, j_bits, j_decoded = jdemo.process(None, artifacts, "", "a cat",
                                         msg_bits=bits, seed=7)
    assert j_decoded is None and j_bits == first


def test_run_demo_blank_secret_is_seeded(monkeypatch):
    """A blank single --secret draws its random watermark from --seed."""
    from aqualora_torch import run_demo

    def fake_fold(folder, scale, msg_bits, hidinfo, save, rng=None):
        assert hidinfo is None and rng is not None
        return "".join(map(str, rng.integers(0, 2, msg_bits))), {}

    monkeypatch.setattr(run_demo, "create_watermark_lora", fake_fold)
    monkeypatch.setattr(run_demo, "simple_sample", lambda *a, **k: ["img"])
    run = lambda seed: run_demo.process(None, "/nonexistent", "", "a cat",
                                        msg_bits=8, seed=seed)[1]
    assert run(5) == run(5)
    assert run(5) != run(6)


def test_run_demo_multi_secret_plumbing(monkeypatch):
    """process(--secret a,b[,blank]) routes through the per-image messages
    path: one simple_sample call, batch == #secrets, blanks filled with
    seeded-random bitstrings, the device passed on."""
    from aqualora_torch import run_demo

    calls = {}

    def fake_sample(model, sampler, prompts, **kw):
        calls.update(kw, prompts=prompts)
        return ["img"] * len(prompts)

    monkeypatch.setattr(run_demo, "simple_sample", fake_sample)
    msg_a, msg_b = "01" * 4, "10" * 4
    images, bitstring, decoded = run_demo.process(
        None, "/nonexistent_folder", f"{msg_a},{msg_b},", "a cat",
        msg_bits=8, seed=5, device="cpu")
    assert len(images) == 3 and decoded is None
    assert calls["messages"] == bitstring
    assert bitstring[:2] == [msg_a, msg_b]
    assert len(bitstring[2]) == 8 and set(bitstring[2]) <= {"0", "1"}
    assert bitstring[2] == "".join(map(str, np.random.default_rng(5).integers(
        0, 2, 8)))
    assert calls["train_folder"] == "/nonexistent_folder"
    assert calls["batch_size"] == 3 and calls["prompts"] == ["a cat"] * 3
    assert calls["device"] == "cpu"


def test_run_demo_parser_and_web_without_gradio(monkeypatch, capsys):
    """The JAX parser's options plus --device (default cuda); --web without
    gradio says so and runs the CLI, as the JAX demo does."""
    from aqualora_torch import run_demo

    args = run_demo.build_parser().parse_args(
        ["--aqualora_folder", "F", "--int8", "--tiny"])
    assert (args.device, args.int8, args.steps, args.seed, args.msg_bits,
            args.output_dir) == ("cuda", "conv", 25, 0, 48, "demo_out")
    ran = []
    monkeypatch.setattr(run_demo, "main_cli", ran.append)
    monkeypatch.setitem(__import__("sys").modules, "gradio", None)
    run_demo.main(["--aqualora_folder", "F", "--web", "--device", "cpu"])
    assert "gradio not installed; falling back to CLI" in capsys.readouterr().out
    assert len(ran) == 1 and ran[0].device == "cpu"
