"""`python -m aqualora_torch.eval.run_fid --tiny --device cpu`: its guards,
and its images against themselves, as `tests/test_eval_runners.py:75-97`
holds the JAX runner.

The tiny run generates 2 images at 32 px (2 steps) with the watermark LoRA
of an artifact folder the port writes, resizes them to 299^2 and runs the
full InceptionV3 (B32, the runner's batch: 31 s of the file's time on one
CPU thread with the Frechet distance's 2048 x 2048 `sqrtm`).  Its FID
against the JAX package's is `tests/test_torch_port_fid_vs_jax.py`.
"""

import json
import os

import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
from aqualora_torch.eval import run_fid
from aqualora_torch.eval.image_io import load_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_wm_folder(root) -> str:
    """A tiny PPFT artifact folder written by the port: seeded weights,
    the LoRA ups non-zero."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train.ppft_train import save_artifacts
    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.init_params(seed=0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            if ".lora.up" in n:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    dec = SecretDecoder(tcfg.WatermarkConfig.tiny().msg_bits,
                        tcfg.EfficientNetConfig.tiny(), device="cpu")
    save_artifacts(str(root / "wm"), pipe, dec)
    return str(root / "wm")


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The artifact folder, captions in COCO's meta_data.json layout and
    the port's own file of (seeded random) Inception weights."""
    from aqualora_torch.models.inception import InceptionV3Features
    root = tmp_path_factory.mktemp("fid_art")
    meta = root / "meta_data.json"
    meta.write_text(json.dumps({"images": [], "annotations": [
        {"caption": c} for c in ("a cat", "a dog", "an owl")]}))
    model = InceptionV3Features()
    model.init_weights(torch.Generator().manual_seed(1))
    weights = str(root / "inception.pt")
    torch.save(model.state_dict(), weights)
    return {"wm": write_wm_folder(root), "meta": str(meta),
            "weights": weights, "root": root}


class _Generated(Exception):
    """Raised by a stub where the runner would start generating."""


def test_run_fid_guards(art, tmp_path, monkeypatch):
    """No Inception weights and both LoRA sources stop before any
    generation; --int8 reaches it, with its mode (conv when bare)."""
    def no_generation(*a, **k):
        raise AssertionError("generation ran")
    monkeypatch.setattr(run_fid.utils_eval, "simple_sample", no_generation)
    base = ["--meta_data", art["meta"], "--gt_dir", str(tmp_path),
            "--train_folder", art["wm"], "--output_dir", str(tmp_path),
            "--tiny", "--device", "cpu"]
    with pytest.raises(SystemExit, match="no Inception weights"):
        run_fid.main(base)
    seen = []

    def record(*a, **k):
        seen.append(k["int8"])
        raise _Generated
    monkeypatch.setattr(run_fid.utils_eval, "simple_sample", record)
    # the seeded random Inception the run would build first is not needed
    monkeypatch.setattr(run_fid, "resolve_extractor", lambda args: None)
    with pytest.raises(_Generated):
        run_fid.main(base + ["--int8", "--allow_random_inception"])
    assert seen == ["conv"]
    monkeypatch.setattr(run_fid.utils_eval, "simple_sample", no_generation)
    with pytest.raises(SystemExit, match="exactly one"):
        run_fid.main(base + ["--lora", str(tmp_path / "x.safetensors"),
                             "--allow_random_inception"])


def test_load_captions_both_layouts(tmp_path):
    """COCO's dict with 'annotations', a plain list, and metadata.jsonl;
    --start / --end slicing."""
    rows = ["a", "b", "c", "d"]
    (tmp_path / "list.json").write_text(json.dumps(rows))
    (tmp_path / "coco.json").write_text(json.dumps(
        {"annotations": [{"caption": r} for r in rows]}))
    (tmp_path / "m.jsonl").write_text(
        "".join(json.dumps({"file_name": f"{r}.png", "text": r}) + "\n"
                for r in rows))
    for name in ("list.json", "coco.json", "m.jsonl"):
        assert run_fid.load_captions(str(tmp_path / name), 2, 1) == \
            ["b", "c"]


def test_run_fid_tiny_against_its_own_images(art, tmp_path, capsys):
    """Generation, PNGs (stale ones cleared), the FID of the folder against
    itself below 1e-3, fid.json as written."""
    out = tmp_path / "fid"
    gen_dir = out / "images"
    gen_dir.mkdir(parents=True)
    (gen_dir / "stale.png").write_bytes(b"not a png")
    result = run_fid.main(["--meta_data", art["meta"], "--gt_dir",
                           str(gen_dir), "--train_folder", art["wm"],
                           "--output_dir", str(out), "--num_images", "2",
                           "--batch_size", "2", "--tiny",
                           "--inception_params", art["weights"],
                           "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "message: " in printed and "FID:" in printed
    assert sorted(os.listdir(gen_dir)) == ["0_0.png", "0_1.png"]
    assert abs(result["fid"]) < 1e-3
    assert result == {"fid": result["fid"], "n_images": 2,
                      "random_inception": False, "int8": None}
    assert json.loads((out / "fid.json").read_text()) == result
    a, b = (load_png(str(gen_dir / n)) for n in ("0_0.png", "0_1.png"))
    assert a.shape == (32, 32, 3) and not np.array_equal(a, b)
