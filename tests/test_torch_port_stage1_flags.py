"""Stage 1's options of the port, on the CPU at the tiny configuration:
`--resume_from_ckpt` (a resumed run equals an uninterrupted one bit for
bit, with JAX's resume curriculum), `--remat_vae_decode` and
`--remat_lpips` (the loss and every gradient unchanged), the tracker with
JAX's scalar names, the per-epoch sample image and `--debug_nans`.  One
stage-1 step is held against the JAX trainer in
tests/test_torch_port_stage1.py; these options change no number of it."""

import os
import shutil

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REALISTIC = os.path.join(REPO, "tests", "torch_port_images", "realistic")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host, and a thread pool as wide as the host
    in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _folder(root, n=2):
    """A folder of `n` JPEGs: at batch 2 an epoch of one step."""
    os.makedirs(root)
    for f in sorted(os.listdir(REALISTIC))[:n]:
        shutil.copy(os.path.join(REALISTIC, f), root)
    return root


def _run(out, data, *extra):
    from aqualora_torch.train import latent_wm_pretrain as s1
    return s1.run(s1.build_argparser().parse_args(
        ["--tiny", "--batch_size", "2", "--device", "cpu", "--dataset", data,
         "--output_dir", out, *extra]))


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Run A trains epoch 0 and checkpoints it; run B resumes A's latest
    and trains epochs 1 and 2; run C resumes epoch 1's checkpoint alone
    and trains epoch 2.  C's epoch-2 checkpoint (encoder, decoder with its
    BatchNorm statistics, optimizer, schedule, generator) and its
    artifact equal B's bit for bit.  A resumed run skips the warm-up and
    takes the late loss weights (5, 1, 1.5), as JAX's; each epoch writes
    its sample image."""
    from aqualora_torch.core.checkpoint import CheckpointManager
    from aqualora_torch.eval.image_io import load_png

    data = _folder(str(tmp_path / "img"))
    a = str(tmp_path / "a")
    ra = _run(a, data, "--epochs", "1")
    assert ra["start_epoch"] == 0
    assert ra["history"][0]["loss"] == ra["history"][0]["msgloss"]  # warm-up
    rb = _run(a, data, "--epochs", "2", "--resume_from_ckpt", "latest")
    assert rb["start_epoch"] == 1 and len(rb["history"]) == 2
    for h in rb["history"]:
        np.testing.assert_allclose(
            h["loss"], 5 * h["lpips_loss"] + h["msgloss"]
            + 1.5 * h["prvl_loss"], rtol=1e-5)
        assert h["prvl_loss"] > 0
    c = str(tmp_path / "c")
    os.makedirs(os.path.join(c, "checkpoints"))
    shutil.copy(os.path.join(a, "checkpoints", "1.pt"),
                os.path.join(c, "checkpoints", "1.pt"))
    rc = _run(c, data, "--epochs", "1", "--resume_from_ckpt", "1")
    assert rc["start_epoch"] == 2
    assert rc["history"] == rb["history"][1:]
    want = CheckpointManager(os.path.join(a, "checkpoints")).restore(2)
    got = CheckpointManager(os.path.join(c, "checkpoints")).restore(2)
    assert want["epoch"] == 2 and _equal(got, want)
    assert _equal(torch.load(os.path.join(c, "pretrained_latentwm.pt")),
                  torch.load(os.path.join(a, "pretrained_latentwm.pt")))
    assert sorted(os.listdir(os.path.join(a, "log_images"))) == [
        f"watermarked_{e}.png" for e in range(3)]
    png = load_png(os.path.join(c, "log_images", "watermarked_2.png"))
    assert png.shape == (64, 64, 3) and png.std() > 0


def _loss_and_grads(models, d, ctl, **remat):
    from aqualora_torch.train import latent_wm_pretrain as s1
    images = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 3, 64, 64)).astype(np.float32))
    for m in (models.sec_encoder, models.sec_decoder):
        m.zero_grad(set_to_none=True)
    loss, metrics = s1.make_loss_fn(models, **remat)(images, d, ctl)
    loss.backward()
    return metrics, [p.grad.clone() for m in (models.sec_encoder,
                                              models.sec_decoder)
                     for p in m.parameters()]


@pytest.mark.parametrize("remat", [{"remat_vae_decode": True},
                                   {"remat_lpips": True},
                                   {"remat_vae_decode": True,
                                    "remat_lpips": True}])
def test_remat_keeps_loss_and_grads(remat):
    """The same draws with and without the remat flags: every loss term
    and every gradient bit for bit (every term live)."""
    from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                            WatermarkConfig)
    from aqualora_torch.diffusion.pipeline import init_module_weights
    from aqualora_torch.train import latent_wm_pretrain as s1

    models = s1.build_models(VAEConfig.tiny(), WatermarkConfig.tiny(),
                             EfficientNetConfig.tiny(), "cpu")
    s1.init_models(models, 0)
    init_module_weights(models.sec_encoder, torch.Generator().manual_seed(1))
    ctl = s1.Control()
    d = s1.draw(models, torch.Generator().manual_seed(2), (2, 3, 64, 64),
                ctl.distort_probs)
    state = {k: v.clone() for k, v in models.sec_decoder.state_dict().items()}
    want, g_want = _loss_and_grads(models, d, ctl)
    models.sec_decoder.load_state_dict(state)     # BatchNorm statistics
    got, g_got = _loss_and_grads(models, d, ctl, **remat)
    for k in ("loss", "lpips_loss", "msgloss", "prvl_loss"):
        assert float(want[k]) > 0, k
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert sum(float(g.abs().max()) > 0 for g in g_want) > 10


def test_tracker_names_and_debug_nans(tmp_path, monkeypatch):
    """The tracker gets JAX's scalar names (`Loss/train`, `Loss/lpips_loss`,
    `Loss/prvl_loss`, `Loss/msgloss` a step, `Accuracy/train` an epoch);
    `--debug_nans` raises on a non-finite loss."""
    from aqualora_torch.train import latent_wm_pretrain as s1

    logged = []

    class Recorder:
        def __init__(self, output_dir, report_to):
            logged.append(report_to)

        def log(self, metrics, step):
            logged.append((sorted(metrics), step))

        def close(self):
            logged.append("closed")

    monkeypatch.setattr(s1, "Tracker", Recorder)
    data = _folder(str(tmp_path / "img"))
    _run(str(tmp_path / "a"), data, "--epochs", "2", "--report_to", "wandb")
    loss = (["Loss/lpips_loss", "Loss/msgloss", "Loss/prvl_loss",
             "Loss/train"])
    assert logged == ["wandb", (loss, 1), (["Accuracy/train"], 0),
                      (loss, 2), (["Accuracy/train"], 1), "closed"]

    build = s1.build_trainer

    def nan_step(args):
        tr = build(args)
        step = tr.train_step

        def poisoned(*a):
            m = step(*a)
            m["loss"] = m["loss"] * float("nan")
            return m
        tr.train_step = poisoned
        return tr

    monkeypatch.setattr(s1, "build_trainer", nan_step)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        _run(str(tmp_path / "b"), data, "--debug_nans")
