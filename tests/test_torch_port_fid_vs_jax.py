"""`run_fid --tiny --device cpu`'s FID against the JAX package's over the
folder the port wrote, with the same Inception weights: the JAX tree's,
carried over through `jax_params_to_torch`, written in torchvision's
layout (with the `fc` head) and read by `--inception_torch_weights`.

The ground truth is an .npz of statistics (the runner's other input form),
so the Inception runs on the generated folder only.  The JAX side is
`fid_given_paths`'s own pieces (`_load_images`, `InceptionExtractor`,
`activation_statistics`) and its Frechet distance in closed form: two
images give a rank-1 covariance S = v v^T, and tr sqrt(S S2) = sqrt(v^T S2
v), which the test first holds against JAX's `frechet_distance`.  A
2048 x 2048 `sqrtm` costs about 20 s on one CPU thread; the runner's own is
the file's largest part.  Within 1e-3 relative.
"""

import json

import jax
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch
from test_torch_port_fid_runner import write_wm_folder
from test_torch_port_fidelity import _inception_vars


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frechet_two_images(feats, mu2, sigma2) -> float:
    """The Frechet distance of two images' statistics to (mu2, sigma2):
    their covariance is v v^T with v = (f1 - f2) / sqrt(2)."""
    mu1 = feats.mean(0)
    v = (feats[0] - feats[1]) / np.sqrt(2.0)
    diff = mu1 - mu2
    return float(diff @ diff + v @ v + np.trace(sigma2)
                 - 2 * np.sqrt(v @ sigma2 @ v))


def test_run_fid_matches_jax_over_the_ports_folder(tmp_path, capsys):
    from aqualora_tpu.eval import fid as jfid

    from aqualora_torch.eval import run_fid
    rng = np.random.default_rng(4)
    # the closed form against JAX's frechet_distance at a small width
    f, g = rng.standard_normal((2, 24)), rng.standard_normal((5, 24))
    np.testing.assert_allclose(
        frechet_two_images(f, g.mean(0), np.cov(g, rowvar=False)),
        jfid.frechet_distance(*jfid.activation_statistics(f),
                              *jfid.activation_statistics(g)), rtol=1e-6)

    variables = _inception_vars(seed=3)
    state = jax_params_to_torch(variables["params"], variables["batch_stats"])
    state["fc.weight"] = torch.zeros(1008, 2048)
    state["fc.bias"] = torch.zeros(1008)
    weights = str(tmp_path / "pt_inception-2015-12-05.pth")
    torch.save(state, weights)
    ref_feats = 0.5 + 0.3 * rng.standard_normal((6, 2048))
    mu2, sigma2 = ref_feats.mean(0), np.cov(ref_feats, rowvar=False)
    stats = str(tmp_path / "coco_stats.npz")
    np.savez(stats, mu=mu2, sigma=sigma2)
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps(["a cat", "a dog"]))
    out = tmp_path / "fid"
    result = run_fid.main(["--meta_data", str(meta), "--gt_dir", stats,
                           "--train_folder", write_wm_folder(tmp_path),
                           "--output_dir", str(out), "--num_images", "2",
                           "--batch_size", "2", "--tiny",
                           "--inception_torch_weights", weights,
                           "--device", "cpu"])
    assert "FID:" in capsys.readouterr().out
    assert result["random_inception"] is False

    jex = jfid.InceptionExtractor(
        params=jax.tree_util.tree_map(np.asarray, variables))
    feats = jex(jfid._load_images(str(out / "images")), 2)
    assert feats.shape == (2, 2048)
    ref = frechet_two_images(feats.astype(np.float64), mu2, sigma2)
    assert ref > 1.0
    np.testing.assert_allclose(result["fid"], ref, rtol=1e-3)
