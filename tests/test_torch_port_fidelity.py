"""The port's FID pieces (`aqualora_torch/models/inception.py`,
`eval/fid.py`, the Inception reader of `tools/torch_import.py`,
`core/io.load_torch_pickle`) and the PNG unfilter in host C++, on the CPU.

- InceptionV3 at full width (its widths are fixed), B2 at 299^2 after the
  resize, against the JAX package's with the same weights carried over by
  `jax_params_to_torch`: the pool3 features within 1e-4 * max|f| + 1e-5.
  Also `_resize299`, the streamed and mixed-size paths and the zero-padded
  tail, through `InceptionExtractor` on both sides.
- `frechet_distance` and `activation_statistics` against JAX's: the
  identity, a known value, random statistics and the eps retry.
- The folder reader (the port's decoders, no PIL) against JAX's (PIL),
  `--save-stats`, the .npz path and the weight guard of `fid.main`.
- The reader of the published layout: a torchvision inception_v3 state
  dict with `fc`, `AuxLogits` and the BatchNorm counters, saved to disk,
  read by both packages' readers into both models.
- `png_unfilter.cpp` against the Python rows it replaces, byte for byte.

The JAX side runs jitted on the CPU, one compile of the model shared
through a module fixture.
"""

import argparse
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.eval import fid as tfid
from aqualora_torch.eval import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(REPO, "tests", "torch_port_images", "small")
B = 2                                   # every extractor call's batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def feature_tol(ref: np.ndarray) -> float:
    """float32 features through about 95 convolutions summed in other
    orders on both sides."""
    return 1e-4 * float(np.abs(ref).max()) + 1e-5


def _inception_vars(seed: int = 0):
    """Seeded JAX InceptionV3 variables without flax's init (a shape tree
    filled from numpy): He-scaled kernels, BatchNorm scale 1 + N(0, 0.1^2),
    bias N(0, 0.1^2), mean N(0, 0.1^2), variance U(0.5, 1.5)."""
    from aqualora_tpu.models.inception import InceptionV3Features
    shapes = jax.eval_shape(InceptionV3Features().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def inc():
    """The JAX variables, the port's state dict of the same weights, and
    an extractor on each side (the JAX one jitted once, at B2)."""
    from aqualora_tpu.eval import fid as jfid
    variables = _inception_vars()
    state = jax_params_to_torch(variables["params"], variables["batch_stats"])
    return {"vars": variables, "state": state,
            "jax": jfid.InceptionExtractor(params=variables),
            "torch": tfid.InceptionExtractor(params=state, device="cpu")}


def _images(seed, n, h=64, w=64):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# InceptionV3 and the extractor
# ---------------------------------------------------------------------------

def test_inception_features_match_jax(inc):
    imgs = _images(0, B)
    ref = inc["jax"](imgs, batch_size=B)
    got = inc["torch"](imgs, batch_size=B)
    assert got.shape == (B, 2048) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= feature_tol(ref)
    assert np.abs(ref).max() > 1.0          # features of scale, not zeros


def test_extractor_streams_mixed_sizes_and_pads_the_tail(inc):
    """Three images at B2: a full chunk and a tail zero-padded to B2; the
    streamed path equals the array path; a chunk of mixed sizes is resized
    image by image; each against JAX's extractor.  The inputs include views
    with negative strides, which torch cannot wrap as they are."""
    imgs = _images(1, 3)[::-1]
    f_arr = inc["torch"](imgs, batch_size=B)
    np.testing.assert_array_equal(f_arr,
                                  inc["torch"](iter(imgs), batch_size=B))
    ref = inc["jax"](imgs, batch_size=B)
    assert f_arr.shape == (3, 2048)
    assert np.abs(f_arr - ref).max() <= feature_tol(ref)
    chunks = list(tfid._padded_batches(imgs, B))
    assert [n for _, n in chunks] == [2, 1]
    assert chunks[1][0].shape == (B, 64, 64, 3)
    assert not chunks[1][0][1].any()         # the padding rows are zeros
    rng = np.random.default_rng(2)
    mixed = [rng.random((64, 64, 3)).astype(np.float32),
             rng.random((48, 40, 3)).astype(np.float32)[:, ::-1],
             rng.random((299, 299, 3)).astype(np.float32)]
    got = inc["torch"](iter(mixed), batch_size=B)
    ref = inc["jax"](iter(mixed), batch_size=B)
    assert np.abs(got - ref).max() <= feature_tol(ref)
    assert inc["torch"](iter([]), batch_size=B).shape == (0, 2048)


@pytest.mark.parametrize("size", [(64, 64), (512, 512), (48, 40),
                                  (299, 299)])
def test_resize299_matches_jax(size):
    """Bilinear without antialias, as pytorch_fid's F.interpolate."""
    from aqualora_tpu.eval import fid as jfid
    x = _images(3, 2, *size)
    ref = np.asarray(jfid._resize299(jnp.asarray(x)))
    got = tfid._resize299(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    one = tfid._resize299(torch.from_numpy(x[0])).numpy()   # [H, W, 3]
    np.testing.assert_array_equal(one, got[0])


# ---------------------------------------------------------------------------
# the statistics and the Frechet distance
# ---------------------------------------------------------------------------

def test_frechet_distance_matches_jax():
    from aqualora_tpu.eval import fid as jfid
    rng = np.random.default_rng(4)
    f = rng.standard_normal((64, 16))
    mu, sigma = tfid.activation_statistics(f)
    jmu, jsigma = jfid.activation_statistics(f)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sigma, jsigma)
    assert abs(tfid.frechet_distance(mu, sigma, mu, sigma)) < 1e-6
    d = 8                                    # N(0, I) vs N(2, I): 4 d
    np.testing.assert_allclose(tfid.frechet_distance(
        np.zeros(d), np.eye(d), np.full(d, 2.0), np.eye(d)), 4.0 * d,
        rtol=1e-6)
    for n in (3, 40):                        # low-rank and full-rank
        a = tfid.activation_statistics(rng.standard_normal((n, 32)))
        b = tfid.activation_statistics(rng.standard_normal((n, 32)) + 0.3)
        got, ref = tfid.frechet_distance(*a, *b), jfid.frechet_distance(*a, *b)
        assert got > 0
        np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_frechet_distance_eps_retry_matches_jax():
    """s1 @ s2 nilpotent: it has no square root, scipy's is not finite, and
    the distance retries with eps on both diagonals, as JAX's does."""
    from aqualora_tpu.eval import fid as jfid
    s1, s2 = np.array([[1.0, 0.0], [0.0, 0.0]]), np.array([[0.0, 1.0],
                                                           [0.0, 0.0]])
    assert not np.isfinite(tfid._sqrtm(s1 @ s2)).all()
    mu1, mu2 = np.array([0.5, 0.0]), np.array([0.0, 1.0])
    got = tfid.frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, jfid.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# folders, the .npz path and the CLI
# ---------------------------------------------------------------------------

def _folder(tmp_path):
    """PNG and JPEG fixtures of every kind both readers take (grey, grey +
    alpha, palette, 16-bit, Adam7, RGBA; baseline, progressive and
    subsampled JPEG; mixed sizes), under names whose sort order differs
    from their creation order."""
    folder = tmp_path / "imgs"
    folder.mkdir()
    names = ["rgba.png", "grey16.png", "palette_trns.png", "grey_alpha.png",
             "rgb_adam7.png", "grey_2bit.png", "sub420.jpg", "progressive.jpg",
             "grey.jpg", "odd_17x9.jpg"]
    for i, n in enumerate(names):
        ext = ".jpeg" if i == 9 else os.path.splitext(n)[1]
        shutil.copy(os.path.join(SMALL, n), folder / f"{9 - i}_{n[:-4]}{ext}")
    (folder / "notes.txt").write_text("not an image")
    return str(folder)


def test_load_images_match_jax(tmp_path):
    """The port decodes a folder (sorted *.png, *.jpg, *.jpeg; --limit cuts
    that order) to the bytes PIL's convert("RGB") gives the JAX reader."""
    pytest.importorskip("PIL")
    from aqualora_tpu.eval import fid as jfid
    folder = _folder(tmp_path)
    got = list(tfid._load_images(folder))
    ref = list(jfid._load_images(folder))
    assert len(got) == len(ref) == 10
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    first3 = list(tfid._load_images(folder, limit=3))
    assert len(first3) == 3
    for a, b in zip(first3, ref):
        np.testing.assert_array_equal(a, b)


def test_save_stats_and_npz_paths_match_jax(inc, tmp_path, capsys):
    """`fid.main --save-stats` writes the folder's mu and sigma (against
    JAX's statistics of the same folder); `fid_given_paths` reads .npz
    statistics on either side; no weights is an error."""
    from aqualora_tpu.eval import fid as jfid
    folder = _folder(tmp_path)
    weights = str(tmp_path / "pt_inception.pth")
    torch.save(inc["state"], weights)
    out = str(tmp_path / "stats.npz")
    mu, sigma = tfid.main([folder, out, "--save-stats", "--batch-size",
                           str(B), "--limit", "4", "--torch-weights",
                           weights, "--device", "cpu"])
    assert "saved stats for 4 images" in capsys.readouterr().out
    ref = jfid.activation_statistics(
        inc["jax"](jfid._load_images(folder, 4), batch_size=B))
    with np.load(out) as f:
        np.testing.assert_array_equal(f["mu"], mu)
    assert np.abs(mu - ref[0]).max() <= feature_tol(ref[0])
    assert np.abs(sigma - ref[1]).max() <= 1e-4 * np.abs(ref[1]).max()
    # .npz on both sides at a small width: only the distance is computed
    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        a = rng.standard_normal((20, 12)) + i
        paths.append(str(tmp_path / f"s{i}.npz"))
        np.savez(paths[-1], mu=a.mean(0), sigma=np.cov(a, rowvar=False))
    got = tfid.fid_given_paths(*paths, extractor=inc["torch"])
    np.testing.assert_allclose(
        got, jfid.fid_given_paths(*paths, extractor=inc["jax"]), rtol=1e-9)
    with pytest.raises(SystemExit):
        tfid.main([folder, out, "--save-stats", "--device", "cpu"])
    assert "no Inception weights" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no images"):
        tfid.fid_given_paths(str(tmp_path), paths[0], extractor=inc["torch"])


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def test_inception_reader_matches_jax(inc, tmp_path):
    """A torchvision inception_v3 file (the FID weights' layout: the
    fc and AuxLogits heads and a num_batches_tracked per BatchNorm beside
    the features' tensors) read by both readers into both models."""
    from aqualora_tpu.eval import fid as jfid
    from aqualora_tpu.tools.torch_import import \
        inception_from_torch as j_reader

    from aqualora_torch.tools.torch_import import inception_from_torch
    rng = np.random.default_rng(6)
    state = {k: v.clone() for k, v in inc["state"].items()}
    for k in [k for k in state if k.endswith("running_var")]:
        state[k] = torch.from_numpy(
            rng.uniform(0.5, 1.5, state[k].shape).astype(np.float32))
        state[k[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(7)
    state["fc.weight"] = torch.zeros(1008, 2048)
    state["fc.bias"] = torch.zeros(1008)
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    state["AuxLogits.conv0.bn.running_var"] = torch.ones(128)
    path = str(tmp_path / "pt_inception-2015-12-05.pth")
    torch.save(state, path)

    ported = inception_from_torch(path)
    assert set(ported) == {k for k in inc["state"]
                           if not k.endswith("num_batches_tracked")}
    ex = tfid.InceptionExtractor(params=ported, device="cpu")
    jex = jfid.InceptionExtractor(params=j_reader(path))
    jex._fn = inc["jax"]._fn                 # the compiled function, shared
    imgs = _images(7, B)
    ref = jex(imgs, batch_size=B)
    got = ex(imgs, batch_size=B)
    assert np.abs(got - ref).max() <= feature_tol(ref)
    assert np.abs(got - inc["torch"](imgs, batch_size=B)).max() > 1e-3
    with pytest.raises(KeyError, match="unrecognized inception key"):
        inception_from_torch({**state, "Mixed_5b.extra.weight":
                              torch.zeros(1)})


def test_load_torch_pickle_allows_only_a_namespace(tmp_path):
    """A DINO training checkpoint's `args` (argparse.Namespace) is read on
    the retry; tensors stay torch tensors; a module gives its state dict."""
    from aqualora_torch.core.io import load_torch_pickle
    path = str(tmp_path / "ckpt.pth")
    torch.save({"student": {"backbone.cls_token": torch.ones(1, 1, 4)},
                "args": argparse.Namespace(arch="vit_base")}, path)
    got = load_torch_pickle(path)
    assert got["args"].arch == "vit_base"
    assert isinstance(got["student"]["backbone.cls_token"], torch.Tensor)
    lin = torch.nn.Linear(2, 3)
    torch.save(lin, str(tmp_path / "module.pt"))
    with pytest.raises(Exception):           # a pickled module is refused
        load_torch_pickle(str(tmp_path / "module.pt"))


# ---------------------------------------------------------------------------
# PNG's row filters in host C++
# ---------------------------------------------------------------------------

def _recorded_unfilter_calls(monkeypatch, paths):
    """The arguments of every `_unfilter` call while `load_png` reads
    `paths`."""
    calls, real = [], image_io._unfilter

    def spy(raw, h, stride, bpp):
        calls.append((bytes(raw), h, stride, bpp))
        return real(raw, h, stride, bpp)
    monkeypatch.setattr(image_io, "_unfilter", spy)
    for p in paths:
        image_io.load_png(p)
    return calls


def test_png_unfilter_matches_the_python_rows(monkeypatch):
    """The C++ unfilter gives the Python rows' bytes on every pass of every
    PNG fixture, and on 1024x768 images of Paeth, Average and mixed rows
    at 1, 3 and 4 bytes a pixel."""
    pngs = sorted(glob.glob(os.path.join(SMALL, "*.png")))
    calls = _recorded_unfilter_calls(monkeypatch, pngs)
    monkeypatch.undo()
    assert len(pngs) >= 13 and len(calls) >= len(pngs)
    for raw, h, stride, bpp in calls:
        np.testing.assert_array_equal(
            image_io._unfilter(raw, h, stride, bpp),
            image_io._unfilter_plain(raw, h, stride, bpp))
    rng = np.random.default_rng(8)
    h, w = 768, 1024
    for bpp, kinds in ((3, [4] * h), (4, [3] * h),
                       (1, list(rng.integers(0, 5, h)))):
        rows = rng.integers(0, 256, (h, bpp * w), dtype=np.uint8)
        raw = np.concatenate([np.array(kinds, np.uint8)[:, None], rows],
                             1).tobytes()
        np.testing.assert_array_equal(
            image_io._unfilter(raw, h, bpp * w, bpp),
            image_io._unfilter_plain(raw, h, bpp * w, bpp))
    bad = bytes([0, 1, 2, 5, 9, 9])
    for fn in (image_io._unfilter, image_io._unfilter_plain):
        with pytest.raises(ValueError, match="row 1 has filter type 5"):
            fn(bad, 2, 2, 1)
        with pytest.raises(ValueError, match="image data has"):
            fn(bad[:5], 2, 2, 1)
