"""The JPEG kinds the port's decoder reads beyond Pillow's writer, against
the JAX native loader (libjpeg-turbo 2.1, `native_loader.decode_batch`)
on the CPU: arithmetic coding (sequential SOF9 and progressive SOF10, with
restart intervals, with DAC conditioning values other than the defaults
and with no DAC), progressive scans that leave coefficients unfinished,
which libjpeg smooths (jdcoefct.c), a DC scan alone, and files cut short.

Each small file of tests/torch_port_images/ that libjpeg's own encoder
wrote or that was cut (`make_fixtures.libjpeg_kinds`) is held three ways:
`decode_batch` bit for bit the native loader's at the file's size (the
identity) and downscaled; `decode_file` against Pillow, bit for bit where
the two libraries agree, raising where PIL refuses a file cut short, and
within the difference stated below where Pillow's libjpeg-turbo 3 smooths
otherwise; and the plain version (`decode_from_coefficients` after
`smooth_coefficients`) bit for bit the C++ decoder.  Then folders of these
kinds through the port's and JAX's datasets."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from aqualora_torch.eval.jpeg import decode_from_coefficients
from aqualora_torch.train import data as tdata
from aqualora_torch.train import image_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_port_images")
SMALL = os.path.join(FIXTURES, "small")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
KINDS = sorted(n for n, m in MANIFEST["small"].items()
               if m.get("pixels") == "native_loader")
ARITHMETIC = [n for n in KINDS if n.startswith("arith")]
TRUNCATED = [n for n in KINDS
             if MANIFEST["small"][n].get("pillow") == "raises"]
# Pillow 12.1's libjpeg-turbo 3.1.3 against the native loader's 2.1.5 on
# the files whose unfinished coefficients libjpeg smooths: (largest
# difference, values that differ).  2.1.5 picks a block's 5 x 5 window of
# DC values by its block row within its iMCU row; 3.1 otherwise (ROADMAP,
# "Not port faults").  The port gives 2.1.5's pixels.
PILLOW_SMOOTHING = {"unfinished.jpg": (1, 64), "arith_unfinished.jpg": (1, 64),
                    "dc_only.jpg": (3, 1524)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(name: str) -> str:
    return os.path.join(SMALL, name)


def _pixels(name: str) -> np.ndarray:
    return np.load(os.path.join(FIXTURES, "pixels.npz"))[name.split(".")[0]]


def _markers(data: bytes) -> list:
    """The marker codes before the first scan's data."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        out.append(data[pos + 1])
        if data[pos + 1] == 0xDA:
            break
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return out


def test_the_kinds_are_what_they_say():
    """The fixtures hold what their names say: SOF9 or SOF10, a DAC whose
    L, U and K are (2, 5, 20) or no DAC at all, restart intervals, an end
    before EOI; the header reports arithmetic coding."""
    assert len(KINDS) == 13 and len(ARITHMETIC) == 8 and len(TRUNCATED) == 3
    for name in KINDS:
        data = open(_path(name), "rb").read()
        marks = _markers(data)
        head = image_decode.jpeg_header(data)
        sof = {0xC0, 0xC1, 0xC2, 0xC9, 0xCA} & set(marks)
        assert head.arithmetic == (sof <= {0xC9, 0xCA}), name
        assert head.progressive == bool(sof & {0xC2, 0xCA}), name
        assert (name in TRUNCATED) != data.endswith(b"\xff\xd9"), name
    dac = open(_path("arith_dac.jpg"), "rb").read()
    at = dac.index(b"\xff\xcc") + 4
    assert dac[at:at + 4] == bytes([0x00, 2 | 5 << 4, 0x10, 20])
    for name in ("arith_no_dac.jpg", "arith_progressive_restart.jpg"):
        data = open(_path(name), "rb").read()
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
        assert (b"\xff\xcc" in data) == (name != "arith_no_dac.jpg")
    assert image_decode.jpeg_header(
        open(_path("arith_grey.jpg"), "rb").read()).color == "grey"


@pytest.mark.parametrize("name", KINDS)
def test_decode_batch_matches_the_native_loader(name):
    """The port's batch equals the JAX native loader's bit for bit, at the
    file's size (where the resize is the identity, so these are the
    committed pixels) and downscaled."""
    from aqualora_tpu.core import native_loader
    path = _path(name)
    size = _pixels(name).shape[0]
    for res in (size, 16):
        want = native_loader.decode_batch([path], res)
        assert want is not None, name
        got = image_decode.decode_batch([path], res)
        np.testing.assert_array_equal(got, want)
    got = np.round((image_decode.decode_batch([path], size)[0] + 1) * 127.5)
    np.testing.assert_array_equal(got.astype(np.uint8), _pixels(name))


@pytest.mark.parametrize("name", KINDS)
def test_decode_file_against_pillow(name):
    """Pillow decodes the arithmetic files bit for bit as the port does;
    it refuses a file cut short, and so does the port on PIL's rule
    (`pil=True`, naming the file) while the native rule decodes it with
    libjpeg's warnings; where libjpeg smooths unfinished coefficients,
    Pillow's libjpeg-turbo 3 differs by at most PILLOW_SMOOTHING's levels
    in its count of values."""
    path = _path(name)
    warned = []
    got = image_decode.decode_jpeg(open(path, "rb").read(), path, warned)
    np.testing.assert_array_equal(got, image_decode.decode_file(path))
    if name in TRUNCATED:
        assert image_decode.TRUNCATED in warned, warned
        with pytest.raises(OSError):
            with Image.open(path) as im:
                im.convert("RGB")
        with pytest.raises(ValueError, match="truncated") as e:
            image_decode.decode_file(path, pil=True)
        assert str(e.value).startswith(path)
        return
    assert warned == [], warned
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB")).astype(np.int64)
    np.testing.assert_array_equal(image_decode.decode_file(path, pil=True),
                                  got)
    diff = np.abs(pil - got)
    most, count = PILLOW_SMOOTHING.get(name, (0, 0))
    assert (int(diff.max()), int((diff > 0).sum())) == (most, count), name


@pytest.mark.parametrize("name", KINDS)
def test_plain_version_matches_the_decoder(name):
    """`decode_from_coefficients`, fed the decoder's coefficients and its
    progression, gives the decoder's pixels: smoothing where libjpeg
    smooths and nowhere else, the garbage a cut arithmetic file decodes to
    through the IDCT's 16-bit lanes."""
    data = open(_path(name), "rb").read()
    head, quant, blocks, progress = image_decode.jpeg_coefficients(data)
    smoothed = name in PILLOW_SMOOTHING or name == "truncated_progressive.jpg"
    assert progress.smooth == smoothed, name
    got = decode_from_coefficients(blocks, quant,
                                   [c[:2] for c in head.components],
                                   (head.width, head.height), head.color,
                                   progress)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), image_decode.decode_jpeg(data))
    if smoothed:                        # and the smoothing moved pixels
        plain = decode_from_coefficients(blocks, quant,
                                         [c[:2] for c in head.components],
                                         (head.width, head.height),
                                         head.color)
        assert not np.array_equal(plain.numpy(), got.numpy())


def test_progression_of_a_cut_progressive_file():
    """A progressive file cut inside a scan: the coefficients its scans
    reached, the rows after the cut taking the precision from before the
    scan, as libjpeg's coef_bits and last_good_iMCU_row give them."""
    data = open(_path("truncated_progressive.jpg"), "rb").read()
    head, _, blocks, progress = image_decode.jpeg_coefficients(data)
    assert progress.warnings[:2] == (image_decode.TRUNCATED,
                                     "premature end of data segment")
    rows = blocks[0].shape[0] // head.components[0][1]      # iMCU rows
    assert progress.last_row < rows - 1
    assert (progress.coef_bits[:, 0] >= 0).all()
    assert (progress.coef_bits[:, 1:10] != 0).any()


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

def _folder(root, names):
    with open(root / "metadata.jsonl", "w") as f:
        for i, name in enumerate(names):
            shutil.copy(_path(name), root / name)
            f.write(json.dumps({"file_name": name, "text": f"c{i}"}) + "\n")
    return str(root)


def _stream(ds, n, **kw):
    it = ds.batches(**kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("random_flip", [False, True])
def test_folder_of_the_kinds_matches_jax(tmp_path, random_flip):
    """Every new kind, the cut ones too, through the native rule (no
    crop): the port's batches equal JAX's dataset's bit for bit, captions
    and flips included."""
    from aqualora_tpu.train import data as jdata
    root = _folder(tmp_path, KINDS)
    port = tdata.ImageFolderDataset(root, resolution=24,
                                    random_flip=random_flip)
    jax_ds = jdata.ImageFolderDataset(root, resolution=24,
                                      random_flip=random_flip)
    for (gi, gc), (wi, wc) in zip(_stream(port, 6, batch_size=4, seed=2),
                                  _stream(jax_ds, 6, batch_size=4, seed=2)):
        assert gc == wc
        np.testing.assert_array_equal(gi, wi)


def test_center_crop_takes_pils_rule(tmp_path):
    """Under `--center_crop` (PIL's rule): batches of arithmetic files
    equal JAX's (PIL's decode) bit for bit, and a smoothed file's differ
    by at most the levels Pillow's smoothing differs by; a batch that holds
    a file cut short raises, in the port a `ValueError` naming the file,
    in JAX PIL's `OSError`."""
    from aqualora_tpu.train import data as jdata
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    for names, limit in ((ARITHMETIC[:4], 0), (list(PILLOW_SMOOTHING), 3)):
        root = _folder(tmp_path / ("a" if limit == 0 else "b"), names)
        kw = dict(resolution=24, center_crop=True, random_flip=True)
        got = next(tdata.ImageFolderDataset(root, **kw).batches(
            len(names), seed=4))
        want = next(jdata.ImageFolderDataset(root, **kw).batches(
            len(names), seed=4))
        assert got[1] == want[1]
        diff = np.abs(got[0] - want[0]) * 127.5
        assert diff.max() <= limit + 1e-3, diff.max()
        assert (diff.max() > 0) == (limit > 0)
    root = _folder(tmp_path / "c", ["arith420.jpg", "truncated_baseline.jpg"])
    kw = dict(resolution=24, center_crop=True)
    with pytest.raises(ValueError, match="truncated_baseline.jpg: image "
                                         "file is truncated"):
        next(tdata.ImageFolderDataset(root, **kw).batches(2))
    with pytest.raises(OSError):
        next(jdata.ImageFolderDataset(root, **kw).batches(2))
    # the native rule reads the same folder, as the JAX loader does
    images, _ = next(tdata.ImageFolderDataset(root, 24).batches(2))
    assert np.isfinite(images).all()
