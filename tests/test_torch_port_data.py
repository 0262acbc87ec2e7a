"""The port's training data path against Pillow and the JAX package, on the
CPU: the JPEG decoder written by hand (`csrc/jpeg_decode.cpp`, built with
g++) and its plain version (`eval/jpeg.decode_from_coefficients`), the PNG
reader, `ImageFolderDataset`, `make_dataset`, `prefetch`,
`CachedMomentsDataset`, PPFT's `--cache_latents` loss, and the three
trainers fed from a folder.

The fixtures under tests/torch_port_images/ come from its seeded
`make_fixtures.py`; the JPEG kinds are also written here with Pillow.
Decoded pixels are held to Pillow's and to the JAX native loader's
(libjpeg, libpng) bit for bit; the float32 resize to the native loader's
bit for bit too (the tolerance allowed, 1e-6, is not needed)."""

import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.eval.jpeg import decode_from_coefficients
from aqualora_torch.train import data as tdata
from aqualora_torch.train import image_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_port_images")
SMALL = os.path.join(FIXTURES, "small")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
DECODABLE = sorted(n for n, m in MANIFEST["small"].items()
                   if m["refused"] is None)
REFUSED = sorted(n for n, m in MANIFEST["small"].items() if m["refused"])
PNGS = sorted(n for n in DECODABLE if n.endswith(".png"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(h, w, seed):
    if FIXTURES not in sys.path:
        sys.path.insert(0, FIXTURES)
    from make_fixtures import smooth_image
    return smooth_image(h, w, seed)


def _pillow_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_pixels(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# the JPEG decoder
# ---------------------------------------------------------------------------

QTABLES = [[300 + 3 * i for i in range(64)], [260 + i for i in range(64)]]
JPEG_CASES = {
    "q50": ((48, 64), {"quality": 50}),
    "q75": ((48, 64), {"quality": 75}),
    "q95": ((48, 64), {"quality": 95}),
    "sub444": ((45, 61), {"quality": 85, "subsampling": 0}),
    "sub422": ((45, 61), {"quality": 85, "subsampling": 1}),
    "sub420": ((45, 61), {"quality": 85, "subsampling": 2}),
    "progressive": ((70, 90), {"quality": 80, "progressive": True}),
    "progressive444": ((33, 41), {"quality": 80, "progressive": True,
                                  "subsampling": 0}),
    "optimize": ((40, 56), {"quality": 80, "optimize": True}),
    "restart_blocks": ((40, 56), {"quality": 80, "restart_marker_blocks": 2}),
    "restart_rows": ((40, 56), {"quality": 80, "restart_marker_rows": 1}),
    "restart_progressive": ((40, 56), {"quality": 80, "progressive": True,
                                       "restart_marker_blocks": 3}),
    "grey": ((37, 53), {"quality": 85, "grey": True}),
    "grey_progressive": ((37, 53), {"quality": 85, "grey": True,
                                    "progressive": True}),
    "qtables_sof1": ((40, 56), {"qtables": QTABLES}),
    "odd_37x53": ((37, 53), {"quality": 90}),
    "odd_17x9": ((17, 9), {"quality": 90}),
    "odd_1x1": ((1, 1), {"quality": 90}),
    "odd_9x2_422": ((9, 2), {"quality": 90, "subsampling": 1}),
    "odd_3x33_progressive": ((3, 33), {"quality": 90, "progressive": True}),
}


def _jpeg_case(name: str) -> bytes:
    (h, w), kw = JPEG_CASES[name]
    kw = dict(kw)
    img = _smooth(h, w, sum(map(ord, name)))
    if kw.pop("grey", False):
        img = img[..., 1]
    return _pillow_jpeg(img, **kw)


@pytest.mark.parametrize("name", sorted(JPEG_CASES))
def test_jpeg_decoder_matches_pillow(name):
    """Every kind Pillow writes, bit for bit Pillow's decode (libjpeg-
    turbo): qualities, the three samplings, progressive with its refine
    scans, optimised tables, restart intervals, grey, 16-bit tables
    (SOF1), and sizes that end mid-block and mid-MCU."""
    data = _jpeg_case(name)
    if name == "qtables_sof1":        # Pillow writes SOF1 and 16-bit DQT
        assert b"\xff\xc1" in data and b"\xff\xdb\x00\x83\x10" in data
    if "progressive" in name:
        assert b"\xff\xc2" in data
    if "restart" in name:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got = image_decode.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pillow_pixels(data))


@pytest.mark.parametrize("name", DECODABLE)
def test_fixture_matches_committed_pixels(name):
    """The committed fixtures (4:4:0 too, which Pillow cannot write, the
    files libjpeg's own encoder writes, the ones cut short, and every PNG
    kind) decode to the committed pixels: Pillow's, which Pillow still
    gives for every file but 16-bit grey PNG (libpng's high byte; PIL
    clips, the rule of `pil=True`); or the JAX native loader's, which
    Pillow gives too but for a file cut short, which PIL refuses and so
    does `pil=True`, and for unfinished progressive coefficients, which
    Pillow's libjpeg-turbo smooths otherwise
    (tests/test_torch_port_jpeg_kinds.py holds those)."""
    path = os.path.join(SMALL, name)
    meta = MANIFEST["small"][name]
    want = np.load(os.path.join(FIXTURES, "pixels.npz"))[name.split(".")[0]]
    got = image_decode.decode_file(path)
    np.testing.assert_array_equal(got, want)
    if meta.get("pillow") == "raises":
        with pytest.raises(OSError):     # truncated, or a broken stream
            with Image.open(path) as im:
                im.convert("RGB")
        with pytest.raises(ValueError, match="truncated") as e:
            image_decode.decode_file(path, pil=True)
        assert str(e.value).startswith(path)
        return
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image_decode.decode_file(path, pil=True),
                                  got if meta.get("pillow") else pil)
    if name != "grey16.png" and not meta.get("pillow"):
        np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("name", sorted(JPEG_CASES) + ["sub440", "cmyk",
                                                        "ycck"])
def test_plain_version_matches_the_decoder(name):
    """`decode_from_coefficients` fed the decoder's coefficients gives the
    decoder's pixels: every sampling (h2v1, h1v2, h2v2, none), grey, CMYK
    and YCCK, any tables, blocks past the image's edge."""
    data = (open(os.path.join(SMALL, name + ".jpg"), "rb").read()
            if name in ("sub440", "cmyk", "ycck") else _jpeg_case(name))
    head, quant, blocks, progress = image_decode.jpeg_coefficients(data)
    if name == "sub440":
        assert [c[:2] for c in head.components] == [(1, 2), (1, 1), (1, 1)]
    assert not progress.smooth
    got = decode_from_coefficients(blocks, quant,
                                   [c[:2] for c in head.components],
                                   (head.width, head.height), head.color,
                                   progress)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), image_decode.decode_jpeg(data))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_kinds_name_the_feature_and_the_file(name):
    """Lossless (SOF3, SOF11), hierarchical and 12-bit files, which the JAX
    native loader's libjpeg refuses too, raise `ValueError` with the path
    and the feature, alone and in a batch."""
    path = os.path.join(SMALL, name)
    feature = MANIFEST["small"][name]["refused"]
    with pytest.raises(ValueError, match=feature) as e:
        image_decode.decode_file(path)
    assert str(e.value).startswith(path)
    with pytest.raises(ValueError, match=feature):
        image_decode.decode_batch([path], 8)


@pytest.mark.parametrize("name,color,sampling", [
    ("cmyk.jpg", "cmyk", [(1, 1)] * 4),
    ("ycck.jpg", "ycck", [(2, 2), (1, 1), (1, 1), (1, 1)])])
def test_four_component_jpeg_is_pils_rgb(name, color, sampling):
    """Adobe CMYK (transform 0) and YCCK (transform 2, Y and K at 2x2)
    decode bit for bit to PIL's `convert("RGB")` (libjpeg's YCCK -> CMYK,
    Pillow's inverted CMYK and its cmyk2rgb), alone and through the native
    rule's batch; the JAX native loader refuses both (its libjpeg gives no
    RGB for them), which sends the JAX dataset's batch to PIL, and
    `needs_pil_rule` says so of them alone."""
    from aqualora_tpu.core import native_loader
    path = os.path.join(SMALL, name)
    data = open(path, "rb").read()
    head = image_decode.jpeg_header(data)
    assert head.color == color
    assert [c[:2] for c in head.components] == sampling
    with Image.open(path) as im:
        assert im.mode == "CMYK"
        assert im.info["adobe_transform"] == (0 if color == "cmyk" else 2)
        want = np.asarray(im.convert("RGB"))
    got = image_decode.decode_file(path)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 50
    batch = image_decode.decode_batch([path], got.shape[0])
    assert batch.shape == (1, got.shape[0], got.shape[0], 3)
    assert native_loader.decode_batch([path], 8) is None
    assert image_decode.needs_pil_rule(path)
    assert not image_decode.needs_pil_rule(os.path.join(SMALL, "sub420.jpg"))
    assert not image_decode.needs_pil_rule(os.path.join(SMALL, "rgba.png"))


# ---------------------------------------------------------------------------
# corrupt input, in a subprocess: a crash fails the tests, not the worker
# ---------------------------------------------------------------------------

CORRUPT_KINDS = ["baseline_q75.jpg", "sub444.jpg", "sub422.jpg", "sub440.jpg",
                 "progressive.jpg", "progressive444.jpg",
                 "restart_blocks.jpg", "restart_progressive.jpg", "grey.jpg",
                 "sof1_qtables.jpg", "palette_trns.png", "rgb_adam7.png",
                 "arithmetic.jpg", "arith420.jpg", "arith444.jpg",
                 "arith_grey.jpg", "arith_progressive_restart.jpg",
                 "arith_dac.jpg", "arith_no_dac.jpg", "arith_unfinished.jpg",
                 "unfinished.jpg", "dc_only.jpg"]
CORRUPT_RES = 48
_CORRUPT = textwrap.dedent("""
    import os, sys
    import numpy as np
    from aqualora_torch.train import image_decode
    folder, out = sys.argv[1], sys.argv[2]
    got = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        outcome = "decoded"
        try:
            image_decode.decode_file(path)
            got[name] = image_decode.decode_batch([path], %d, nthreads=2)
        except ValueError:
            outcome = "raised"
        print(name, outcome, flush=True)
    np.savez(out, **got)
""" % CORRUPT_RES)


@pytest.fixture(scope="module")
def corrupt_run(tmp_path_factory):
    """Seeded truncations (cut anywhere past SOI) and 1-3 changed bytes of
    each kind, 5 cases a kind, decoded by the port in a subprocess (a crash
    fails the tests, not the worker) and by the JAX native loader here."""
    folder = tmp_path_factory.mktemp("corrupt")
    rng = np.random.default_rng(13)
    for kind in CORRUPT_KINDS:
        blob = open(os.path.join(SMALL, kind), "rb").read()
        for case in range(5):
            b = bytearray(blob)
            if case < 2:                       # cut anywhere past SOI
                b = b[:int(rng.integers(3, len(b)))]
            else:                              # 1-3 bytes changed
                for _ in range(case - 1):
                    b[int(rng.integers(2, len(b)))] = int(rng.integers(256))
            (folder / f"{kind}.{case}").write_bytes(bytes(b))
    out = str(folder / "port.npz")
    proc = subprocess.run(
        [sys.executable, "-c", _CORRUPT, str(folder), out], cwd=REPO,
        capture_output=True, text=True, timeout=240)
    port = dict(np.load(out)) if proc.returncode == 0 else {}
    return proc, port, str(folder)


@pytest.mark.parametrize("kind", CORRUPT_KINDS)
def test_corrupt_input_raises_or_decodes(corrupt_run, kind):
    """Seeded truncations and byte changes of each kind (110 cases): none
    ends the process (the decoder bounds-checks every read); each JPEG case
    decodes where the JAX native loader's libjpeg decodes it (a file cut
    anywhere after its first scan, a bad Huffman or arithmetic code, bytes
    before a marker, a lost restart marker), bit for bit its batch, and
    raises where it fails; a PNG case decodes or raises, every truncation
    raising as libpng does."""
    from aqualora_tpu.core import native_loader
    proc, port, folder = corrupt_run
    lines = [ln.split() for ln in proc.stdout.splitlines()]
    mine = {ln[0]: ln[1] for ln in lines if ln[0].rsplit(".", 1)[0] == kind}
    assert len(mine) == 5, (proc.returncode, proc.stderr[-3000:])
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name, outcome in sorted(mine.items()):
        case = int(name.rsplit(".", 1)[1])
        want = native_loader.decode_batch([os.path.join(folder, name)],
                                          CORRUPT_RES)
        if kind.endswith(".png"):
            if case < 2:
                assert outcome == "raised" and want is None, name
            continue
        assert (outcome == "decoded") == (want is not None), (name, outcome)
        if want is not None:
            np.testing.assert_array_equal(port[name], want, err_msg=name)


# ---------------------------------------------------------------------------
# PNG against the JAX native loader (libpng)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PNGS)
def test_png_matches_the_native_loader(name):
    """Palettes (tRNS), grey at 1, 2, 4 and 16 bits, 16-bit RGB, grey +
    alpha, RGBA, Adam7: the port's batch (load_png, then the loader's
    float32 bicubic in C++) equals the JAX native loader's at the file's
    size (the identity) and downscaled, bit for bit."""
    from aqualora_tpu.core import native_loader
    path = os.path.join(SMALL, name)
    for res in (17, 8):
        want = native_loader.decode_batch([path], res)
        assert want is not None
        np.testing.assert_array_equal(image_decode.decode_batch([path], res),
                                      want)


# ---------------------------------------------------------------------------
# ImageFolderDataset against JAX's
# ---------------------------------------------------------------------------

FOLDER_FILES = ["baseline_q75.jpg", "sub444.jpg", "sub440.jpg",
                "progressive.jpg", "grey.jpg", "odd_17x9.jpg",
                "restart_rows.jpg", "palette_trns.png", "grey16.png",
                "rgb_adam7.png", "sof1_qtables.jpg"]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A folder with metadata.jsonl (one row without a caption) and one to
    scan (mixed-case extensions, a file that is not an image)."""
    meta = tmp_path_factory.mktemp("meta")
    with open(meta / "metadata.jsonl", "w") as f:
        for i, name in enumerate(FOLDER_FILES):
            shutil.copy(os.path.join(SMALL, name), meta / name)
            row = {"file_name": name, "text": f"caption {i}",
                   "alt": f"alt {i}"}
            if i == 3:
                del row["text"]
            f.write(json.dumps(row) + "\n")
    scan = tmp_path_factory.mktemp("scan")
    for i, name in enumerate(FOLDER_FILES[:7]):
        stem, ext = os.path.splitext(name)
        shutil.copy(os.path.join(SMALL, name),
                    scan / (stem + (ext.upper() if i % 2 else ext)))
    (scan / "notes.txt").write_text("not an image")
    return {"meta": str(meta), "scan": str(scan)}


def _both(root, **kw):
    from aqualora_tpu.train import data as jdata
    return tdata.ImageFolderDataset(root, **kw), jdata.ImageFolderDataset(
        root, **kw)


def _stream(ds, n, **kw):
    it = ds.batches(**kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("layout,column", [("meta", "text"), ("meta", "alt"),
                                           ("scan", "text")])
def test_folder_order_and_captions_match_jax(folders, layout, column):
    """The same files, captions (a missing one ""), and three epochs'
    order and sharding (process 1 of 2 too) as JAX's dataset."""
    port, jax_ds = _both(folders[layout], resolution=8,
                         caption_column=column)
    assert port.files == jax_ds.files and port.captions == jax_ds.captions
    if layout == "scan":
        assert port.captions is None and len(port.files) == 7
    for pi, pc in ((0, 1), (1, 2)):
        per_epoch = len(range(pi, len(port), pc)) // 2
        got = _stream(port, 3 * per_epoch, batch_size=2, seed=5,
                      process_index=pi, process_count=pc)
        want = _stream(jax_ds, 3 * per_epoch, batch_size=2, seed=5,
                       process_index=pi, process_count=pc)
        for (gi, gc), (wi, wc) in zip(got, want):
            assert gc == wc
            np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("drop_last,max_samples", [(True, None),
                                                   (False, None),
                                                   (False, 7), (True, 5)])
def test_folder_drop_last_and_max_samples_match_jax(folders, drop_last,
                                                    max_samples):
    """`drop_last` both ways (the tail as a smaller batch) and
    `make_dataset(max_samples=...)` trimming files and captions, against
    the JAX factory; a shard smaller than a batch is refused."""
    from aqualora_tpu.train import data as jdata
    port = tdata.make_dataset(folders["meta"], 8, max_samples=max_samples)
    want = jdata.make_dataset(folders["meta"], 8, max_samples=max_samples)
    assert port.files == want.files and port.captions == want.captions
    assert len(port) == (max_samples or len(FOLDER_FILES))
    got = list(port.batches(3, seed=2, epochs=2, drop_last=drop_last))
    ref = list(want.batches(3, seed=2, epochs=2, drop_last=drop_last))
    assert [len(c) for _, c in got] == [len(c) for _, c in ref]
    for (gi, gc), (wi, wc) in zip(got, ref):
        assert gc == wc
        np.testing.assert_array_equal(gi, wi)
    with pytest.raises(ValueError, match="batch_size"):
        next(port.batches(len(port) + 1))


@pytest.mark.parametrize("center_crop,random_flip", [
    (False, False), (False, True), (True, False), (True, True)])
def test_folder_pixels_match_jax(folders, center_crop, random_flip):
    """Pixels bit for bit JAX's: without a crop its native loader's (float
    bicubic from the decoded pixels, one flip draw a batch), with a crop
    its PIL path (crop, PIL's bicubic to uint8, one flip draw an image;
    16-bit grey clipped as PIL clips it); the same flips from the same
    seed."""
    from aqualora_tpu.core import native_loader
    assert native_loader.get_lib() is not None
    port, jax_ds = _both(folders["meta"], resolution=16,
                         center_crop=center_crop, random_flip=random_flip)
    got = _stream(port, 6, batch_size=4, seed=1)
    want = _stream(jax_ds, 6, batch_size=4, seed=1)
    flipped = 0
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gi.dtype == np.float32 and gi.shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(gi, wi)
        flipped += int(np.any(gi != gi[:, :, ::-1]))
    assert flipped > 0


def test_a_batch_with_a_refused_file_raises(folders, tmp_path):
    """A file that neither package reads (lossless JPEG: the JAX loader's
    libjpeg refuses it and so does PIL) raises with the file's path."""
    shutil.copytree(folders["meta"], tmp_path / "f")
    shutil.copy(os.path.join(SMALL, "lossless.jpg"),
                tmp_path / "f" / "grey.jpg")
    port = tdata.ImageFolderDataset(str(tmp_path / "f"), resolution=8)
    with pytest.raises(ValueError, match="grey.jpg: refused: lossless"):
        list(port.batches(len(port), epochs=1))


@pytest.mark.parametrize("name", ["cmyk.jpg", "ycck.jpg"])
@pytest.mark.parametrize("random_flip", [False, True])
def test_a_batch_with_a_four_component_file_matches_jax(folders, tmp_path,
                                                        name, random_flip):
    """A folder whose `grey.jpg` is a CMYK or YCCK file, batches of 4:
    the batches that hold it take PIL's rule whole (decode, PIL's bicubic
    to uint8, no crop) and the others the native loader's, bit for bit as
    JAX's dataset gives them (its native loader returns None for the
    batch, which it then reads with PIL), the same flips from the same
    seed; so do two data ranks' slices of them."""
    shutil.copytree(folders["meta"], tmp_path / "f")
    shutil.copy(os.path.join(SMALL, name), tmp_path / "f" / "grey.jpg")
    port, jax_ds = _both(str(tmp_path / "f"), resolution=16,
                         random_flip=random_flip)
    got = _stream(port, 6, batch_size=4, seed=1)
    want = _stream(jax_ds, 6, batch_size=4, seed=1)
    pil_rule = 0
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gi, wi)
        # PIL's rule rounds to uint8: every value is k / 127.5 - 1
        pil_rule += bool(np.all(np.abs((gi + 1) * 127.5 - np.round(
            (gi + 1) * 127.5)) < 1e-4))
    assert 0 < pil_rule < len(got)
    its = f"caption {FOLDER_FILES.index('grey.jpg')}"
    for rank in range(2):
        part = _stream(port, 6, batch_size=4, seed=1, part=(rank, 2))
        for (pi, pc), (wi, wc) in zip(part, want):
            mine = slice(2 * rank, 2 * rank + 2)
            assert pc == wc[mine]
            if its in wc[mine] or its not in wc:
                np.testing.assert_array_equal(pi, wi[mine])


@pytest.mark.parametrize("case", ["dataset_name", "not_a_directory",
                                  "empty_folder", "synthetic"])
def test_make_dataset_refusals(tmp_path, case):
    """The HF path is refused naming the missing `datasets` package; a
    path that is not a directory and a folder without images raise
    `FileNotFoundError`; no path gives the synthetic dataset, with JAX's
    batches for the same arguments (sharded, tail kept)."""
    from aqualora_tpu.train import data as jdata
    if case == "dataset_name":
        with pytest.raises(NotImplementedError, match="datasets"):
            tdata.make_dataset(None, 8, dataset_name="lambdalabs/pokemon")
    elif case == "not_a_directory":
        with pytest.raises(FileNotFoundError, match="not a directory"):
            tdata.make_dataset(str(tmp_path / "missing"), 8)
    elif case == "empty_folder":
        (tmp_path / "notes.txt").write_text("x")
        with pytest.raises(FileNotFoundError, match="no images"):
            tdata.make_dataset(str(tmp_path), 8)
    else:
        got = tdata.SyntheticDataset(4, 7).batches(
            3, seed=2, process_index=1, process_count=2, epochs=2,
            drop_last=False)
        want = jdata.SyntheticDataset(4, 7).batches(
            3, seed=2, process_index=1, process_count=2, epochs=2,
            drop_last=False)
        for (gi, gc), (wi, wc) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gi, wi)
            assert gc == wc


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def _prefetch_threads(before=()):
    return [t for t in threading.enumerate()
            if t.name == "prefetch" and t not in before]


@pytest.mark.parametrize("case", ["order", "exception", "early_break"])
def test_prefetch(case):
    """Items in order; an exception in the iterator re-raised in the
    consumer; after an early break the iterator is closed and no thread
    is left."""
    closed = []
    before = set(threading.enumerate())

    def source(n, fail_at=None):
        try:
            for i in range(n):
                if i == fail_at:
                    raise KeyError(f"item {i}")
                yield i
        finally:
            closed.append(True)

    if case == "order":
        assert list(tdata.prefetch(source(50), depth=3)) == list(range(50))
    elif case == "exception":
        got = []
        with pytest.raises(KeyError, match="item 4"):
            for x in tdata.prefetch(source(10, fail_at=4)):
                got.append(x)
        assert got == [0, 1, 2, 3]
    else:
        it = tdata.prefetch(source(10 ** 6), depth=2)
        for x in it:
            if x == 3:
                break
        it.close()
        assert closed == [True]
    deadline = time.time() + 5
    while _prefetch_threads(before) and time.time() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads(before)


# ---------------------------------------------------------------------------
# CachedMomentsDataset and PPFT's --cache_latents
# ---------------------------------------------------------------------------

def _encode(x):
    """A numpy stand-in for the VAE's moments: [B, H, W, 3] -> [B, H/2,
    W/2, 6]."""
    return np.concatenate([x[:, ::2, ::2], 0.5 * x[:, 1::2, 1::2] - 1], -1)


@pytest.mark.parametrize("base", ["folder", "synthetic"])
def test_cached_moments_match_jax(folders, base):
    """`build` (the tail padded, every sample cached, float16) and two
    epochs of `batches` equal JAX's on the same encode function."""
    from aqualora_tpu.train import data as jdata
    if base == "folder":
        tbase, jbase = _both(folders["meta"], resolution=8, center_crop=True)
    else:
        tbase, jbase = tdata.SyntheticDataset(8, 7), jdata.SyntheticDataset(
            8, 7)
    got = tdata.CachedMomentsDataset.build(tbase, _encode, 4, seed=3)
    want = jdata.CachedMomentsDataset.build(jbase, _encode, 4, seed=3)
    assert got.moments.dtype == np.float16 and len(got) == len(tbase)
    np.testing.assert_array_equal(got.moments, want.moments)
    assert got.captions == want.captions
    for (gm, gc), (wm, wc) in zip(got.batches(3, seed=4, epochs=2),
                                  want.batches(3, seed=4, epochs=2),
                                  strict=True):
        assert gm.dtype == np.float32
        np.testing.assert_array_equal(gm, wm)
        assert gc == wc


def _fill(shapes, seed):
    """Seeded leaves for an eval_shape tree: norm scales 1, biases 0, the
    rest N(0, 1/fan_in), so every LoRA up weight is non-zero."""
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


def test_cache_latents_loss_matches_jax():
    """The tiny PPFT loss from cached moments (no VAE encoder) equals
    JAX's `make_loss_fn(cache_latents=True)` on the same moments, weights
    and draws (JAX's key split, handed to the port), float32."""
    import flax.traverse_util as tu

    import aqualora_torch.core.config as tcfg
    import aqualora_tpu.core.config as jcfg
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_torch.models.watermark import SecretEncoder as TEnc
    from aqualora_torch.train import ppft_train as tt
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe)
    from aqualora_tpu.models.watermark import SecretEncoder as JEnc
    from aqualora_tpu.train import ppft_train as jt

    key0 = jax.random.PRNGKey(0)
    cfg = jcfg.PipelineConfig.tiny()
    bits, grid = cfg.watermark.msg_bits, cfg.watermark.secret_grid
    jpipe = JPipe(cfg)
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(key0, 32, 32)), 0)
    jsec = JEnc(bits, grid, 16, 4)
    sec_params = _fill(jax.eval_shape(lambda: jsec.init(
        key0, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1, bits)))), 1)["params"]
    base_flat, lora_flat = jt.split_lora(params["unet"])
    trainable = {"lora": tu.unflatten_dict(lora_flat),
                 "mapper": params["mapper"]}
    frozen = {"text_encoder": params["text_encoder"],
              "sec_encoder": sec_params}
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((2, 16, 16, 4))
    logvar = rng.uniform(-3, 1, (2, 16, 16, 4))
    moments = np.concatenate([mean, logvar], -1).astype(np.float16).astype(
        np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    loss_fn = jt.make_loss_fn(jpipe, jsec, bits, cache_latents=True)
    j_loss, _ = jax.jit(loss_fn)(trainable, base_flat, frozen,
                                 jnp.asarray(moments), jnp.asarray(ids), key)

    kmsg, kvae, knoise, kt = jax.random.split(key, 7)[:4]
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
    draws = tt.Draws(
        torch.from_numpy(np.array(jax.random.bernoulli(
            kmsg, 0.5, (2, bits)).astype(jnp.float32))),
        nchw(jax.random.normal(kvae, (2, 16, 16, 4), jnp.float32)),
        nchw(jax.random.normal(knoise, (2, 16, 16, 4))),
        torch.from_numpy(np.array(jax.random.randint(
            kt, (2,), 0, cfg.schedule.num_train_timesteps))).long())
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tpipe = TPipe(tcfg.PipelineConfig.tiny(), device="cpu")
    tpipe.load_jax_params(np_tree(params))
    tsec = TEnc(bits, grid, 16, 4)
    tsec.load_state_dict(jax_params_to_torch(np_tree(sec_params)),
                         strict=True)
    encoder_calls = []
    tpipe.vae.encode_moments = lambda *a: encoder_calls.append(a)
    with torch.no_grad():
        t_loss, _ = tt.make_loss_fn(tpipe, tsec, cache_latents=True)(
            moments, ids, draws)
    assert not encoder_calls and float(j_loss) > 1e-4
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)


def test_cache_latents_sample_in_the_pipelines_type(folders, monkeypatch):
    """Under bf16 the cached (float32) moments are cast before the
    posterior sample, so the U-Net gets bf16 latents (a float32 leak
    would promote it); `--random_flip` is refused with the cache."""
    from aqualora_torch.train import ppft_train as tt
    seen = []
    argv = ["--tiny", "--device", "cpu", "--mixed_precision", "bf16",
            "--train_data_dir", folders["meta"], "--train_batch_size", "3",
            "--cache_latents"]
    tr = tt.build_trainer(tt.build_argparser().parse_args(argv))
    assert tr.cached
    sample = tr.pipe.vae.sample_from_moments
    monkeypatch.setattr(tr.pipe.vae, "sample_from_moments",
                        lambda *a: seen.append(a) or sample(*a))
    moments, caps = next(tr.batches)
    assert moments.shape == (3, 32, 32, 8) and moments.dtype == np.float32
    draws = tt.draw(tr.pipe, tr.generator, moments, cached=True)
    metrics = tr.train_step(moments, tr.tokenizer(caps), draws)
    assert all(a.dtype == torch.bfloat16 for a in seen[0])
    assert np.isfinite(float(metrics["ppft_loss"]))
    tr.batches.close()
    with pytest.raises(ValueError, match="random_flip"):
        tt.build_trainer(tt.build_argparser().parse_args(
            argv + ["--random_flip"]))


# ---------------------------------------------------------------------------
# the three trainers from a folder, tiny, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    """Eight small JPEG files of several kinds with captions."""
    root = tmp_path_factory.mktemp("jpegs")
    names = [n for n in DECODABLE if n.endswith(".jpg")
             and MANIFEST["small"][n]["pixels"] == "pillow"][:8]
    with open(root / "metadata.jsonl", "w") as f:
        for i, name in enumerate(names):
            shutil.copy(os.path.join(SMALL, name), root / name)
            f.write(json.dumps({"file_name": name,
                                "text": f"a photo of thing {i}"}) + "\n")
    return str(root)


def _losses_finite(history, key):
    return len(history) == 2 and all(np.isfinite(m[key]) for m in history)


@pytest.mark.parametrize("trainer", ["ppft", "stage1", "stage3"])
def test_trainers_run_from_a_folder(jpeg_folder, tmp_path, trainer):
    """Two steps of each trainer from the folder.  PPFT's first batch is
    JAX's dataset's first batch bit for bit (the native rule at 64 px);
    stage 3's prompts are the folder's captions."""
    from aqualora_tpu.train import data as jdata
    out = str(tmp_path / "out")
    if trainer == "ppft":
        from aqualora_torch.train import ppft_train as tt
        args = tt.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--train_batch_size", "2",
             "--max_train_steps", "2", "--train_data_dir", jpeg_folder])
        tr = tt.build_trainer(args)
        pixels, caps = next(tr.batches)
        tr.batches.close()
        want, wcaps = next(jdata.ImageFolderDataset(jpeg_folder, 64).batches(
            2, seed=0))
        np.testing.assert_array_equal(pixels, want)
        assert caps == wcaps
        assert _losses_finite(tt.run(args)["history"], "ppft_loss")
    elif trainer == "stage1":
        from aqualora_torch.train import latent_wm_pretrain as s1
        res = s1.run(s1.build_argparser().parse_args(
            ["--tiny", "--device", "cpu", "--batch_size", "2",
             "--max_train_steps", "2", "--dataset", jpeg_folder,
             "--output_dir", out]))
        assert _losses_finite(res["history"], "loss")
        assert os.path.exists(os.path.join(out, "pretrained_latentwm.pt"))
    else:
        from aqualora_torch.train import rob_enhance_finetune as s3
        argv = ["--tiny", "--device", "cpu", "--train_batch_size", "2",
                "--max_train_steps", "2", "--train_data_dir", jpeg_folder,
                "--output_dir", out, "--report_to", "none"]
        tr = s3.build_trainer(s3.build_argparser().parse_args(argv))
        prompts = []
        tok = tr.tokenizer
        tr.tokenizer = lambda caps: prompts.append(caps) or tok(caps)
        captions, res, d = s3.next_step_inputs(tr)
        s3.train_step(tr, res, captions, d)
        tr.batches.close()
        folder_caps = set(tdata.make_dataset(jpeg_folder, 8).captions)
        assert len(prompts[0]) == 2 and set(prompts[0]) <= folder_caps
        res = s3.run(s3.build_argparser().parse_args(argv))
        assert _losses_finite(res["history"], "loss")


# ---------------------------------------------------------------------------
# no PIL
# ---------------------------------------------------------------------------

_NO_PIL = textwrap.dedent("""
    import sys
    sys.modules["PIL"] = None                 # `import PIL` now fails
    import os, json, pkgutil, importlib, tempfile, shutil
    import numpy as np
    import aqualora_torch
    for m in pkgutil.walk_packages(aqualora_torch.__path__, "aqualora_torch."):
        importlib.import_module(m.name)
    from aqualora_torch.train import data, image_decode, ppft_train
    small = sys.argv[1]
    manifest = json.load(open(os.path.join(small, "..", "manifest.json")))
    ok = sorted(n for n, m in manifest["small"].items() if not m["refused"])
    image_decode.decode_batch([os.path.join(small, n) for n in ok], 16)
    root = tempfile.mkdtemp()
    with open(os.path.join(root, "metadata.jsonl"), "w") as f:
        for n in ["baseline_q50.jpg", "baseline_q75.jpg", "arith420.jpg",
                  "cmyk.jpg", "unfinished.jpg", "palette_trns.png"]:
            shutil.copy(os.path.join(small, n), root)
            f.write(json.dumps({"file_name": n, "text": n}) + "\\n")
    for crop in (False, True):
        ds = data.make_dataset(root, 16, center_crop=crop, random_flip=True)
        list(data.prefetch(ds.batches(4, epochs=1, drop_last=False)))
    ppft_train.run(ppft_train.build_argparser().parse_args(
        ["--tiny", "--device", "cpu", "--train_batch_size", "3",
         "--max_train_steps", "1", "--train_data_dir", root,
         "--cache_latents"]))
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (
        m in ("jax", "PIL") or m.startswith(("jax.", "PIL.", "aqualora_tpu"))))
    assert not bad, bad
    print("no-PIL data path ok")
""")


def test_the_data_path_runs_without_pil():
    """Every module of the port imports, and the data path runs (both
    decoders, both rules, prefetch, the latent cache inside a PPFT step),
    with PIL blocked; nothing of jax or the JAX package is imported."""
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, SMALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-PIL data path ok" in proc.stdout
