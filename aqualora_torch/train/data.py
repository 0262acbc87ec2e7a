"""Training data for the port: image folders, synthetic images, cached
latents and a prefetch thread.

The port of `aqualora_tpu/train/data.py` (numpy only; no PIL, no jax):

- `ImageFolderDataset`: the images under a folder, with captions from its
  `metadata.jsonl` (`file_name` and the caption column) or, without one, a
  sorted case-insensitive scan of .png/.jpg/.jpeg.  Each epoch is the
  permutation `default_rng(seed + epoch)`, sharded by process
  (`process_index::process_count`), drop-last by default.  Pixels come
  from `train/image_decode.py` (the port's own JPEG and PNG decoders):
  - `center_crop=False`: the JAX native loader's rule, its float32
    bicubic straight from the decoded pixels (no rounding to uint8);
  - `center_crop=True`: PIL's rule of the JAX package's `_transform_pil`,
    the centred square crop, PIL's bicubic to uint8
    (`eval/image_io.resize_bicubic_pil`), / 127.5 - 1;
  - a batch that holds a file the JAX native loader refuses and PIL reads
    (a four-component JPEG, Adobe CMYK or YCCK: libjpeg cannot give it as
    RGB) takes PIL's rule whole, without the crop unless asked, as the JAX
    dataset sends the whole batch to PIL (`data.py:108-120`): every image
    decoded (`image_decode`, PIL's `convert("RGB")` pixels), PIL's bicubic
    to uint8, / 127.5 - 1.  Under data parallelism the batch is a rank's
    slice.
  Either way the flips are one `rng.random() < 0.5` draw per image, in
  order, drawn for the whole batch.  The native rule reads a JPEG file cut
  short as the loader's libjpeg does (its data to the cut, then what
  libjpeg makes of the rest); PIL's rule refuses it, as PIL does, with its
  path.  A file that neither package reads (lossless, hierarchical,
  12-bit JPEG) raises with its path and the reason.
- `SyntheticDataset`: seeded uniform images with captions, the JAX
  dataset's batches for the same arguments.
- `CachedMomentsDataset` (`--cache_latents`): one pass encodes every
  sample to VAE posterior moments held as float16 on the host.
- `make_dataset`: the factory the trainers call; `prefetch`: a bounded
  background thread ahead of the step.  Each dataset's `batches` takes a
  `part` (rank, n): a data-parallel rank's contiguous slice of every
  global batch (the image folder decodes only that slice's files).

The HF `datasets` path (`HFDataset`) needs that package and a download: a
`dataset_name` is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from aqualora_torch.core import sharding as sh
from aqualora_torch.eval.image_io import resize_bicubic_pil
from aqualora_torch.train import image_decode


def _shard_len(n: int, process_index: int, process_count: int) -> int:
    return len(range(process_index, n, process_count))


def _check_shard(n_shard: int, batch_size: int, what: str) -> None:
    """Drop-last with a shard smaller than one batch yields nothing, and an
    endless training loop would wait forever: refuse it."""
    if n_shard < batch_size:
        raise ValueError(
            f"{what}: host shard has {n_shard} samples < batch_size "
            f"{batch_size} — drop-last iteration would never yield a "
            "batch; lower the batch size or provide more data")


def _transform_pil(img: np.ndarray, resolution: int,
                   center_crop: bool = True) -> np.ndarray:
    """HWC uint8 RGB -> [-1, 1] float32 HWC by the JAX package's
    `_transform_pil`: the centred square crop when asked, PIL's bicubic to
    resolution^2 in uint8, / 127.5 - 1 (the flip is the caller's)."""
    if center_crop:
        h, w = img.shape[:2]
        s = min(h, w)
        top, left = (h - s) // 2, (w - s) // 2
        img = img[top:top + s, left:left + s]
    img = resize_bicubic_pil(img, (resolution, resolution))
    return img.astype(np.float32) / 127.5 - 1.0


@dataclass
class ImageFolderDataset:
    """Images (+ optional captions from metadata.jsonl) under a root dir."""

    root: str
    resolution: int = 512
    center_crop: bool = False
    random_flip: bool = False
    caption_column: str = "text"
    num_threads: int = 0          # decoder threads (0: the host's count)

    def __post_init__(self):
        meta = os.path.join(self.root, "metadata.jsonl")
        self.captions: Optional[List[str]] = None
        if os.path.exists(meta):
            files, caps = [], []
            with open(meta) as f:
                for line in f:
                    row = json.loads(line)
                    files.append(os.path.join(self.root, row["file_name"]))
                    caps.append(row.get(self.caption_column, ""))
            self.files, self.captions = files, caps
        else:
            # case-insensitive: camera exports commonly ship .JPG/.JPEG
            self.files = sorted(
                os.path.join(self.root, f) for f in os.listdir(self.root)
                if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not self.files:
            raise FileNotFoundError(f"no images under {self.root}")

    def __len__(self):
        return len(self.files)

    def _load_batch(self, idx, rng: np.random.Generator,
                    rows: slice = slice(None)) -> np.ndarray:
        """The batch `idx`'s `rows` (a data-parallel rank's), decoded by the
        native loader's rule or, with `center_crop` or a file only PIL
        reads in them, by PIL's; the flips are drawn for the whole batch,
        one a sample, so that each sample takes the draw it takes in the
        whole batch."""
        flips = rng.random(len(idx)) < 0.5 if self.random_flip else None
        paths = [self.files[j] for j in idx[rows]]
        if not self.center_crop and not any(
                image_decode.needs_pil_rule(p) for p in paths):
            imgs = image_decode.decode_batch(paths, self.resolution,
                                             nthreads=self.num_threads)
            if flips is not None:
                mine = flips[rows]
                imgs[mine] = imgs[mine, :, ::-1]
            return imgs
        out = []
        for p, flip in zip(paths, flips[rows] if flips is not None
                           else [False] * len(paths)):
            arr = _transform_pil(image_decode.decode_file(p, pil=True),
                                 self.resolution, self.center_crop)
            out.append(arr[:, ::-1] if flip else arr)
        return np.stack(out)

    def batches(self, batch_size: int, seed: int = 0,
                process_index: int = 0, process_count: int = 1,
                epochs: Optional[int] = None, drop_last: bool = True,
                part: Tuple[int, int] = (0, 1)
                ) -> Iterator[Tuple[np.ndarray, Optional[List[str]]]]:
        """Shuffled, host-sharded epochs of (images NHWC float32,
        captions or None); drop-last by default, and with
        `drop_last=False` the tail as a smaller last batch.  `part` (rank,
        n): data rank `rank` of `n`'s contiguous slice of each batch,
        decoding only its own files."""
        if drop_last:
            _check_shard(_shard_len(len(self.files), process_index,
                                    process_count), batch_size, self.root)
        rng = np.random.default_rng(seed + process_index)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.random.default_rng(seed + epoch).permutation(
                len(self.files))
            shard = order[process_index::process_count]
            stop = (len(shard) - batch_size + 1) if drop_last else len(shard)
            for i in range(0, stop, batch_size):
                idx = shard[i:i + batch_size]
                rows = sh.batch_slice(len(idx), *part)
                imgs = self._load_batch(idx, rng, rows)
                caps = ([self.captions[j] for j in idx[rows]]
                        if self.captions is not None else None)
                yield imgs, caps
            epoch += 1


@dataclass
class SyntheticDataset:
    """Deterministic random images + captions (tests/benchmarks)."""

    resolution: int = 512
    size: int = 256

    def __len__(self):
        return self.size

    def batches(self, batch_size: int, seed: int = 0, process_index: int = 0,
                process_count: int = 1, epochs: Optional[int] = None,
                drop_last: bool = True, part: Tuple[int, int] = (0, 1)):
        """(images [n, res, res, 3] float32 in [-1, 1], captions); each
        epoch covers the shard's nominal size from its own generator,
        drop-last (at least one batch) or with the tail; `part` (rank, n)
        yields that data rank's slice of each batch."""
        shard_n = max(1, self.size // process_count)
        if drop_last:           # generated data: always at least one batch
            sizes = [batch_size] * max(1, shard_n // batch_size)
        else:                   # cover exactly the nominal shard size
            sizes = [batch_size] * (shard_n // batch_size)
            if shard_n % batch_size:
                sizes.append(shard_n % batch_size)
        epoch = 0
        while epochs is None or epoch < epochs:
            rng = np.random.default_rng(seed + 1000 * epoch + process_index)
            for n in sizes:
                imgs = rng.uniform(-1, 1, (n, self.resolution,
                                           self.resolution, 3)).astype(np.float32)
                caps = [f"synthetic caption {int(x)}"
                        for x in rng.integers(0, 1000, n)]
                yield sh.shard_batch((imgs, caps), *part)
            epoch += 1


@dataclass
class CachedMomentsDataset:
    """`--cache_latents`: every sample of this process's shard encoded
    once to VAE posterior moments [N, h, w, 2C] (mean || clipped logvar on
    the channels, NHWC as the JAX package keeps them), float16 on the
    host.  `batches` then yields float32 moments instead of pixels; the
    posterior's sampling noise stays in the step, so the objective is
    unchanged (the encoder is deterministic).  Incompatible with
    `random_flip`: the cache holds one view of each sample."""

    moments: np.ndarray
    captions: Optional[List[str]]
    process_index: int = 0

    @classmethod
    def build(cls, base, encode_fn, batch_size: int, seed: int = 0,
              process_index: int = 0, process_count: int = 1
              ) -> "CachedMomentsDataset":
        """encode_fn: pixels [B, H, W, 3] -> moments [B, h, w, 2C].  Streams
        the shard in `batch_size` chunks without drop-last, the tail chunk
        zero-padded to the one encode shape, so every sample is cached."""
        mlist: List[np.ndarray] = []
        clist: List[Optional[str]] = []
        for imgs, caps in base.batches(batch_size, seed=seed,
                                       process_index=process_index,
                                       process_count=process_count,
                                       epochs=1, drop_last=False):
            n = len(imgs)
            if n < batch_size:           # pad: one static encode shape
                imgs = np.concatenate(
                    [imgs, np.zeros((batch_size - n,) + imgs.shape[1:],
                                    imgs.dtype)])
            mlist.append(np.asarray(encode_fn(imgs), np.float16)[:n])
            clist.extend(list(caps)[:n] if caps is not None else [None] * n)
        if not mlist:
            raise ValueError(
                f"cache_latents: host shard {process_index}/{process_count} "
                f"of {base!r} yielded no samples")
        caps_out: Optional[List[str]] = None
        if any(c is not None for c in clist):
            caps_out = ["" if c is None else c for c in clist]
        return cls(np.concatenate(mlist), caps_out, process_index)

    def __len__(self):
        return len(self.moments)

    def batches(self, batch_size: int, seed: int = 0, process_index: int = 0,
                process_count: int = 1, epochs: Optional[int] = None,
                part: Tuple[int, int] = (0, 1)
                ) -> Iterator[Tuple[np.ndarray, Optional[List[str]]]]:
        """Drop-last epochs shuffled within the shard (sharded at build
        time: the process arguments are accepted and ignored); `part`
        (rank, n) yields that data rank's slice of each batch."""
        del process_index, process_count
        n = len(self.moments)
        _check_shard(n, batch_size, "cached latents")
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.random.default_rng(
                seed + epoch + 1000 * self.process_index).permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                idx = idx[sh.batch_slice(len(idx), *part)]
                caps = ([self.captions[j] for j in idx]
                        if self.captions is not None else None)
                yield self.moments[idx].astype(np.float32), caps
            epoch += 1


def _fields_of(cls, kw):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names and v is not None}


def make_dataset(path: Optional[str], resolution: int,
                 dataset_name: Optional[str] = None,
                 max_samples: Optional[int] = None, **kw):
    """The trainers' dataset: the image folder at `path`, else synthetic
    images.  Extra keyword arguments reach the dataset class's fields of
    the same name (center_crop, random_flip, caption_column, num_threads);
    the rest (image_column, config_name: the HF path's) are ignored, as
    the JAX factory ignores the fields a class lacks."""
    if dataset_name:
        raise NotImplementedError(
            f"--dataset_name {dataset_name!r}: the HF datasets path needs "
            "the `datasets` package and a download, neither of which the "
            "port has; pass a folder with --train_data_dir")
    if path:
        if not os.path.isdir(path):
            # never train a long run on noise because of a typo'd path
            raise FileNotFoundError(
                f"train data dir {path!r} is not a directory")
        ds = ImageFolderDataset(path, resolution,
                                **_fields_of(ImageFolderDataset, kw))
        if max_samples:
            ds.files = ds.files[:max_samples]
            if ds.captions:
                ds.captions = ds.captions[:max_samples]
        return ds
    return SyntheticDataset(resolution)


def prefetch(iterator, depth: int = 2):
    """Run `iterator` in a background thread, up to `depth` batches ahead
    (the reference's DataLoader workers).  An exception in the thread
    re-raises in the consumer; when the consumer stops early (a break, an
    exception, the generator closed), the thread stops at its next put,
    closes the iterator and ends, and the consumer waits for that (at most
    one batch's time), so no thread outlives the loop."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put, so an abandoned consumer does not leave the thread
        # blocked on a full queue with the iterator open
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(end)
        except BaseException as e:       # surfaced on the consumer side
            _put(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:        # generator cleanup (finally blocks)
                close()

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()                       # GeneratorExit / break / exception
        t.join()
