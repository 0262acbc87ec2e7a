"""Stage 1, the latent watermark pretraining, in PyTorch.

The port of `aqualora_tpu/train/latent_wm_pretrain.py:59-426`.  The
SecretEncoder and SecretDecoder are trained around a frozen VAE and a
frozen LPIPS:

    latents  = vae.sample(images)                                [no grad]
    wm       = maybe_cornerfy(sec_encoder(latents, msg)[1])
    clean    = vae.decode(latents)                               [no grad]
    wm_img   = vae.decode(latents + wm_scale * wm)
    loss     = w_lpips * lpips(clean, wm_img) + w_msg * bce(decoder(
               noiser(wm_img)), msg) + w_prvl * prvl(clean, wm_img)

The watermarked decode is differentiated, and with it the VAE mid-block's
single-head attention at d = 512 (T = 4096 at 512 px): one step launches
the forward kernel three times (encode, clean decode, watermarked decode)
and the d = 512 backward kernels (dQ, dK/dV) once each.

The step's random numbers are one `Draws`, drawn by `draw` from an explicit
`torch.Generator`; the loss takes them as an argument, so that a test can
hand it the JAX trainer's.  The curriculum is the JAX trainer's (`run`):

- a warm-up on zero images (`--fixinit`) at watermark scale 0.03 with the
  message loss alone, left when the mean message loss of the last 10
  batches is below 0.1;
- loss weights (lpips, msg, prvl) by epoch: (0, 1, 0), (1, 1, 0) after
  epoch 6, (5, 1, 1.5) after epoch 10;
- the distortion probabilities (identity, jpeg, crop, blur, noise, jitter)
  (0.6, 0, 0.4, 0, 0, 0), and (0.4, 0.1, 0.2, 0.05, 0.1, 0.15) after
  epoch 12;
- AdamW (lr 1e-3, weight decay 1e-4) with optax's algebra
  (`ppft_train.adamw`) and StepLR: lr * 0.8^(epoch // 2), epoch = update
  count // steps per epoch.

With `--mixed_precision bf16` all four modules compute in bfloat16, as
the JAX trainer's `dtype`: the frozen VAE and LPIPS are stored in bfloat16,
and the SecretEncoder and SecretDecoder keep float32 parameters (and
gradients, and AdamW state) and compute under `torch.autocast`, as flax's
`dtype=bfloat16` on float32 parameters does.  At the end the trained
encoder and decoder (with its BatchNorm statistics) are written as torch
state dicts to `<output_dir>/pretrained_latentwm.pt`.

Run on the card (the default) or on the CPU:

    python -m aqualora_torch.train.latent_wm_pretrain --batch_size 5 \\
        --max_train_steps 4
    python -m aqualora_torch.train.latent_wm_pretrain --tiny \\
        --max_train_steps 2 --batch_size 2 --device cpu

`--pretrained_model_name_or_path` loads the frozen VAE from a local
diffusers directory (`vae/diffusion_pytorch_model.safetensors`), a
directory holding `diffusion_pytorch_model.safetensors`, or that file.

`--dataset DIR` trains on a folder of JPEG and PNG files (`train/data.py`,
the JAX loader's rule: no crop, no flip), each epoch one pass over its
permutation at `--seed` + epoch, decoded a batch ahead on a background
thread (`data.prefetch`); without it, synthetic images.

At the end of each epoch (`latent_wm_pretrain.py:283-331`): one
watermarked sample of the epoch's last batch is written to
`<output_dir>/log_images/watermarked_<epoch>.png` (`eval/image_io.py`,
no PIL), the eval's bit accuracy is logged, and a checkpoint of the
encoder, the decoder with its BatchNorm statistics, the optimizer, the
schedule, the epoch and the generator's state goes to
`<output_dir>/checkpoints/<epoch>.pt` (`core/checkpoint.py`).
`--resume_from_ckpt E` restores epoch E's checkpoint (the latest when E is
not a number; JAX always takes the latest) and runs `--epochs` more
epochs from E + 1, as JAX does (`:236-244`): without the warm-up, with the
late loss weights and distortion probabilities.  `--report_to` adds
TensorBoard or wandb (`utils/logging.Tracker`) under `<output_dir>/logs`,
with JAX's scalar names (default none, where JAX's is tensorboard).

`--remat_vae_decode` recomputes the watermarked VAE decode in the backward
(`torch.utils.checkpoint`; its d = 512 attention forward then runs four
times a step) and `--remat_lpips` the LPIPS call, each alone as in JAX
(`:78-111`).  `--debug_nans` raises on a non-finite loss.

Several GPUs (`core/sharding.py`; JAX `:225-280`): under `torchrun`
`--batch_size` is the global batch, which the world size must divide;
each rank takes its slice of the batch and of the step's draws (drawn for
the global batch), the decoder's BatchNorm normalises over the global
batch (`efficientnet.global_batch_norm`), PRVL takes the global batch's
largest box mean (the one loss term that is not a mean over samples: its
gradient reaches only the rank that holds the maximum), and the
gradients are averaged before AdamW.  `--fsdp` (a world above 1) shards
the frozen VAE and LPIPS with FSDP2 and the moments ZeRO-1 style.  Only
rank 0 prints, logs and writes the sample images and the artifact; a
checkpoint is a collective written by rank 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from aqualora_torch.core import sharding as sh
from aqualora_torch.core.checkpoint import CheckpointManager
from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                        WatermarkConfig)
from aqualora_torch.core.io import assign_state, load_safetensors
from aqualora_torch.diffusion.pipeline import init_module_weights
from aqualora_torch.distort.noiser import Noiser, NoiseDraw
from aqualora_torch.eval.image_io import images_to_uint8, save_png
from aqualora_torch.models.efficientnet import Masks, global_batch_norm
from aqualora_torch.models.lpips import LPIPS
from aqualora_torch.models.vae import AutoencoderKL
from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
from aqualora_torch.train import data as data_lib
from aqualora_torch.train.augment import base_augment, maybe_cornerfy
from aqualora_torch.train.losses import bit_accuracy, message_bce, prvl_loss
from aqualora_torch.train.ppft_train import adamw
from aqualora_torch.utils.logging import Tracker

EARLY_PROBS = (0.6, 0.0, 0.4, 0.0, 0.0, 0.0)
LATE_PROBS = (0.4, 0.1, 0.2, 0.05, 0.1, 0.15)       # after epoch 12


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage1Models:
    vae: AutoencoderKL
    sec_encoder: SecretEncoder
    sec_decoder: SecretDecoder
    lpips: LPIPS
    noiser: Noiser
    dtype: torch.dtype = torch.float32     # the compute type

    def autocast(self):
        """The context in which the SecretEncoder and SecretDecoder compute
        in `dtype` on their float32 parameters."""
        return torch.autocast(self.vae.quant_conv.weight.device.type,
                              self.dtype, enabled=self.dtype != torch.float32)


def build_models(vae_cfg: VAEConfig, wm_cfg: WatermarkConfig,
                 backbone: Optional[EfficientNetConfig] = None,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32) -> Stage1Models:
    """The four modules on `device`, computing in `dtype`: the frozen VAE
    and LPIPS stored in it, the SecretEncoder and SecretDecoder with float32
    parameters (see `Stage1Models.autocast`).  The encoder's grid is
    upsampled to 512 // downscale, as in the JAX trainer, then resized to
    the latent's size."""
    with torch.device(device):
        vae = AutoencoderKL(vae_cfg)
        lpips = LPIPS()
        enc = SecretEncoder(wm_cfg.msg_bits, wm_cfg.secret_grid,
                            512 // vae_cfg.downscale, vae_cfg.latent_channels)
    dec = SecretDecoder(wm_cfg.msg_bits, backbone, device=device)
    for m in (vae, lpips):
        m.to(dtype).eval().requires_grad_(False)
    return Stage1Models(vae, enc, dec, lpips, Noiser(), dtype)


@torch.no_grad()
def init_models(models: Stage1Models, seed: int) -> None:
    """Seeded random weights (`init_module_weights`' rule); the encoder's
    conv stays zero (its identity start) and the LPIPS lin weights start
    at one, as in the JAX modules."""
    gen = torch.Generator(device=models.vae.quant_conv.weight.device)
    gen.manual_seed(seed)
    for m in (models.vae, models.lpips, models.sec_decoder,
              models.sec_encoder.secret_dense):
        init_module_weights(m, gen)
    for i in range(5):
        getattr(models.lpips, f"lin{i}").model[1].weight.fill_(1.0)


def trainables(models: Stage1Models) -> Dict[str, list]:
    return {"sec_encoder": list(models.sec_encoder.parameters()),
            "sec_decoder": list(models.sec_decoder.parameters())}


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Control:
    """The curriculum's state for one step; the defaults are the
    curriculum after epoch 12, where every loss term is live."""

    wm_scale: float = 1.0
    loss_weights: Tuple[float, float, float] = (5.0, 1.0, 1.5)
    distort_probs: Tuple[float, ...] = LATE_PROBS
    fixinit: bool = False
    random_aug: bool = True


@dataclasses.dataclass
class Draws:
    """One step's random numbers (NCHW): the VAE posterior noise [B, C, h,
    w], the message bits [B, bits] float32, the cornerfy flag and scales,
    `base_augment`'s apply flag, flip flag and quarter turns, the Noiser's
    layer and its numbers, and the decoder's stochastic-depth and dropout
    masks."""

    vae_noise: torch.Tensor
    msg: torch.Tensor
    corner: bool
    corner_hs: float
    corner_ws: float
    aug: bool
    aug_flip: bool
    aug_k: int
    noise: NoiseDraw
    masks: Masks

    def shard(self, rank: int, n: int) -> "Draws":
        """Data rank `rank` of `n`'s rows of the global batch's draws (the
        step's scalars are every rank's)."""
        if n == 1:
            return self
        return dataclasses.replace(
            self, vae_noise=self.vae_noise[sh.batch_slice(
                self.msg.shape[0], rank, n)],
            msg=sh.shard_batch(self.msg, rank, n),
            noise=self.noise.shard(self.msg.shape[0], rank, n),
            masks=self.masks.shard(rank, n))

    def to(self, device) -> "Draws":
        """The same numbers on `device`."""
        mv = lambda t: t.to(device)
        return dataclasses.replace(
            self, vae_noise=mv(self.vae_noise), msg=mv(self.msg),
            noise=NoiseDraw(self.noise.index, {k: mv(v) for k, v in
                                               self.noise.params.items()}),
            masks=Masks([mv(m) for m in self.masks.depth],
                        None if self.masks.dropout is None
                        else mv(self.masks.dropout)))


def draw(models: Stage1Models, gen: torch.Generator, shape,
         probs) -> Draws:
    """A step's `Draws` for images of NCHW `shape`, from `gen` (on the
    models' device), the Noiser's layer picked with `probs`."""
    b, _, h, w = shape
    cfg, dev = models.vae.cfg, gen.device
    down = cfg.downscale
    vae_noise = torch.randn((b, cfg.latent_channels, h // down, w // down),
                            generator=gen, device=dev,
                            dtype=models.vae.quant_conv.weight.dtype)
    msg = torch.bernoulli(torch.full((b, models.sec_decoder.output_size),
                                     0.5, device=dev), generator=gen)
    u = torch.rand(6, generator=gen, device=dev).tolist()
    return Draws(vae_noise, msg, corner=u[0] < 0.25, corner_hs=1.0 + u[1],
                 corner_ws=1.0 + u[2], aug=u[3] < 0.5, aug_flip=u[4] < 0.5,
                 aug_k=min(int(u[5] * 4), 3),
                 noise=models.noiser.draw(gen, shape, probs),
                 masks=models.sec_decoder.model.draw_masks(b, gen))


def _remat(fn, on: bool):
    """`fn`, recomputed in the backward when `on` (jax.checkpoint)."""
    if not on:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def global_max(local: torch.Tensor, group) -> torch.Tensor:
    """The largest of the ranks' scalars `local`, with the gradient of a
    max over the global batch under gradient averaging: the value is the
    global maximum on every rank, and its gradient flows, times the group's
    size, into the lowest rank that holds it (a max's gradient reaches its
    argmax alone)."""
    n = sh.group_size(group)
    if n == 1:
        return local
    best = local.detach().float().clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    mine = torch.where(local.detach().float() == best,
                       torch.tensor(float(dist.get_rank(group)),
                                    device=best.device),
                       torch.tensor(float(n), device=best.device))
    dist.all_reduce(mine, op=dist.ReduceOp.MIN, group=group)
    weight = float(n) if int(mine) == dist.get_rank(group) else 0.0
    scaled = local * weight
    return (scaled - scaled.detach() + best).to(local.dtype)


def make_loss_fn(models: Stage1Models, remat_vae_decode: bool = False,
                 remat_lpips: bool = False, group=None):
    """-> loss_fn(images NCHW, draws, ctl) -> (loss, metrics)
    (`latent_wm_pretrain.py:78-121`); the two remat flags recompute the
    watermarked decode and the LPIPS call in the backward.  Under data
    parallelism the images are this rank's slice and `group` takes PRVL's
    maximum over the global batch (`global_max`)."""
    vae = models.vae
    wm_decode = _remat(vae.decode, remat_vae_decode)
    lpips = _remat(models.lpips, remat_lpips)

    def loss_fn(images: torch.Tensor, draws: Draws, ctl: Control):
        with torch.no_grad():
            latents = vae.sample_from_moments(*vae.encode_moments(images),
                                              draws.vae_noise)
        with models.autocast():
            _, wm = models.sec_encoder(latents, draws.msg)
        wm = maybe_cornerfy(wm, draws.corner, draws.corner_hs,
                            draws.corner_ws)
        wm_latents = latents + wm * ctl.wm_scale
        with torch.no_grad():
            clean = vae.decode(latents)
        wm_img = wm_decode(wm_latents)
        lp = lpips(clean, wm_img).float().mean()
        pr = global_max(prvl_loss(clean, wm_img), group)
        noised = models.noiser(wm_img, draws.noise)
        with models.autocast():
            logits = models.sec_decoder(noised, train=True,
                                        masks=draws.masks)
        msgloss = message_bce(logits, draws.msg)
        w = ctl.loss_weights
        loss = w[0] * lp + w[1] * msgloss + w[2] * pr
        metrics = {"loss": loss.detach(), "lpips_loss": lp.detach(),
                   "msgloss": msgloss.detach(), "prvl_loss": pr.detach(),
                   "acc": bit_accuracy(logits.detach(), draws.msg)}
        return loss, metrics

    return loss_fn


def step_lr(steps_per_epoch: int):
    """StepLR(2 epochs, gamma 0.8) as a factor of the update count."""
    return lambda step: 0.8 ** ((step // steps_per_epoch) // 2)


def make_optimizer(models: Stage1Models, lr: float, steps_per_epoch: int,
                   zero_group=None):
    """AdamW(lr, weight decay 1e-4) over the encoder and decoder, StepLR;
    the moments sharded ZeRO-1 style over `zero_group`."""
    return adamw(trainables(models), lr, step_lr(steps_per_epoch),
                 weight_decay=1e-4, zero_group=zero_group)


def make_train_step(models: Stage1Models, optimizer, scheduler,
                    remat_vae_decode: bool = False,
                    remat_lpips: bool = False, group=None):
    """-> train_step(pixels NHWC, draws, ctl) -> metrics: one update of
    the encoder and decoder (`latent_wm_pretrain.py:123-135`).  Under data
    parallelism the pixels and draws are this rank's slice: `group`
    normalises the decoder's BatchNorm over the global batch, averages the
    gradients before the update and the metrics after."""
    loss_fn = make_loss_fn(models, remat_vae_decode, remat_lpips, group)
    dev = models.vae.quant_conv.weight.device
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(pixels, draws: Draws, ctl: Control) -> Dict[str, Any]:
        x = torch.as_tensor(pixels, device=dev).permute(0, 3, 1, 2)
        if ctl.fixinit:
            x = torch.zeros_like(x)
        if ctl.random_aug:
            x = base_augment(x, draws.aug, draws.aug_flip, draws.aug_k)
        optimizer.zero_grad(set_to_none=True)
        with global_batch_norm(group):
            loss, metrics = loss_fn(x, draws, ctl)
        loss.backward()
        sh.average_gradients(params, group)
        optimizer.step()
        scheduler.step()
        return {k: sh.mean_over(v, group) for k, v in metrics.items()}

    return train_step


def make_eval_step(models: Stage1Models):
    """-> eval_step(pixels NHWC, vae_noise, msg) -> bit accuracy of the
    full-strength watermark through the decoder in eval mode
    (`latent_wm_pretrain.py:140-155`)."""
    vae = models.vae
    dev = vae.quant_conv.weight.device

    @torch.no_grad()
    def eval_step(pixels, vae_noise, msg, group=None) -> torch.Tensor:
        x = torch.as_tensor(pixels, device=dev).permute(0, 3, 1, 2)
        latents = vae.sample_from_moments(*vae.encode_moments(x), vae_noise)
        with models.autocast():
            _, wm = models.sec_encoder(latents, msg)
        wm_img = vae.decode(latents + wm)
        with models.autocast():
            logits = models.sec_decoder(wm_img)
        return sh.mean_over(bit_accuracy(logits, msg), group)

    return eval_step


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def curriculum(rel_epoch: int, warmup: bool, fixinit: bool,
               random_aug: bool, resumed: bool = False) -> Control:
    """The staged scale, loss weights and distortion probabilities of an
    epoch (`latent_wm_pretrain.py:260-278`); a resumed run takes the late
    ones."""
    if warmup:
        weights = (0.0, 1.0, 0.0)
    elif rel_epoch > 10 or resumed:
        weights = (5.0, 1.0, 1.5)
    elif rel_epoch > 6:
        weights = (1.0, 1.0, 0.0)
    else:
        weights = (0.0, 1.0, 0.0)
    return Control(wm_scale=0.03 if warmup else 1.0, loss_weights=weights,
                   distort_probs=LATE_PROBS if rel_epoch > 12 or resumed
                   else EARLY_PROBS,
                   fixinit=fixinit, random_aug=random_aug)


@dataclasses.dataclass
class Trainer:
    """What `run` builds: the models, the optimizer and schedule, the
    step, the data and the step's generator; this process's world, its
    data-parallel group (None without a process group) and whether
    `--fsdp` sharded the frozen towers."""

    models: Stage1Models
    optimizer: Any
    scheduler: Any
    train_step: Any
    eval_step: Any
    dataset: Any
    generator: torch.Generator
    steps_per_epoch: int
    world: sh.World = sh.World()
    group: Any = None
    fsdp: bool = False

    def draw(self, batch: int, res: Tuple[int, int], probs) -> Draws:
        """The draws of a global batch of `batch` images, this rank's
        rows."""
        return draw(self.models, self.generator, (batch, 3, *res),
                    probs).shard(self.world.rank, self.world.size)


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The trainer in this process's world (`sharding.init_distributed`);
    `--fsdp` takes effect at a world size above 1, as in JAX."""
    world, group, fsdp = sh.setup_world(args.device, args.batch_size,
                                        args.fsdp)
    device = world.device
    torch.manual_seed(args.seed)
    if args.tiny:
        vae_cfg, wm_cfg = VAEConfig.tiny(), WatermarkConfig.tiny()
        backbone, resolution = EfficientNetConfig.tiny(), 64
    else:
        vae_cfg, wm_cfg = VAEConfig.sd15(), WatermarkConfig(
            msg_bits=args.bit_num)
        backbone, resolution = EfficientNetConfig.b1(), 512
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    models = build_models(vae_cfg, wm_cfg, backbone, device, dtype)
    init_models(models, args.seed)
    if args.pretrained_model_name_or_path:
        _load_vae_params(args.pretrained_model_name_or_path, models.vae)
    if fsdp:
        # JAX `:228-235`: the frozen VAE and LPIPS sharded, the encoder and
        # decoder whole on every rank
        mesh = sh.make_mesh()
        sh.shard_frozen(models.vae, mesh,
                        [models.vae.encoder, models.vae.decoder], root=False)
        sh.shard_frozen(models.lpips, mesh)
    dataset = data_lib.make_dataset(args.dataset, resolution)
    steps_per_epoch = max(1, len(dataset) // args.batch_size)
    optimizer, scheduler = make_optimizer(
        models, args.lr, steps_per_epoch,
        sh.world_group() if fsdp else None)
    return Trainer(models, optimizer, scheduler,
                   make_train_step(models, optimizer, scheduler,
                                   args.remat_vae_decode, args.remat_lpips,
                                   group),
                   make_eval_step(models), dataset,
                   torch.Generator(device=device).manual_seed(args.seed + 1),
                   steps_per_epoch, world, group, fsdp)


def _load_vae_params(path: str, vae: AutoencoderKL) -> None:
    """The VAE from a diffusers safetensors checkpoint, strictly, in the
    module's type (`_load_vae_params`, `latent_wm_pretrain.py:359-369`)."""
    for sub in ("vae/diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.safetensors", ""):
        p = os.path.join(path, sub) if sub else path
        if os.path.isfile(p):
            assign_state(vae, load_safetensors(p), what="vae")
            return
    raise FileNotFoundError(f"no VAE safetensors under {path}")


def save_artifact(models: Stage1Models, path: str) -> None:
    """The trained encoder and decoder (with its BatchNorm statistics) as
    torch state dicts, the hand-off to stages 2 and 3."""
    torch.save({"sec_encoder": models.sec_encoder.state_dict(),
                "sec_decoder": models.sec_decoder.state_dict()}, path)


def checkpoint_state(tr: Trainer, epoch: int) -> Dict[str, Any]:
    """An epoch's checkpoint: the encoder, the decoder with its BatchNorm
    statistics, the optimizer, the schedule, the epoch and the generator's
    state."""
    return {"sec_encoder": tr.models.sec_encoder.state_dict(),
            "sec_decoder": tr.models.sec_decoder.state_dict(),
            "optimizer": sh.optimizer_state(tr.optimizer),
            "scheduler": tr.scheduler.state_dict(), "epoch": epoch,
            "generator": tr.generator.get_state()}


def resume(tr: Trainer, ckpt: CheckpointManager, which: str) -> int:
    """Restore epoch `which`'s checkpoint (the latest when it is not a
    number) -> the epoch to start from."""
    state = ckpt.restore(int(which) if which.isdigit() else None)
    assign_state(tr.models.sec_encoder, state["sec_encoder"],
                 what="sec_encoder")
    assign_state(tr.models.sec_decoder, state["sec_decoder"],
                 what="sec_decoder")
    tr.optimizer.load_state_dict(state["optimizer"])
    tr.scheduler.load_state_dict(state["scheduler"])
    tr.generator.set_state(state["generator"])
    return int(state["epoch"]) + 1


@torch.no_grad()
def render_sample(tr: Trainer, image) -> torch.Tensor:
    """One watermarked image of `image` [1, H, W, 3] with a fresh message
    and posterior noise (`_render_sample`, `latent_wm_pretrain.py:
    345-356`) -> [1, H, W, 3] in the VAE's range."""
    m = tr.models
    x = torch.as_tensor(image, device=tr.generator.device).permute(0, 3, 1, 2)
    d = draw(m, tr.generator, tuple(x.shape), EARLY_PROBS)
    latents = m.vae.sample_from_moments(*m.vae.encode_moments(x),
                                        d.vae_noise)
    with m.autocast():
        wm_latents, _ = m.sec_encoder(latents, d.msg)
    return m.vae.decode(wm_latents.to(latents.dtype)).permute(0, 2, 3, 1)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train and write `<output_dir>/pretrained_latentwm.pt`; -> {"history":
    logged metrics, "seconds": each step's wall time (to its message loss
    read back), "final_acc", "trainer", "start_epoch"}.  In a world of
    several ranks only rank 0 prints, logs and writes; every rank draws
    (the draws of the global batch) and renders the epoch's sample, which
    keeps the ranks' generators together."""
    tr = build_trainer(args)
    models = tr.models
    main = tr.world.rank == 0
    n = tr.world.size
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
    resumed = args.resume_from_ckpt is not None
    start_epoch = resume(tr, ckpt, args.resume_from_ckpt) if resumed else 0
    tracker = Tracker(args.output_dir if main else None, args.report_to)
    warmup = bool(args.warmup) and not resumed
    fixinit = bool(args.fixinit) and warmup
    msgloss_buf: list = []
    history, seconds = [], []
    step = 0
    acc = float("nan")
    t0 = time.time()
    for epoch in range(start_epoch, start_epoch + args.epochs):
        batches = data_lib.prefetch(tr.dataset.batches(
            args.batch_size, seed=args.seed + epoch, epochs=1,
            part=(tr.world.rank, n)))
        try:
            t1 = time.perf_counter()
            for images, _ in batches:
                ctl = curriculum(epoch - start_epoch, warmup, fixinit,
                                 bool(args.random_aug), resumed)
                d = tr.draw(args.batch_size, images.shape[1:3],
                            ctl.distort_probs)
                metrics = tr.train_step(images, d, ctl)
                ml = float(metrics["msgloss"])
                if args.debug_nans and not math.isfinite(
                        float(metrics["loss"])):
                    raise FloatingPointError(
                        f"step {step + 1}: loss {float(metrics['loss'])} "
                        "(--debug_nans)")
                seconds.append(time.perf_counter() - t1)
                msgloss_buf = (msgloss_buf + [ml])[-10:]
                if (warmup and len(msgloss_buf) == 10
                        and np.mean(msgloss_buf) < 0.1):
                    warmup = fixinit = False
                step += 1
                if step % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    history.append(m)
                    tracker.log({"Loss/train": m["loss"],
                                 "Loss/lpips_loss": m["lpips_loss"],
                                 "Loss/prvl_loss": m["prvl_loss"],
                                 "Loss/msgloss": m["msgloss"]}, step)
                    sh.say(f"epoch {epoch} step {step}: "
                           + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                           f"({(time.time() - t0) / step:.2f}s/step)",
                           flush=True)
                if args.max_train_steps and step >= args.max_train_steps:
                    break
                t1 = time.perf_counter()
        finally:
            batches.close()             # ends the prefetch thread
        # the epoch's sample image, eval on its last batch with fresh noise
        # and bits, and checkpoint (`latent_wm_pretrain.py:283-331`)
        sample = images_to_uint8(render_sample(tr, images[:1]))[0]
        if main:
            img_dir = os.path.join(args.output_dir, "log_images")
            os.makedirs(img_dir, exist_ok=True)
            save_png(os.path.join(img_dir, f"watermarked_{epoch}.png"),
                     sample)
        e = tr.draw(args.batch_size, images.shape[1:3], ctl.distort_probs)
        acc = float(tr.eval_step(images, e.vae_noise, e.msg, tr.group))
        tracker.log({"Accuracy/train": acc}, epoch)
        sh.say(f"epoch {epoch}: eval bit acc {acc:.4f}", flush=True)
        sh.save_checkpoint(ckpt, epoch, lambda: checkpoint_state(tr, epoch))
        if args.max_train_steps and step >= args.max_train_steps:
            break
    if main:
        save_artifact(models, os.path.join(args.output_dir,
                                           "pretrained_latentwm.pt"))
    tracker.close()
    return {"history": history, "seconds": seconds, "final_acc": acc,
            "trainer": tr, "start_epoch": start_epoch}


def _flag(s: str) -> bool:
    return s not in ("0", "False")


def build_argparser() -> argparse.ArgumentParser:
    """Every option of the JAX trainer's parser
    (`latent_wm_pretrain.py:375-413`), with the port's `--device`."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="the frozen VAE from a local diffusers directory")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=5,
                   help="the global batch (under torchrun split over the "
                        "ranks, which must divide it)")
    p.add_argument("--bit_num", type=int, default=48)
    p.add_argument("--resume_from_ckpt", type=str, default=None,
                   help="an epoch saved under <output_dir>/checkpoints, or "
                        "anything else for the latest")
    p.add_argument("--dataset", type=str, default=None,
                   help="a folder of JPEG and PNG files; synthetic images "
                        "without it")
    p.add_argument("--output_dir", default="checkpoints")
    p.add_argument("--warmup", type=_flag, default=True)
    p.add_argument("--fixinit", type=_flag, default=True)
    p.add_argument("--random_aug", type=_flag, default=True)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true",
                   help="the tiny test configuration at 64 px")
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--report_to", type=str, default="none",
                   choices=["tensorboard", "wandb", "all", "none"],
                   help="none by default (JAX: tensorboard), as before this "
                        "flag was ported: importing TensorBoard pulls in "
                        "TensorFlow where it is installed")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise on a non-finite loss")
    p.add_argument("--remat_lpips", action="store_true",
                   help="recompute the LPIPS call in the backward")
    p.add_argument("--fsdp", action="store_true",
                   help="under torchrun (world size above 1): shard the "
                        "frozen VAE and LPIPS (FSDP2) and the optimizer "
                        "moments (ZeRO-1) over the ranks")
    p.add_argument("--remat_vae_decode", action="store_true",
                   help="recompute the watermarked VAE decode in the "
                        "backward")
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["no", "bf16"],
                   help="bf16: every module computes in bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main():
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
