"""Stage 2, PPFT (prior-preserving fine-tuning), in PyTorch.

The port of `aqualora_tpu/train/ppft_train.py:56-497`.  The rank-R message
LoRA on all 192 U-Net sites and the MapperNet are trained so that the U-Net
with the watermark in its input and the LoRA on predicts what the clean
model predicts on the clean input:

    teacher = unet(add_noise(z, eps, t),         scale=None)   [no grad]
    student = unet(add_noise(z + wm(msg), eps, t), scale=mapper(msg))
    loss    = mean((student - teacher)^2)

One step runs three of the port's kernels besides the attention forward:
the flash-attention backward (dQ and dK/dV, under the student's gradient)
and the fused secret injection (`ops/secret_inject.py`).

The update reproduces the JAX trainer's optax chain, three places where a
port drifts unnoticed:

- clipping by global norm on the LoRA group only, with optax's rule
  `g * max / |g|` when |g| >= max (not `clip_grad_norm_`, which adds 1e-6
  to the norm); `grad_norm` is the norm of all gradients before clipping;
- `torch.optim.AdamW`, whose algebra equals `optax.adamw`: both decay the
  weight decoupled from the moments, p <- p - lr * (m_hat / (sqrt(v_hat) +
  eps) + wd * p), with the bias-corrected moments of the same step;
- the learning-rate schedule as a `LambdaLR` factor: optax evaluates the
  schedule at the update count before the update, so update k uses
  factor(k), which is what stepping the scheduler after the optimizer
  gives.

With `--mixed_precision bf16` the frozen U-Net base, VAE and CLIP are
stored in bfloat16 and the trainables (LoRA, MapperNet) in float32 (the
pipeline's rule under any compute type), which is the JAX trainer's
per-call cast done once.  The frozen SecretEncoder and
the SecretDecoder keep float32 parameters, as the JAX trainer's do: the
injection computes in float32 from them and returns the latent's type.

Loading (`run`, `ppft_train.py:276-345` of the JAX package):
`--pretrained_model_name_or_path` reads a local diffusers directory (unet,
vae, text_encoder safetensors; the LoRA stays at its init);
`--start_from_pretrain` reads stage 1's `pretrained_latentwm.pt` (this
port's own torch file, where the JAX trainer reads its orbax tree): the
SecretEncoder, and the SecretDecoder with its BatchNorm statistics;
`--resume_from_lora` reads `pytorch_lora_weights.safetensors` (and its
`text_encoder.` keys with `--train_text_encoder`) and `mapper.safetensors`
from a directory.

Saving (`save_artifacts`, `:547-562`): with `--output_dir`, the end of the
run writes `pytorch_lora_weights.safetensors` (the reference's key layout,
the text-encoder LoRA's keys too when it is trained),
`mapper.safetensors` (`bit_embeddings.weight`, float32) and the decoder as
`msgdecoder.pt`, a torch state dict (the JAX trainer writes an orbax
directory `msgdecoder`).  Without `--output_dir` nothing is written.  With
`--validation_prompt` too, the final sanity inference reads the two
safetensors back from disk, generates `--num_validation_images` images
with DPM-Solver++(2M) and prints the decoded bit accuracy.

Run on the card (the default) or on the CPU:

    python -m aqualora_torch.train.ppft_train --rank 320 --resolution 512 \\
        --train_batch_size 8 --mixed_precision bf16 --max_train_steps 4 \\
        --start_from_pretrain s1/pretrained_latentwm.pt --output_dir out
    python -m aqualora_torch.train.ppft_train --tiny --max_train_steps 2 \\
        --train_batch_size 2 --device cpu --output_dir /tmp/ppft \\
        --validation_prompt "a photo"

Data (`ppft_train.py:346-378`): `--train_data_dir` trains on a folder of
JPEG and PNG files with `metadata.jsonl` captions (`train/data.py`,
decoded by the port itself: no PIL, no libjpeg), with
`--max_train_samples`, `--center_crop`, `--random_flip`,
`--caption_column` and `--dataloader_num_workers` (decoder threads, 0:
the host's count); without it, synthetic images.  Batches are decoded a
step ahead on a background thread (`data.prefetch`).  `--cache_latents`
encodes every sample once to VAE posterior moments (float16 on the host)
and the step samples the posterior from them in the pipeline's type,
without the VAE encoder (refused with `--random_flip`).  `--dataset_name`
and `--dataset_config_name` (the HF datasets path) are refused.

Checkpoints and the tracker (`ppft_train.py:434-501`), with
`--output_dir`: every `--checkpointing_steps` the LoRA and mapper, the
optimizer, the schedule, the step and the step generator's state go to
`<output_dir>/checkpoints/<step>.pt` (`core/checkpoint.py`; at most
`--checkpoints_total_limit` kept), with the text-encoder LoRA and the
gradient accumulator (its running mean and micro-step) when there are;
the 8-bit moments are the optimizer's state.  `--resume_from_checkpoint`
("latest" or a step) restores them and replays the skipped steps' batches
and draws, so the resumed run sees the draws of an uninterrupted one, in
the middle of an accumulation window too.  `--report_to`
adds TensorBoard or wandb logs under `<output_dir>/logs` where installed
(`utils/logging.py`); the scalars are printed in any case.

The trainer's other options (`ppft_train.py:87-274,380-420,480-519,565-613`
of the JAX package):

- `--validation_epochs` (1) and `--validation_steps` (0): every so many
  epochs and steps, `validate` generates `--num_validation_images` images
  of `--validation_prompt` ("a photo" without one) with random messages,
  DPM-Solver++(2M) at `--validation_resolution` and
  `--validation_num_inference_steps` (the sanity inference's values by
  default), through the current LoRA (and text-encoder LoRA), decodes them
  and logs the images under "validation" and the bit accuracy as
  `validation_accuracy`.  It draws from a generator of its own, seeded
  from the seed and the step, so that a run resumed after a validation
  sees the draws of an uninterrupted one;
- `--gradient_accumulation_steps k`: optax 0.2.6's `MultiSteps`
  (`GradientAccumulator`): the running mean acc + (g - acc) / (n + 1), the
  whole chain (clip, AdamW, block LR) on the mean at the k-th micro-step
  and no update at the others; the schedule advances once per k.  As in
  the JAX loop, the steps count micro-steps: `--max_train_steps`,
  `--checkpointing_steps`, validation's due steps and the cosine's length,
  and the logged `grad_norm` is the micro-batch's;
- `--use_8bit_adam`: `train/adamw8bit.py` for both groups;
- `--down_lr_weight`, `--mid_lr_weight`, `--up_lr_weight`,
  `--block_lr_zero_threshold`: kohya's block-wise LR (`train/block_lr.py`)
  on the U-Net LoRA, as one parameter group per weight;
- `--lora_dropout`, `--module_dropout` (`models/lora.py`, on every LoRA
  site, the text encoder's included when it is trained) and
  `--rank_dropout` (folded into the diagonal scale); their numbers are
  part of the step's `Draws`;
- `--train_text_encoder`: a rank `--rank` LoRA on CLIP's 72 sites (12
  layers: q, k, v, out, fc1, fc2), clipped and updated with the U-Net LoRA;
  the context is computed once through it and fed to the teacher and the
  student; saved into the same safetensors under `text_encoder.` and read
  back by `--resume_from_lora` and the sanity inference;
- `--teacher_skip_lora 0`: the teacher runs the 192 LoRA sites at a zero
  diagonal, which gives the skipping teacher's output exactly;
- `--gradient_checkpointing`: the U-Net's transformer blocks under
  `torch.utils.checkpoint` (`models/layers.py`); the student's 32
  attention forwards run again in the backward;
- `--scale_lr` (times accumulation x batch; one process), `--debug_nans`
  (raises on a non-finite loss or gradient norm), `--attention_impl auto`
  or `flash` (the port's kernels; `sdpa` and `xla` are refused: the port
  has one attention path); `--mixed_precision fp16` computes in float32,
  as JAX does;
- inert, as in JAX: `--lr_scheduler`, `--lr_power`, `--local_rank`,
  `--allow_tf32`, `--enable_xformers_memory_efficient_attention`,
  `--logging_dir`.

Refused by name: `--teacher_int8` and `--int8_gen` (ROADMAP A.8, the w8a8
port), `--fsdp` (A.9, the mesh), `--dataset_name` and
`--dataset_config_name` (the HF datasets path).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from aqualora_torch.core.checkpoint import CheckpointManager
from aqualora_torch.core.config import (EfficientNetConfig, LoRAConfig,
                                        PipelineConfig, WatermarkConfig)
from aqualora_torch.core.io import (LORA_FILE, MAPPER_FILE, assign_state,
                                    export_lora_safetensors,
                                    export_te_lora_safetensors,
                                    load_safetensors, save_safetensors)
from aqualora_torch.core.tokenizer import load_tokenizer
from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                               init_module_weights)
from aqualora_torch.eval.utils_eval import decode_bits
from aqualora_torch.models.lora import SiteDraws, lora_dropout
from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
from aqualora_torch.ops.secret_inject import inject_from_params
from aqualora_torch.train import block_lr
from aqualora_torch.train import data as data_lib
from aqualora_torch.train.adamw8bit import AdamW8bit
from aqualora_torch.utils.logging import Tracker

MSGDECODER_FILE = "msgdecoder.pt"


# ---------------------------------------------------------------------------
# parameters and schedule
# ---------------------------------------------------------------------------

def split_lora(module: nn.Module
               ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """-> (base, lora) named parameters, by a `lora` component in the
    name (the JAX `split_lora` over the flattened tree)."""
    base, lora = {}, {}
    for name, p in module.named_parameters():
        (lora if "lora" in name.split(".") else base)[name] = p
    return base, lora


def cosine_with_warmup_lr_end(base_lr: float, warmup: int, total: int,
                              lr_end: float, num_cycles: float = 0.5):
    """The reference's schedule (`utils/misc.py:23-33`); `lr_end` is a
    fraction of the base LR."""

    def fn(step: int) -> float:
        warm = step / max(1.0, warmup)
        progress = (step - warmup) / max(1.0, total - warmup)
        cos = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * (warm if step < warmup else max(lr_end, cos))

    return fn


def trainable_groups(pipe: StableDiffusionPipeline) -> Dict[str, List]:
    """Make the U-Net's LoRA weights, the MapperNet and the text encoder's
    LoRA, when the CLIP carries one, trainable (the pipeline keeps them
    float32); -> {"lora": [...], "mapper": [...], "te_lora": [...]}."""
    groups = {"lora": list(split_lora(pipe.unet)[1].values()),
              "mapper": list(pipe.mapper.parameters())}
    te = split_lora(pipe.clip)[1]
    if te:
        groups["te_lora"] = list(te.values())
    for params in groups.values():
        for p in params:
            p.requires_grad_(True)
    return groups


def adamw(groups: Dict[str, List], lr: float,
          factor: Callable[[int], float],
          betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2, eight_bit: bool = False,
          lr_weights: Optional[Dict[int, float]] = None):
    """`optax.adamw` (`AdamW8bit` with `eight_bit`) over named parameter
    groups with the learning rate lr * factor(update count), as
    (optimizer, scheduler): step the scheduler after the optimizer (see
    the module docstring for why this is optax's algebra).  `lr_weights`
    ({id(parameter): w}, block-wise LR) splits the "lora" group into one
    group per weight at lr * w."""
    param_groups = []
    for name, params in groups.items():
        by_weight: Dict[float, List] = {}
        for p in params:
            w = (lr_weights.get(id(p), 1.0)
                 if lr_weights and name == "lora" else 1.0)
            by_weight.setdefault(w, []).append(p)
        param_groups += [{"params": ps, "name": name, "lr": lr * w}
                         for w, ps in by_weight.items()]
    cls = AdamW8bit if eight_bit else torch.optim.AdamW
    optimizer = cls(param_groups, lr=lr, betas=betas, eps=eps,
                    weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler


def make_optimizer(groups: Dict[str, List], lr: float, warmup: int,
                   total: int, lr_end: float = 0.0,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, weight_decay: float = 1e-2,
                   eight_bit: bool = False,
                   lr_weights: Optional[Dict[int, float]] = None):
    """AdamW (or 8-bit AdamW) over the LoRA and mapper groups with the
    reference's cosine schedule."""
    return adamw(groups, lr,
                 cosine_with_warmup_lr_end(1.0, warmup, total, lr_end),
                 betas, eps, weight_decay, eight_bit, lr_weights)


def _global_norm(params) -> torch.Tensor:
    grads = [p.grad.float() for p in params if p.grad is not None]
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class GradientAccumulator:
    """`optax.MultiSteps(k)` (optax 0.2.6) around the update: `add()` folds
    the parameters' gradients into the running mean acc + (g - acc) / (n +
    1); at the k-th micro-step it puts the mean into `.grad`, restarts and
    returns True (the caller then clips and steps), else False (no update,
    the schedule does not advance)."""

    def __init__(self, params: List[torch.Tensor], k: int):
        self.params, self.k = params, k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params]

    def add(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(self.acc, diff)
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.acc = [torch.zeros_like(a) for a in self.acc]
        self.mini_step = 0
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.mini_step = int(state["mini_step"])
        with torch.no_grad():
            for a, v in zip(self.acc, state["acc"]):
                a.copy_(v)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Draws:
    """One step's random numbers (NCHW): message bits [B, bits] float32,
    the VAE posterior noise and the diffusion noise [B, C, h, w], the
    timesteps [B] int64; with the kohya dropouts on, the rank-dropout
    mask [B, rank] and the U-Net's and the text encoder's `SiteDraws`."""

    msg: torch.Tensor
    vae_noise: torch.Tensor
    noise: torch.Tensor
    t: torch.Tensor
    rank_mask: Optional[torch.Tensor] = None
    unet_sites: Optional[SiteDraws] = None
    te_sites: Optional[SiteDraws] = None


def draw_sites(lora: Optional[LoRAConfig], n: int,
               generator: torch.Generator) -> Optional[SiteDraws]:
    """The dropout numbers of `n` LoRA sites under `lora`: each site's
    keep flag (Bernoulli(1 - module_dropout)) and the seed of its
    elementwise mask (read back to the host: one synchronisation a step
    with `--lora_dropout`); None when both dropouts are off."""
    if lora is None or not lora.enabled or (lora.dropout <= 0
                                             and lora.module_dropout <= 0):
        return None
    dev = generator.device
    keep = (torch.rand(n, generator=generator, device=dev)
            < 1.0 - lora.module_dropout if lora.module_dropout > 0 else None)
    seeds = (torch.randint(0, 2 ** 62, (n,), generator=generator,
                           device=dev).tolist() if lora.dropout > 0 else None)
    return SiteDraws(keep, seeds)


def draw(pipe: StableDiffusionPipeline, generator: torch.Generator,
         pixels, cached: bool = False, rank_dropout: float = 0.0) -> Draws:
    """A step's `Draws` for a batch of NHWC `pixels` (with `cached`, of
    cached moments [B, h, w, 2C]), from `generator` (on the pipeline's
    device); the dropouts' numbers after the rest, when they are on."""
    cfg, dev = pipe.config, pipe.device
    b, h, w = pixels.shape[:3]
    down = 1 if cached else cfg.vae.downscale
    lat = (b, cfg.vae.latent_channels, h // down, w // down)
    msg = torch.bernoulli(torch.full((b, cfg.watermark.msg_bits), 0.5,
                                     device=dev), generator=generator)
    vae_noise = torch.randn(lat, generator=generator, device=dev,
                            dtype=pipe.vae.quant_conv.weight.dtype)
    noise = torch.randn(lat, generator=generator, device=dev)
    t = torch.randint(0, cfg.schedule.num_train_timesteps, (b,),
                      generator=generator, device=dev)
    rank_mask = (torch.rand((b, cfg.watermark.lora_rank),
                            generator=generator, device=dev)
                 < 1.0 - rank_dropout if rank_dropout > 0 else None)
    return Draws(msg, vae_noise, noise, t, rank_mask,
                 draw_sites(cfg.unet.lora, pipe.unet.num_sites, generator),
                 draw_sites(cfg.clip.lora, pipe.clip.num_sites, generator))


def make_loss_fn(pipe: StableDiffusionPipeline, sec_encoder: SecretEncoder,
                 cache_latents: bool = False,
                 train_text_encoder: bool = False, rank_dropout: float = 0.0,
                 teacher_skip_lora: bool = True):
    """The PPFT objective (`make_loss_fn`, `ppft_train.py:87-205`) ->
    loss_fn(pixels NHWC, input_ids, draws) -> (loss, metrics).  The draws
    are an argument, so a test can hand it the JAX trainer's.

    With `cache_latents`, `pixels` are cached posterior moments [B, h, w,
    2C] (`data.CachedMomentsDataset`): cast to the pipeline's type before
    the posterior sample, as JAX casts them (`:117-123`), since a float32
    latent would promote the whole U-Net to float32.  `rank_dropout`
    folds the draws' rank mask into the diagonal (`:112-115`);
    `train_text_encoder` computes the context once through the CLIP LoRA
    at scale 1.0, with its dropouts, and feeds it to both passes
    (`:145-158`); `teacher_skip_lora=False` runs the teacher at a zero
    diagonal (`:171`).  The student's LoRA dropouts act under the draws'
    `unet_sites`; the teacher has none."""
    sched, cfg = pipe.schedule, pipe.config
    v_pred = cfg.unet.prediction_type == "v_prediction"
    scaling = cfg.vae.scaling_factor
    grid = cfg.watermark.secret_grid

    def loss_fn(pixels, input_ids, draws: Draws):
        x = torch.as_tensor(pixels, device=pipe.device).permute(0, 3, 1, 2)
        diag = pipe.mapper(draws.msg)
        if rank_dropout > 0:
            diag = block_lr.rank_dropout_scale(diag, draws.rank_mask,
                                               rank_dropout)
        with torch.no_grad():
            if cache_latents:
                moments = x.to(pipe.vae.quant_conv.weight.dtype).chunk(2, 1)
            else:
                moments = pipe.vae.encode_moments(x)
            latents = pipe.vae.sample_from_moments(*moments, draws.vae_noise)
            if latents.shape[2] == latents.shape[3] == 2 * grid:
                injected = inject_from_params(
                    dict(sec_encoder.named_parameters()), latents, draws.msg,
                    grid)
            else:
                injected, _ = sec_encoder(latents, draws.msg)
            noisy_clean = sched.add_noise(latents * scaling, draws.noise,
                                          draws.t)
            noisy_wm = sched.add_noise(injected * scaling, draws.noise,
                                       draws.t)
            if not train_text_encoder:
                ctx = pipe.clip(pipe._ids(input_ids))
        if train_text_encoder:
            with lora_dropout(draws.te_sites):
                ctx = pipe.clip(pipe._ids(input_ids), 1.0)
        with torch.no_grad():
            # scale=None skips the LoRA branches: exactly the reference's
            # scale=0 teacher without the rank-R products
            teacher = pipe.unet(noisy_clean, draws.t, ctx,
                                None if teacher_skip_lora
                                else torch.zeros_like(diag))
        with lora_dropout(draws.unet_sites):
            student = pipe.unet(noisy_wm, draws.t, ctx, diag)
        if v_pred:
            student = sched.velocity_to_epsilon(student, noisy_wm, draws.t)
            teacher = sched.velocity_to_epsilon(teacher, noisy_clean, draws.t)
        loss = torch.mean((student.float() - teacher.float()) ** 2)
        return loss, {"ppft_loss": loss.detach()}

    return loss_fn


def make_update(optimizer: torch.optim.Optimizer, scheduler,
                max_grad_norm: float = 1.0,
                accumulator: Optional[GradientAccumulator] = None):
    """-> update(): the JAX trainer's chain on the parameters' `.grad`
    (`ppft_train.py:398-420`): the accumulator's window (no update before
    its k-th micro-step), then the LoRA groups (U-Net and text encoder)
    clipped together by global norm, then the optimizer (its groups'
    learning rates carry the block weights) and the schedule."""
    clipped = [p for g in optimizer.param_groups if g["name"] != "mapper"
               for p in g["params"]]

    @torch.no_grad()
    def update() -> None:
        if accumulator is not None and not accumulator.add():
            return
        norm = _global_norm(clipped)
        factor = torch.where(norm < max_grad_norm,
                             torch.ones_like(norm), max_grad_norm / norm)
        for p in clipped:
            if p.grad is not None:
                p.grad.mul_(factor)
        optimizer.step()
        scheduler.step()

    return update


def make_train_step(pipe: StableDiffusionPipeline, sec_encoder: SecretEncoder,
                    optimizer: torch.optim.Optimizer, scheduler,
                    max_grad_norm: float = 1.0, cache_latents: bool = False,
                    accumulator: Optional[GradientAccumulator] = None,
                    **loss_options):
    """-> train_step(pixels NHWC, input_ids, draws) -> metrics: one
    micro-step, an update of the groups of `optimizer` (see
    `make_optimizer`) unless `accumulator` holds it back.  The LoRA groups
    (U-Net and text encoder) are clipped together, the mapper is not.
    `loss_options` go to `make_loss_fn`."""
    loss_fn = make_loss_fn(pipe, sec_encoder, cache_latents, **loss_options)
    update = make_update(optimizer, scheduler, max_grad_norm, accumulator)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(pixels, input_ids, draws: Draws) -> Dict[str, Any]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(pixels, input_ids, draws)
        loss.backward()
        with torch.no_grad():
            metrics["grad_norm"] = _global_norm(params)
        update()
        return metrics

    return train_step


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def build_configs(args) -> Tuple[PipelineConfig, EfficientNetConfig, int]:
    """-> (pipeline config, SecretDecoder backbone, pixel resolution);
    `--tiny` ignores `--resolution`, as in the JAX trainer.  Remat, the
    text-encoder LoRA at `--rank` and the kohya dropouts (on the CLIP LoRA
    too when it is trained) as `build_configs`, `ppft_train.py:240-273`."""
    rep_ = dataclasses.replace
    if args.tiny:
        cfg = PipelineConfig.tiny()
        if args.mapper_std != 1.0:
            cfg = rep_(cfg, watermark=rep_(cfg.watermark,
                                           mapper_std=args.mapper_std))
        backbone, res = EfficientNetConfig.tiny(), 64
    else:
        cfg = PipelineConfig.sd15(args.rank)
        cfg = rep_(cfg, watermark=WatermarkConfig(
            msg_bits=args.msg_bits, lora_rank=args.rank,
            mapper_std=args.mapper_std))
        backbone, res = EfficientNetConfig.b1(), args.resolution
    if args.gradient_checkpointing:
        cfg = rep_(cfg, unet=rep_(cfg.unet, remat=True))
    if args.train_text_encoder:
        cfg = rep_(cfg, clip=cfg.clip.with_lora(args.rank))
    md, ld = args.module_dropout or 0.0, args.lora_dropout or 0.0
    if md > 0.0 or ld > 0.0:
        cfg = rep_(cfg, unet=rep_(cfg.unet, lora=rep_(
            cfg.unet.lora, module_dropout=md, dropout=ld)))
        if cfg.clip.lora and cfg.clip.lora.enabled:
            cfg = rep_(cfg, clip=rep_(cfg.clip, lora=rep_(
                cfg.clip.lora, module_dropout=md, dropout=ld)))
    return cfg, backbone, res


@torch.no_grad()
def init_lora(module: nn.Module, generator: torch.Generator) -> None:
    """The LoRA init of the JAX layers: down N(0, (1/rank)^2), up zero."""
    for name, p in split_lora(module)[1].items():
        if name.endswith("up.weight"):
            p.zero_()
        else:
            rank = p.shape[0]
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) / rank)


@dataclasses.dataclass
class Trainer:
    """What `run` builds: the pipeline, the SecretEncoder and SecretDecoder,
    the trainable groups, the LR schedule and the step, the data (a
    prefetching iterator of (pixels or cached moments, captions), which
    outlives `run` for a caller that takes more steps; `close()` ends its
    thread) and the step's generator; `cached` with `--cache_latents`, the
    micro-steps of an epoch, the gradient accumulator with
    `--gradient_accumulation_steps` above 1, `--rank_dropout` and the
    seed."""

    pipe: StableDiffusionPipeline
    sec_encoder: SecretEncoder
    msgdecoder: SecretDecoder
    groups: Dict[str, List]
    scheduler: Any
    train_step: Any
    batches: Any
    tokenizer: Any
    generator: torch.Generator
    max_steps: int
    cached: bool = False
    steps_per_epoch: int = 1
    accumulator: Optional[GradientAccumulator] = None
    rank_dropout: float = 0.0
    seed: int = 0


def _load_sd_checkpoint(path: str, pipe: StableDiffusionPipeline) -> None:
    """Load a local diffusers-layout SD checkpoint directory into the
    pipeline (`_load_sd_checkpoint`, `ppft_train.py:661-688`): the unet,
    vae and text_encoder safetensors, strictly; the U-Net's LoRA keeps its
    values.  The CLIP keys lose `text_model.`, `embeddings.` and `encoder.`,
    and `position_ids` is dropped, as in JAX."""
    subdirs = (("unet", pipe.unet, "unet/diffusion_pytorch_model.safetensors"),
               ("vae", pipe.vae, "vae/diffusion_pytorch_model.safetensors"),
               ("text_encoder", pipe.clip, "text_encoder/model.safetensors"))
    for name, module, sub in subdirs:
        p = os.path.join(path, sub)
        if not os.path.isfile(p):
            raise FileNotFoundError(f"missing {p}")
        state = load_safetensors(p)
        if name == "text_encoder":
            state = {k[len("text_model."):] if k.startswith("text_model.")
                     else k: v for k, v in state.items()}
            state = {k.replace("embeddings.", "").replace("encoder.", ""): v
                     for k, v in state.items() if "position_ids" not in k}
        skip = split_lora(module)[1] if name != "vae" else ()
        assign_state(module, state, skip=skip, what=name)


def load_pretrain(path: str, sec_encoder: SecretEncoder,
                  msgdecoder: SecretDecoder) -> None:
    """`--start_from_pretrain`: stage 1's `pretrained_latentwm.pt` (the
    port's torch file) into the SecretEncoder and the SecretDecoder, its
    BatchNorm statistics included, strictly."""
    art = torch.load(path, map_location="cpu", weights_only=True)
    assign_state(sec_encoder, art["sec_encoder"], what="sec_encoder")
    assign_state(msgdecoder, art["sec_decoder"], what="sec_decoder")


UNPORTED = {
    "--teacher_int8": "ROADMAP A.8, the w8a8 port",
    "--int8_gen": "ROADMAP A.8, the w8a8 port",
    "--fsdp": "ROADMAP A.9, the mesh",
    "--dataset_name": "the HF datasets path: no `datasets` package, no "
                      "download; pass a folder with --train_data_dir",
    "--dataset_config_name": "the HF datasets path: no `datasets` package, "
                             "no download; pass a folder with "
                             "--train_data_dir"}


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError naming every flag of `UNPORTED` that is
    set, and ValueError for an attention implementation the port does not
    have."""
    asked = [f for f in UNPORTED
             if getattr(args, f[2:]) not in (None, False)]
    if asked:
        raise NotImplementedError("; ".join(
            f"{f}: not ported to aqualora_torch ({UNPORTED[f]})"
            for f in asked))
    if args.attention_impl not in ("auto", "flash"):
        raise ValueError(
            f"--attention_impl {args.attention_impl}: the port has one "
            "attention path, the flash-attention kernels of "
            "aqualora_torch/ops/flash_attention.py (auto and flash take "
            "it); it has no library fallback")


def build_trainer(args: argparse.Namespace) -> Trainer:
    refuse_unported(args)
    device = torch.device(args.device)
    seed = args.seed or 0
    torch.manual_seed(seed)
    cfg, backbone, resolution = build_configs(args)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    pipe = StableDiffusionPipeline(cfg, dtype=dtype, device=device)
    pipe.init_params(seed)
    if args.pretrained_model_name_or_path:
        _load_sd_checkpoint(args.pretrained_model_name_or_path, pipe)
    groups = trainable_groups(pipe)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_lora(pipe.unet, gen)
    init_lora(pipe.clip, gen)
    pipe.mapper.reset_parameters()
    latent_res = resolution // cfg.vae.downscale
    with device:
        sec_encoder = SecretEncoder(cfg.watermark.msg_bits,
                                    cfg.watermark.secret_grid, latent_res,
                                    cfg.vae.latent_channels)
    init_module_weights(sec_encoder.secret_dense, gen)
    # float32 parameters under either training type, as the JAX trainer's
    sec_encoder.eval().requires_grad_(False)
    msgdecoder = SecretDecoder(cfg.watermark.msg_bits, backbone,
                               device=device)
    init_module_weights(msgdecoder, gen)
    msgdecoder.eval().requires_grad_(False)
    if args.start_from_pretrain:
        load_pretrain(args.start_from_pretrain, sec_encoder, msgdecoder)
    if args.resume_from_lora:
        pipe.load_watermark_lora(args.resume_from_lora)

    dataset = data_lib.make_dataset(
        args.train_data_dir, resolution, dataset_name=args.dataset_name,
        max_samples=args.max_train_samples, center_crop=args.center_crop,
        random_flip=args.random_flip, caption_column=args.caption_column,
        image_column=args.image_column,
        num_threads=args.dataloader_num_workers)
    steps_per_epoch = max(1, len(dataset) // args.train_batch_size)
    if args.cache_latents:
        dataset = build_latent_cache(args, pipe, dataset, seed)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    k = args.gradient_accumulation_steps
    lr = args.learning_rate
    if args.scale_lr:               # one process: accumulation x batch
        lr *= k * args.train_batch_size
    weights = block_lr.lr_weights(
        split_lora(pipe.unet)[1].items(), args.down_lr_weight,
        args.mid_lr_weight, args.up_lr_weight, args.block_lr_zero_threshold)
    optimizer, scheduler = make_optimizer(
        groups, lr, args.lr_warmup_steps, max_steps, args.lr_end,
        (args.adam_beta1, args.adam_beta2), args.adam_epsilon,
        args.adam_weight_decay, args.use_8bit_adam, weights)
    accumulator = (GradientAccumulator(
        [p for g in optimizer.param_groups for p in g["params"]], k)
        if k > 1 else None)
    step = make_train_step(pipe, sec_encoder, optimizer, scheduler,
                           args.max_grad_norm, args.cache_latents,
                           accumulator,
                           train_text_encoder=args.train_text_encoder,
                           rank_dropout=args.rank_dropout,
                           teacher_skip_lora=args.teacher_skip_lora != 0)
    return Trainer(pipe, sec_encoder, msgdecoder, groups, scheduler, step,
                   data_lib.prefetch(dataset.batches(args.train_batch_size,
                                                     seed=seed)),
                   load_tokenizer(args.tokenizer_vocab,
                                  vocab_size=cfg.clip.vocab_size),
                   torch.Generator(device=device).manual_seed(seed + 1),
                   max_steps, args.cache_latents, steps_per_epoch,
                   accumulator, args.rank_dropout, seed)


def build_latent_cache(args: argparse.Namespace,
                       pipe: StableDiffusionPipeline, dataset,
                       seed: int) -> data_lib.CachedMomentsDataset:
    """`--cache_latents` (`ppft_train.py:357-378`): every sample's VAE
    posterior moments, encoded once at the training batch size in the
    pipeline's type and kept as float16 on the host."""
    if args.random_flip:
        raise ValueError("--cache_latents cannot be combined with "
                         "--random_flip (the cache is per-sample; kohya "
                         "imposes the same restriction)")

    @torch.no_grad()
    def encode(pixels):
        x = torch.as_tensor(pixels, device=pipe.device).permute(0, 3, 1, 2)
        moments = torch.cat(pipe.vae.encode_moments(x), 1)
        return moments.permute(0, 2, 3, 1).float().cpu().numpy()

    t0 = time.perf_counter()
    cache = data_lib.CachedMomentsDataset.build(
        dataset, encode, args.train_batch_size, seed=seed)
    print(f"cached VAE moments for {len(cache)} samples "
          f"({cache.moments.nbytes / 1e6:.1f} MB host, "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return cache


def save_artifacts(output_dir: str, pipe: StableDiffusionPipeline,
                   msgdecoder: SecretDecoder) -> None:
    """The run's artifacts (`save_artifacts`, `ppft_train.py:547-562`):
    the U-Net LoRA in the reference's layout, with the text-encoder LoRA's
    keys when the CLIP carries one, the MapperNet's
    `bit_embeddings.weight` in float32, and the decoder as a torch state
    dict (`msgdecoder.pt`; the JAX trainer writes an orbax directory)."""
    os.makedirs(output_dir, exist_ok=True)
    state = export_lora_safetensors(pipe.unet, pipe.config.unet)
    if split_lora(pipe.clip)[1]:
        state.update(export_te_lora_safetensors(pipe.clip, pipe.config.clip))
    save_safetensors(state, os.path.join(output_dir, LORA_FILE))
    save_safetensors({"bit_embeddings.weight":
                      pipe.mapper.bit_embeddings.weight.detach().float()},
                     os.path.join(output_dir, MAPPER_FILE))
    torch.save({k: v.cpu() for k, v in msgdecoder.state_dict().items()},
               os.path.join(output_dir, MSGDECODER_FILE))


def final_sanity_inference(tr: Trainer, args: argparse.Namespace,
                           generator: torch.Generator,
                           tracker: Tracker | None = None) -> float:
    """End-of-training sanity inference (`final_sanity_inference`,
    `ppft_train.py:616-658`): read the saved LoRA and mapper back from
    `--output_dir` into the pipeline, generate `--num_validation_images`
    images of `--validation_prompt` with DPM-Solver++(2M) (2 steps at 64 px
    with `--tiny`, else 25 at `--resolution`) with a random message at LoRA
    multiplier 1, decode them and return the bit accuracy."""
    pipe = tr.pipe
    pipe.load_watermark_lora(args.output_dir)
    res = 64 if args.tiny else args.resolution
    steps = 2 if args.tiny else 25
    gen = pipe.make_generate(num_steps=steps, sampler="dpms_m", height=res,
                             width=res)
    n = args.num_validation_images
    msg = torch.bernoulli(torch.full((n, pipe.config.watermark.msg_bits), 0.5,
                                     device=pipe.device), generator=generator)
    diag = pipe.message_scale(msg, multiplier=1.0)
    images = gen(tr.tokenizer([args.validation_prompt] * n),
                 tr.tokenizer([""] * n), 7.5, diag, generator=generator)
    if tracker is not None:
        tracker.log_images("test", images.float().cpu().numpy(), 0)
    bits, _ = decode_bits(tr.msgdecoder, images)
    return float((bits == msg.long()).float().mean())


@torch.no_grad()
def validate(tr: Trainer, args: argparse.Namespace, step: int,
             tracker: Tracker | None = None) -> float:
    """Periodic validation (`validate`, `ppft_train.py:565-613`): generate
    `--num_validation_images` (at least 1) images of `--validation_prompt`
    ("a photo" without one) with random messages at LoRA multiplier 1,
    DPM-Solver++(2M) at `--validation_resolution` and
    `--validation_num_inference_steps` (64 px and 2 steps with `--tiny`,
    else `--resolution` and 25), through the current LoRAs; log the images
    under "validation"; -> the decoded bit accuracy.  Its numbers come
    from a generator of its own, seeded from the seed and the step."""
    pipe = tr.pipe
    res = args.validation_resolution or (64 if args.tiny else args.resolution)
    steps = args.validation_num_inference_steps or (2 if args.tiny else 25)
    gen = torch.Generator(device=pipe.device).manual_seed(
        (tr.seed << 32) + step)
    generate = pipe.make_generate(num_steps=steps, sampler="dpms_m",
                                  height=res, width=res)
    n = max(1, args.num_validation_images)
    msg = torch.bernoulli(torch.full((n, pipe.config.watermark.msg_bits), 0.5,
                                     device=pipe.device), generator=gen)
    images = generate(tr.tokenizer([args.validation_prompt or "a photo"] * n),
                      tr.tokenizer([""] * n), 7.5,
                      pipe.message_scale(msg, multiplier=1.0),
                      generator=gen)
    if tracker is not None:
        tracker.log_images("validation", images.float().cpu().numpy(), step)
    bits, _ = decode_bits(tr.msgdecoder, images)
    return float((bits == msg.long()).float().mean())


def checkpoint_state(tr: Trainer, step: int) -> Dict[str, Any]:
    """The state a checkpoint keeps: the trainables, the optimizer, the
    schedule, the step, the step generator's state and, when there are,
    the text-encoder LoRA and the gradient accumulator."""
    state = {"lora": {k: p.detach() for k, p in
                      split_lora(tr.pipe.unet)[1].items()},
             "mapper": tr.pipe.mapper.state_dict(),
             "optimizer": tr.scheduler.optimizer.state_dict(),
             "scheduler": tr.scheduler.state_dict(), "step": step,
             "generator": tr.generator.get_state()}
    te = split_lora(tr.pipe.clip)[1]
    if te:
        state["te_lora"] = {k: p.detach() for k, p in te.items()}
    if tr.accumulator is not None:
        state["accumulator"] = tr.accumulator.state_dict()
    return state


def resume(tr: Trainer, ckpt: CheckpointManager, which: str) -> int:
    """Restore the checkpoint `which` ("latest" or a step), replay the
    skipped steps' batches and draws, and return the step it was saved
    at."""
    state = ckpt.restore(None if which == "latest" else int(which))
    assign_state(tr.pipe.unet, state["lora"],
                 skip=split_lora(tr.pipe.unet)[0], what="lora")
    assign_state(tr.pipe.mapper, state["mapper"], what="mapper")
    if "te_lora" in state:
        assign_state(tr.pipe.clip, state["te_lora"],
                     skip=split_lora(tr.pipe.clip)[0], what="te_lora")
    if tr.accumulator is not None:
        tr.accumulator.load_state_dict(state["accumulator"])
    tr.scheduler.optimizer.load_state_dict(state["optimizer"])
    tr.scheduler.load_state_dict(state["scheduler"])
    start = int(state["step"])
    for _ in range(start):
        pixels, _ = next(tr.batches)
        draw(tr.pipe, tr.generator, pixels, tr.cached, tr.rank_dropout)
    if not torch.equal(tr.generator.get_state(), state["generator"]):
        raise ValueError(f"checkpoint {start}: its draws are not this run's "
                         "(another --seed, --train_batch_size or --tiny?)")
    return start


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train, then save the artifacts and run the sanity inference when
    asked; -> {"history": logged metrics, "seconds": each step's wall time
    (the loss read back when it is logged; a validation is not in it),
    "validation": [{"step", "accuracy", "seconds"}], "trainer",
    "start_step", and "sanity_bit_accuracy" when the sanity inference
    ran}."""
    if args.resume_from_checkpoint and not args.output_dir:
        raise ValueError("--resume_from_checkpoint reads "
                         "<output_dir>/checkpoints: pass --output_dir")
    tr = build_trainer(args)
    ckpt = (CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                              max_to_keep=args.checkpoints_total_limit)
            if args.output_dir else None)
    start = (resume(tr, ckpt, args.resume_from_checkpoint)
             if args.resume_from_checkpoint else 0)
    tracker = Tracker(args.output_dir, args.report_to)
    history, seconds, validations = [], [], []
    t0 = time.time()
    for global_step in range(start + 1, tr.max_steps + 1):
        t1 = time.perf_counter()
        pixels, captions = next(tr.batches)
        ids = tr.tokenizer(captions or [""] * len(pixels))
        draws = draw(tr.pipe, tr.generator, pixels, tr.cached,
                     tr.rank_dropout)
        metrics = tr.train_step(pixels, ids, draws)
        if args.debug_nans and not all(
                math.isfinite(float(metrics[k]))
                for k in ("ppft_loss", "grad_norm")):
            raise FloatingPointError(
                f"step {global_step}: ppft_loss {float(metrics['ppft_loss'])}"
                f", grad_norm {float(metrics['grad_norm'])} (--debug_nans)")
        if global_step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            m["lr"] = tr.scheduler.get_last_lr()[0]     # lr of the next step
            tracker.log(m, global_step)
            print(f"step {global_step}/{tr.max_steps}: "
                  + " ".join(f"{k}={v:.6f}" for k, v in m.items())
                  + f" ({(time.time() - t0) / (global_step - start):.2f}"
                  "s/step)", flush=True)
        if ckpt is not None and global_step % args.checkpointing_steps == 0:
            ckpt.save(global_step, checkpoint_state(tr, global_step))
        seconds.append(time.perf_counter() - t1)
        # in micro-steps, as the JAX loop (`ppft_train.py:504-519`)
        due_epoch = (args.validation_epochs and global_step % (
            tr.steps_per_epoch * args.validation_epochs) == 0)
        due_step = (args.validation_steps
                    and global_step % args.validation_steps == 0)
        if due_epoch or due_step:
            t1 = time.perf_counter()
            acc = validate(tr, args, global_step, tracker)
            validations.append({"step": global_step, "accuracy": acc,
                                "seconds": time.perf_counter() - t1})
            tracker.log({"validation_accuracy": acc}, global_step)
            print(f"epoch {global_step // tr.steps_per_epoch} step "
                  f"{global_step}: validation_accuracy {acc:.4f} "
                  f"({validations[-1]['seconds']:.2f}s)", flush=True)
    out = {"history": history, "seconds": seconds, "trainer": tr,
           "validation": validations, "start_step": start}
    if args.output_dir:
        save_artifacts(args.output_dir, tr.pipe, tr.msgdecoder)
        if args.validation_prompt and args.num_validation_images > 0:
            acc = final_sanity_inference(tr, args, tr.generator, tracker)
            print(f"final sanity inference: bit_accuracy {acc:.4f}",
                  flush=True)
            out["sanity_bit_accuracy"] = acc
    tracker.close()
    return out


def build_argparser() -> argparse.ArgumentParser:
    """Every option of the JAX trainer's parser (`ppft_train.py:697-836`),
    with the port's `--device`; see the module docstring for what each
    does, which are inert and which are refused."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--tiny", action="store_true",
                   help="the tiny test configuration at 64 px")
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--mapper_std", type=float, default=1.0)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--train_data_dir", type=str, default=None,
                   help="a folder of JPEG and PNG files (captions from its "
                        "metadata.jsonl); synthetic images without it")
    p.add_argument("--dataset_name", type=str, default=None,
                   help="the HF datasets path: refused (no `datasets` "
                        "package, no download)")
    p.add_argument("--dataset_config_name", type=str, default=None,
                   help="the HF datasets path: refused")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--image_column", type=str, default="image")
    p.add_argument("--caption_column", type=str, default="text")
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=0,
                   help="decoder threads (0 = the host's count)")
    p.add_argument("--cache_latents", action="store_true",
                   help="encode the dataset to VAE posterior moments once "
                        "and skip the VAE encoder in the step; "
                        "incompatible with --random_flip")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="micro-steps (batches), as every step count here")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="optax.MultiSteps: one update a k micro-steps, on "
                        "their mean gradient")
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--scale_lr", action="store_true",
                   help="lr x accumulation x batch (one process)")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_end", type=float, default=0.0)
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   help="inert, as in JAX and the reference: the schedule "
                        "is always cosine with warmup and lr_end")
    p.add_argument("--lr_power", type=float, default=1.0, help="inert")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="int8 blockwise moments (train/adamw8bit.py)")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["no", "bf16", "fp16"],
                   help="bf16: frozen modules in bfloat16, trainables in "
                        "float32; fp16 computes in float32, as JAX does")
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default=None,
                   help="a local diffusers directory (unet, vae, "
                        "text_encoder safetensors)")
    p.add_argument("--start_from_pretrain", type=str, default=None,
                   help="stage 1's pretrained_latentwm.pt (SecretEncoder "
                        "and SecretDecoder)")
    p.add_argument("--resume_from_lora", type=str, default=None,
                   help="a directory with pytorch_lora_weights.safetensors "
                        "(its text-encoder keys too, when present) and "
                        "mapper.safetensors")
    p.add_argument("--output_dir", type=str, default=None,
                   help="where the LoRA, mapper and msgdecoder are written "
                        "at the end, the checkpoints and the logs (nothing "
                        "is written without it)")
    p.add_argument("--logging_dir", type=str, default="logs",
                   help="inert: the logs go to <output_dir>/logs")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help='"latest" or a step saved under '
                        '<output_dir>/checkpoints')
    p.add_argument("--report_to", type=str, default="tensorboard",
                   choices=["tensorboard", "wandb", "all", "none"])
    p.add_argument("--validation_prompt", type=str, default=None,
                   help="validation's prompt (\"a photo\" without it); with "
                        "--output_dir also the final sanity inference's")
    p.add_argument("--num_validation_images", type=int, default=1)
    p.add_argument("--validation_epochs", type=int, default=1,
                   help="validate every N epochs (0: never)")
    p.add_argument("--validation_steps", type=int, default=0,
                   help="also validate every N micro-steps (0: never)")
    p.add_argument("--validation_resolution", type=int, default=None)
    p.add_argument("--validation_num_inference_steps", type=int,
                   default=None)
    p.add_argument("--teacher_skip_lora", type=int, default=1,
                   help="1: the teacher skips the LoRA branches; 0: it runs "
                        "them at a zero diagonal (the same output)")
    p.add_argument("--teacher_int8", action="store_true",
                   help="refused: ROADMAP A.8 (the w8a8 port)")
    p.add_argument("--int8_gen", action="store_true",
                   help="refused: ROADMAP A.8 (the w8a8 port)")
    p.add_argument("--fsdp", action="store_true",
                   help="refused: ROADMAP A.9 (the mesh)")
    p.add_argument("--local_rank", type=int, default=-1, help="inert")
    p.add_argument("--rank_dropout", type=float, default=0.0,
                   help="kohya rank dropout, folded into the diagonal")
    p.add_argument("--module_dropout", type=float, default=0.0,
                   help="kohya module dropout: drop a LoRA site's whole "
                        "delta with probability p a step")
    p.add_argument("--lora_dropout", type=float, default=0.0,
                   help="kohya dropout on the LoRA down activations")
    p.add_argument("--down_lr_weight", type=str, default=None,
                   help="block-wise LR of the down blocks: a preset "
                        "(cosine/sine/linear/reverse_linear/zeros[+base]) "
                        "or 12 comma-separated floats")
    p.add_argument("--mid_lr_weight", type=float, default=None)
    p.add_argument("--up_lr_weight", type=str, default=None)
    p.add_argument("--block_lr_zero_threshold", type=float, default=0.0)
    p.add_argument("--allow_tf32", action="store_true", help="inert")
    p.add_argument("--train_text_encoder", action="store_true",
                   help="also train a LoRA on CLIP's attention and MLP")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute the U-Net's transformer blocks in the "
                        "backward")
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true", help="inert")
    p.add_argument("--tokenizer_vocab", type=str, default=None)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--debug_nans", action="store_true",
                   help="raise on a non-finite loss or gradient norm")
    p.add_argument("--attention_impl", type=str, default="auto",
                   choices=["auto", "flash", "sdpa", "xla"],
                   help="auto and flash: the port's kernels; sdpa and xla "
                        "are refused")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main():
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
