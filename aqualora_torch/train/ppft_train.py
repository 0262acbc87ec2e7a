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

With `--mixed_precision bf16` the frozen modules (U-Net base, VAE, CLIP,
SecretEncoder) are stored in bfloat16 and the trainables (LoRA, MapperNet)
in float32, which is the JAX trainer's per-call cast done once.

Run on the card (the default) or on the CPU:

    python -m aqualora_torch.train.ppft_train --rank 320 --resolution 512 \\
        --train_batch_size 8 --mixed_precision bf16 --max_train_steps 4
    python -m aqualora_torch.train.ppft_train --tiny --max_train_steps 2 \\
        --train_batch_size 2 --device cpu

Not ported yet: the LoRA / mapper artifacts, checkpoints and resume,
validation, gradient accumulation, the kohya dropouts, block LR, 8-bit
Adam, the text-encoder LoRA, cached latents, the int8 teacher and the
scale-0 teacher (`--teacher_skip_lora 0`), remat, FSDP and the image-folder
and HF datasets.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from aqualora_torch.core.config import PipelineConfig, WatermarkConfig
from aqualora_torch.core.tokenizer import load_tokenizer
from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                               init_module_weights)
from aqualora_torch.models.watermark import SecretEncoder
from aqualora_torch.ops.secret_inject import inject_from_params
from aqualora_torch.train.data import SyntheticDataset


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
    """Make the U-Net's LoRA weights and the MapperNet float32 and
    trainable; -> {"lora": [...], "mapper": [...]}."""
    _, lora = split_lora(pipe.unet)
    groups = {"lora": list(lora.values()),
              "mapper": list(pipe.mapper.parameters())}
    for params in groups.values():
        for p in params:
            p.data = p.data.float()
            p.requires_grad_(True)
    return groups


def adamw(groups: Dict[str, List], lr: float,
          factor: Callable[[int], float],
          betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2):
    """`optax.adamw` over named parameter groups with the learning rate
    lr * factor(update count), as (optimizer, scheduler): step the
    scheduler after the optimizer (see the module docstring for why this
    is optax's algebra)."""
    optimizer = torch.optim.AdamW(
        [{"params": params, "name": name} for name, params in groups.items()],
        lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler


def make_optimizer(groups: Dict[str, List], lr: float, warmup: int,
                   total: int, lr_end: float = 0.0,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, weight_decay: float = 1e-2):
    """AdamW over the LoRA and mapper groups with the reference's cosine
    schedule."""
    return adamw(groups, lr,
                 cosine_with_warmup_lr_end(1.0, warmup, total, lr_end),
                 betas, eps, weight_decay)


def _global_norm(params) -> torch.Tensor:
    grads = [p.grad.float() for p in params if p.grad is not None]
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Draws:
    """One step's random numbers (NCHW): message bits [B, bits] float32,
    the VAE posterior noise and the diffusion noise [B, C, h, w], and the
    timesteps [B] int64."""

    msg: torch.Tensor
    vae_noise: torch.Tensor
    noise: torch.Tensor
    t: torch.Tensor


def draw(pipe: StableDiffusionPipeline, generator: torch.Generator,
         pixels) -> Draws:
    """A step's `Draws` for a batch of NHWC `pixels`, from `generator` (on
    the pipeline's device)."""
    cfg, dev = pipe.config, pipe.device
    b, h, w = pixels.shape[:3]
    down = cfg.vae.downscale
    lat = (b, cfg.vae.latent_channels, h // down, w // down)
    msg = torch.bernoulli(torch.full((b, cfg.watermark.msg_bits), 0.5,
                                     device=dev), generator=generator)
    vae_noise = torch.randn(lat, generator=generator, device=dev,
                            dtype=pipe.vae.quant_conv.weight.dtype)
    noise = torch.randn(lat, generator=generator, device=dev)
    t = torch.randint(0, cfg.schedule.num_train_timesteps, (b,),
                      generator=generator, device=dev)
    return Draws(msg, vae_noise, noise, t)


def make_loss_fn(pipe: StableDiffusionPipeline, sec_encoder: SecretEncoder):
    """The PPFT objective (`make_loss_fn`, `ppft_train.py:107-203`) ->
    loss_fn(pixels NHWC, input_ids, draws) -> (loss, metrics).  The draws
    are an argument, so a test can hand it the JAX trainer's."""
    sched, cfg = pipe.schedule, pipe.config
    v_pred = cfg.unet.prediction_type == "v_prediction"
    scaling = cfg.vae.scaling_factor
    grid = cfg.watermark.secret_grid

    def loss_fn(pixels, input_ids, draws: Draws):
        x = torch.as_tensor(pixels, device=pipe.device).permute(0, 3, 1, 2)
        diag = pipe.mapper(draws.msg)
        with torch.no_grad():
            latents = pipe.vae.sample_from_moments(
                *pipe.vae.encode_moments(x), draws.vae_noise)
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
            ctx = pipe.clip(pipe._ids(input_ids))
            # scale=None skips the LoRA branches: exactly the reference's
            # scale=0 teacher without the rank-R products
            teacher = pipe.unet(noisy_clean, draws.t, ctx, None)
        student = pipe.unet(noisy_wm, draws.t, ctx, diag)
        if v_pred:
            student = sched.velocity_to_epsilon(student, noisy_wm, draws.t)
            teacher = sched.velocity_to_epsilon(teacher, noisy_clean, draws.t)
        loss = torch.mean((student.float() - teacher.float()) ** 2)
        return loss, {"ppft_loss": loss.detach()}

    return loss_fn


def make_train_step(pipe: StableDiffusionPipeline, sec_encoder: SecretEncoder,
                    optimizer: torch.optim.Optimizer, scheduler,
                    max_grad_norm: float = 1.0):
    """-> train_step(pixels NHWC, input_ids, draws) -> metrics: one update
    of the LoRA and mapper groups of `optimizer` (see `make_optimizer`)."""
    loss_fn = make_loss_fn(pipe, sec_encoder)
    groups = {g["name"]: g["params"] for g in optimizer.param_groups}

    def train_step(pixels, input_ids, draws: Draws) -> Dict[str, Any]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(pixels, input_ids, draws)
        loss.backward()
        with torch.no_grad():
            metrics["grad_norm"] = _global_norm(
                [p for params in groups.values() for p in params])
            norm = _global_norm(groups["lora"])
            factor = torch.where(norm < max_grad_norm,
                                 torch.ones_like(norm), max_grad_norm / norm)
            for p in groups["lora"]:
                if p.grad is not None:
                    p.grad.mul_(factor)
        optimizer.step()
        scheduler.step()
        return metrics

    return train_step


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def build_configs(args) -> Tuple[PipelineConfig, int]:
    """-> (pipeline config, pixel resolution); `--tiny` ignores
    `--resolution`, as in the JAX trainer."""
    if args.tiny:
        cfg = PipelineConfig.tiny()
        if args.mapper_std != 1.0:
            cfg = dataclasses.replace(cfg, watermark=dataclasses.replace(
                cfg.watermark, mapper_std=args.mapper_std))
        return cfg, 64
    cfg = PipelineConfig.sd15(args.rank)
    cfg = dataclasses.replace(cfg, watermark=WatermarkConfig(
        msg_bits=args.msg_bits, lora_rank=args.rank,
        mapper_std=args.mapper_std))
    return cfg, args.resolution


@torch.no_grad()
def init_lora(unet: nn.Module, generator: torch.Generator) -> None:
    """The LoRA init of the JAX layers: down N(0, (1/rank)^2), up zero."""
    for name, p in split_lora(unet)[1].items():
        if name.endswith("up.weight"):
            p.zero_()
        else:
            rank = p.shape[0]
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) / rank)


@dataclasses.dataclass
class Trainer:
    """What `run` builds: the pipeline, the SecretEncoder, the trainable
    groups, the LR schedule and the step, the data and the step's
    generator."""

    pipe: StableDiffusionPipeline
    sec_encoder: SecretEncoder
    groups: Dict[str, List]
    scheduler: Any
    train_step: Any
    batches: Any
    tokenizer: Any
    generator: torch.Generator
    max_steps: int


def build_trainer(args: argparse.Namespace) -> Trainer:
    device = torch.device(args.device)
    seed = args.seed or 0
    torch.manual_seed(seed)
    cfg, resolution = build_configs(args)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    pipe = StableDiffusionPipeline(cfg, dtype=dtype, device=device)
    pipe.init_params(seed)
    groups = trainable_groups(pipe)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_lora(pipe.unet, gen)
    pipe.mapper.reset_parameters()
    latent_res = resolution // cfg.vae.downscale
    with device:
        sec_encoder = SecretEncoder(cfg.watermark.msg_bits,
                                    cfg.watermark.secret_grid, latent_res,
                                    cfg.vae.latent_channels)
    init_module_weights(sec_encoder.secret_dense, gen)
    sec_encoder.to(dtype).eval().requires_grad_(False)

    dataset = SyntheticDataset(resolution)
    steps_per_epoch = max(1, len(dataset) // args.train_batch_size)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    optimizer, scheduler = make_optimizer(
        groups, args.learning_rate, args.lr_warmup_steps, max_steps,
        args.lr_end, (args.adam_beta1, args.adam_beta2), args.adam_epsilon,
        args.adam_weight_decay)
    step = make_train_step(pipe, sec_encoder, optimizer, scheduler,
                           args.max_grad_norm)
    return Trainer(pipe, sec_encoder, groups, scheduler, step,
                   dataset.batches(args.train_batch_size, seed=seed),
                   load_tokenizer(args.tokenizer_vocab,
                                  vocab_size=cfg.clip.vocab_size),
                   torch.Generator(device=device).manual_seed(seed + 1),
                   max_steps)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    tr = build_trainer(args)
    history = []
    t0 = time.time()
    for global_step in range(1, tr.max_steps + 1):
        pixels, captions = next(tr.batches)
        ids = tr.tokenizer(captions)
        draws = draw(tr.pipe, tr.generator, pixels)
        metrics = tr.train_step(pixels, ids, draws)
        if global_step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            m["lr"] = tr.scheduler.get_last_lr()[0]     # lr of the next step
            print(f"step {global_step}/{tr.max_steps}: "
                  + " ".join(f"{k}={v:.6f}" for k, v in m.items())
                  + f" ({(time.time() - t0) / global_step:.2f}s/step)",
                  flush=True)
    return {"history": history, "trainer": tr}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--tiny", action="store_true",
                   help="the tiny test configuration at 64 px")
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--mapper_std", type=float, default=1.0)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_end", type=float, default=0.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["no", "bf16"],
                   help="bf16: frozen modules in bfloat16, trainables in "
                        "float32")
    p.add_argument("--tokenizer_vocab", type=str, default=None)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main():
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
