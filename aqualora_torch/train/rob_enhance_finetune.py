"""Stage 3, the robustness fine-tune of the message decoder, in PyTorch.

The port of `aqualora_tpu/train/rob_enhance_finetune.py`.  Everything but
the SecretDecoder is frozen.  Each step:

    res      = a resolution drawn from RESOLUTIONS (numpy, the JAX stream)
    msg      ~ Bernoulli(0.5)                               [B, bits]
    images   = generate(captions, DPM-Solver++(2M) 20 steps, CFG 7.5,
                        lora_scale = mapper(msg) * 1.03)    [no grad]
    noised   = Stage3Noiser((images + 1) / 2)               one distortion
    loss     = bce(decoder(noised * 2 - 1, train), msg)     decoder only

The message is threaded through the LoRA as a per-image diagonal, not
folded.  The generation runs the flash-attention forward kernel at every
resolution's shapes (641 launches a step: 32 per U-Net evaluation and the
VAE's mid-block), up to T = 9216 at 768^2.  The decoder step is AdamW with
optax's algebra (`ppft_train.adamw`) over every decoder parameter, weight
decay on all of them and no gradient clipping, as `optax.adamw` with no
mask, at `cosine_with_warmup_lr_end`; the BatchNorm statistics update in
the train-mode call.  The SecretDecoder stays float32 under
`--mixed_precision bf16`, as the JAX trainer builds it without a dtype:
the bf16 pipeline's images come back in float32 (the VAE's last conv runs
in float32 in both packages).

A step's random numbers are one `draw` on one `torch.Generator`, in a fixed
order: the initial latent, the message, the distortion and the decoder's
keep masks.  `--resume_from_checkpoint` ("latest" or a step) restores the
decoder, its BatchNorm statistics, the optimizer and the schedule, then
replays the skipped steps' resolutions, captions and draws without
generating, so the resumed run sees the draws of an uninterrupted one (the
checkpoint's generator state must then match, or the run refuses).  A
checkpoint (`core/checkpoint.py`) is written every `--checkpointing_steps`
under `<output_dir>/checkpoints`, at most `--checkpoints_total_limit` kept.
At the end the decoder is written as `<output_dir>/msgdecoder.pt`, the
layout `eval.utils_eval.load_msgdecoder` reads.

--output_dir is required: the checkpoints, the tracker's logs and
msgdecoder.pt go there, and nothing is written outside it.

Loading: `--pretrained_model_name_or_path` (a local diffusers directory),
`--start_from_pretrain` (only the `sec_decoder` entry of stage 1's
`pretrained_latentwm.pt`, its BatchNorm statistics included) and
`--resume_from_lora` (PPFT's LoRA and mapper directory).

Run on the card (the default) or on the CPU:

    python -m aqualora_torch.train.rob_enhance_finetune --rank 320 \\
        --train_batch_size 4 --mixed_precision bf16 --max_train_steps 4 \\
        --start_from_pretrain s1/pretrained_latentwm.pt \\
        --resume_from_lora ppft --output_dir s3
    python -m aqualora_torch.train.rob_enhance_finetune --tiny \\
        --max_train_steps 2 --train_batch_size 2 --device cpu \\
        --output_dir /tmp/s3

Data (`:149-155,196-210`): `--train_data_dir` reads a folder of JPEG and
PNG files with `metadata.jsonl` captions (`train/data.py`; also
`--max_train_samples`, `--caption_column`, `--dataloader_num_workers`),
decoded a step ahead on a background thread (`data.prefetch`); its
captions are the generation's prompts, and a folder without captions
prompts with "".  Without it, synthetic captions.  As in the JAX trainer,
the parser is PPFT's: `--center_crop`, `--random_flip` and
`--cache_latents` are accepted and have no effect here; of PPFT's other
options only what `ppft_train.build_configs` reads reaches the pipeline.

Refused as PPFT refuses them (`ppft_train.refuse_unported`), each naming
its ROADMAP item: `--fsdp` (A.9), `--int8_gen` and `--teacher_int8` (A.8);
`--dataset_name` and `--dataset_config_name`, the HF datasets path (no
`datasets` package, no download).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from aqualora_torch.core.checkpoint import CheckpointManager
from aqualora_torch.core.io import assign_state
from aqualora_torch.core.tokenizer import load_tokenizer
from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                               init_module_weights)
from aqualora_torch.distort.noiser import NoiseDraw, Stage3Noiser
from aqualora_torch.models.efficientnet import Masks
from aqualora_torch.models.watermark import SecretDecoder
from aqualora_torch.train import data as data_lib
from aqualora_torch.train import ppft_train
from aqualora_torch.train.losses import bit_accuracy, message_bce
from aqualora_torch.utils.logging import Tracker

RESOLUTIONS = (512, 576, 640, 704, 768)    # the reference's :1004-1005
TINY_RESOLUTIONS = (32, 48)
GUIDANCE = 7.5


@dataclasses.dataclass
class Draws:
    """One step's random numbers: the initial latent [B, h, w, C] (NHWC,
    as `make_generate` takes it), the message bits [B, bits] float32, the
    distortion and the decoder's keep masks."""

    z: torch.Tensor
    msg: torch.Tensor
    noise: NoiseDraw
    masks: Masks

    def to(self, device) -> "Draws":
        """The same numbers on `device`."""
        mv = lambda t: t.to(device)
        return Draws(mv(self.z), mv(self.msg),
                     NoiseDraw(self.noise.index,
                               {k: mv(v) for k, v in
                                self.noise.params.items()}),
                     Masks([mv(m) for m in self.masks.depth],
                           None if self.masks.dropout is None
                           else mv(self.masks.dropout)))


def draw(pipe: StableDiffusionPipeline, decoder: SecretDecoder,
         noiser: Stage3Noiser, gen: torch.Generator, batch: int,
         res: int) -> Draws:
    """A step's `Draws` at resolution `res`, from `gen`, in the order
    latent, message, distortion, masks."""
    cfg, dev = pipe.config, gen.device
    lat = res // cfg.vae.downscale
    z = torch.randn((batch, lat, lat, cfg.unet.in_channels), generator=gen,
                    device=dev)
    msg = torch.bernoulli(torch.full((batch, cfg.watermark.msg_bits), 0.5,
                                     device=dev), generator=gen)
    return Draws(z, msg, noiser.draw(gen, (batch, 3, res, res)),
                 decoder.model.draw_masks(batch, gen))


def make_decoder_step(decoder: SecretDecoder, optimizer, scheduler):
    """`make_decoder_step` (`rob_enhance_finetune.py:52-76`) ->
    step(images01 NCHW in [0, 1], msg, noise, masks) -> {"acc", "loss"}:
    one AdamW update of the decoder on the distorted images."""
    noiser = Stage3Noiser()

    def step(images01: torch.Tensor, msg: torch.Tensor, noise: NoiseDraw,
             masks: Masks) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        noised = noiser(images01, noise)
        # the decoder takes [-1, 1] and resizes to its own resolution
        logits = decoder(noised * 2.0 - 1.0, train=True, masks=masks)
        loss = message_bce(logits, msg)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"acc": bit_accuracy(logits.detach(), msg),
                "loss": loss.detach()}

    return step


@dataclasses.dataclass
class Trainer:
    """What `run` builds: the pipeline and one generate function per
    resolution, the decoder and its step, the optimizer and schedule, the
    captions, the tokenizer, the step's generator and the resolution
    stream."""

    pipe: StableDiffusionPipeline
    generators: Dict[int, Any]
    decoder: SecretDecoder
    noiser: Stage3Noiser
    optimizer: Any
    scheduler: Any
    decoder_step: Any
    batches: Any
    tokenizer: Any
    generator: torch.Generator
    rng: np.random.Generator
    resolutions: tuple
    batch_size: int
    max_steps: int


def _refuse_unported(args: argparse.Namespace) -> None:
    ppft_train.refuse_unported(args)         # the shared parser's flags
    if not args.output_dir:
        raise ValueError("stage 3 writes its checkpoints, logs and "
                         "msgdecoder.pt under --output_dir: pass one")


def load_pretrained_decoder(path: str, decoder: SecretDecoder) -> None:
    """`--start_from_pretrain`: only the `sec_decoder` entry of stage 1's
    `pretrained_latentwm.pt`, BatchNorm statistics included, strictly."""
    art = torch.load(path, map_location="cpu", weights_only=True)
    assign_state(decoder, art["sec_decoder"], what="sec_decoder")


def build_trainer(args: argparse.Namespace) -> Trainer:
    _refuse_unported(args)
    device = torch.device(args.device)
    seed = args.seed or 0
    torch.manual_seed(seed)
    cfg, backbone, base_res = ppft_train.build_configs(args)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    pipe = StableDiffusionPipeline(cfg, dtype=dtype, device=device)
    pipe.init_params(seed)
    if args.pretrained_model_name_or_path:
        ppft_train._load_sd_checkpoint(args.pretrained_model_name_or_path,
                                       pipe)
    # float32 under either type, as the JAX trainer's (no dtype)
    decoder = SecretDecoder(cfg.watermark.msg_bits, backbone, device=device)
    init_module_weights(decoder, torch.Generator(device=device)
                        .manual_seed(seed + 2))
    if args.start_from_pretrain:
        load_pretrained_decoder(args.start_from_pretrain, decoder)
    decoder.requires_grad_(True)
    if args.resume_from_lora:
        pipe.load_watermark_lora(args.resume_from_lora)

    tiny = args.tiny
    resolutions = TINY_RESOLUTIONS if tiny else RESOLUTIONS
    gen_steps = 2 if tiny else 20          # pipeline(..., 20 steps) `:1008`
    generators = {r: pipe.make_generate(num_steps=gen_steps, sampler="dpms_m",
                                        height=r, width=r)
                  for r in resolutions}
    dataset = data_lib.make_dataset(
        args.train_data_dir, base_res, max_samples=args.max_train_samples,
        caption_column=args.caption_column, image_column=args.image_column,
        num_threads=args.dataloader_num_workers)
    steps_per_epoch = max(1, len(dataset) // args.train_batch_size)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    optimizer, scheduler = ppft_train.make_optimizer(
        {"decoder": list(decoder.parameters())}, args.learning_rate,
        args.lr_warmup_steps, max_steps, args.lr_end,
        (args.adam_beta1, args.adam_beta2), args.adam_epsilon,
        args.adam_weight_decay)
    return Trainer(pipe, generators, decoder, Stage3Noiser(), optimizer,
                   scheduler, make_decoder_step(decoder, optimizer, scheduler),
                   data_lib.prefetch(dataset.batches(args.train_batch_size,
                                                     seed=seed)),
                   load_tokenizer(args.tokenizer_vocab,
                                  vocab_size=cfg.clip.vocab_size),
                   torch.Generator(device=device).manual_seed(seed + 1),
                   np.random.default_rng(seed), resolutions,
                   args.train_batch_size, max_steps)


def next_step_inputs(tr: Trainer):
    """The next step's captions, resolution and draws, in the JAX loop's
    order (`:203-205`): consumed for a skipped step too."""
    _, captions = next(tr.batches)
    res = int(tr.rng.choice(tr.resolutions))     # the host's bucket pick
    return captions, res, draw(tr.pipe, tr.decoder, tr.noiser, tr.generator,
                               tr.batch_size, res)


def generate_images(tr: Trainer, res: int, captions: List[str],
                    d: Draws) -> torch.Tensor:
    """The step's watermarked images, NCHW in [0, 1]: the message threaded
    as the diagonal mapper(msg) * 1.03 (`:216-220`), no gradient."""
    b = tr.batch_size
    diag = tr.pipe.message_scale(d.msg)
    images = tr.generators[res](tr.tokenizer(captions or [""] * b),
                                tr.tokenizer([""] * b), GUIDANCE, diag,
                                z=d.z)
    return (images.permute(0, 3, 1, 2) + 1.0) / 2.0


def train_step(tr: Trainer, res: int, captions: List[str],
               d: Draws) -> Dict[str, torch.Tensor]:
    """One stage-3 step: generate at `res`, then the decoder step."""
    return tr.decoder_step(generate_images(tr, res, captions, d), d.msg,
                           d.noise, d.masks)


def checkpoint_state(tr: Trainer, step: int) -> Dict[str, Any]:
    return {"decoder": tr.decoder.state_dict(),
            "optimizer": tr.optimizer.state_dict(),
            "scheduler": tr.scheduler.state_dict(), "step": step,
            "generator": tr.generator.get_state()}


def resume(tr: Trainer, ckpt: CheckpointManager, which: str) -> int:
    """Restore the checkpoint `which` ("latest" or a step), replay the
    skipped steps' inputs, and return the step it was saved at."""
    state = ckpt.restore(None if which == "latest" else int(which))
    tr.decoder.load_state_dict(state["decoder"])
    tr.optimizer.load_state_dict(state["optimizer"])
    tr.scheduler.load_state_dict(state["scheduler"])
    start = int(state["step"])
    for _ in range(start):
        next_step_inputs(tr)
    if not torch.equal(tr.generator.get_state(), state["generator"]):
        raise ValueError(f"checkpoint {start}: its draws are not this run's "
                         "(another --seed, --train_batch_size or --tiny?)")
    return start


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train and write `<output_dir>/msgdecoder.pt`; -> {"history": logged
    metrics, "decoder", "seconds" and "resolutions" of each step run,
    "start_step", "trainer"}."""
    tr = build_trainer(args)
    out = args.output_dir
    ckpt = CheckpointManager(os.path.join(out, "checkpoints"),
                             max_to_keep=args.checkpoints_total_limit)
    start = (resume(tr, ckpt, args.resume_from_checkpoint)
             if args.resume_from_checkpoint else 0)
    tracker = Tracker(out, args.report_to)
    history, seconds, resolutions = [], [], []
    t0 = time.time()
    for step_i in range(start + 1, tr.max_steps + 1):
        t1 = time.perf_counter()
        captions, res, d = next_step_inputs(tr)
        metrics = train_step(tr, res, captions, d)
        if step_i % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            tracker.log(m, step_i)
            print(f"step {step_i}/{tr.max_steps} res={res}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                  + f" ({(time.time() - t0) / (step_i - start):.2f}s/step)",
                  flush=True)
        if step_i % args.checkpointing_steps == 0:
            ckpt.save(step_i, checkpoint_state(tr, step_i))
        seconds.append(time.perf_counter() - t1)
        resolutions.append(res)
    os.makedirs(out, exist_ok=True)
    torch.save({k: v.cpu() for k, v in tr.decoder.state_dict().items()},
               os.path.join(out, ppft_train.MSGDECODER_FILE))
    tracker.close()
    return {"history": history, "decoder": tr.decoder, "seconds": seconds,
            "resolutions": resolutions, "start_step": start, "trainer": tr}


def build_argparser() -> argparse.ArgumentParser:
    p = ppft_train.build_argparser()
    p.description = __doc__
    p.set_defaults(learning_rate=5e-6, msg_bits=48)
    return p


def main():
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
