"""The eval protocol's generation and read-back, and the detection math.

The port of `aqualora_tpu/eval/utils_eval.py`:
  - the binomial FPR threshold (`:40-50`), the decoder's bits and logit
    margins (`decode_bits`, the inner `decode` of `:399-407`) and the bit
    accuracy / TPR rule (`score_bits`, `:448-461`);
  - `resolve_watermark_lora` (`:57-114`): the two entries for watermarked
    generation, a message folded from a training folder or a pre-folded
    LoRA file;
  - `simple_sample` (`:158-347`): len(prompts) x len(seeds) images with any
    sampler of the menu, a folded LoRA (fused into the U-Net) or one message
    per image (the MapperNet diagonal threaded per row), per-image
    generators, PNGs `{seed}_{index}.png`;
  - `load_msgdecoder` / `simple_decode` (`:350-471`): read the images back
    through PIL's bicubic preprocess (`eval/image_io.py`, without PIL) and
    score them.

Generation runs on `device` ("cuda" unless the caller asks for the CPU), in
bfloat16 on the card and float32 on the CPU, as the JAX package picks bf16
on the TPU.  There is no int8 path (ROADMAP A.10) and no mesh (A.13).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
from aqualora_torch.core.io import (LORA_FILE, import_lora_safetensors,
                                    load_safetensors)
from aqualora_torch.eval.image_io import images_to_uint8, preprocess, save_png

SAMPLER_NAMES = ("ddim", "euler", "heun", "lms", "pndm", "dpms_s",
                 "dpms_sde", "dpms_m", "kdpm2", "kdpm2a", "unipc")


# ---------------------------------------------------------------------------
# detection math
# ---------------------------------------------------------------------------

def calculate_fpr(tau: int, k: int) -> float:
    """P[#matching bits > tau] for a random message: binomial tail / 2^k."""
    total = sum(math.comb(k, i) for i in range(tau + 1, k + 1))
    return total / (2 ** k)


def get_threshold(k: int, fpr: float) -> int:
    tau = 0
    while calculate_fpr(tau, k) > fpr:
        tau += 1
    return tau


@torch.no_grad()
def decode_bits(decoder: torch.nn.Module,
                images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images NHWC in [-1, 1] -> (bits [B, n] int64, margins [B, n] float32).
    The margin is logit_1 - logit_0; the bit is its argmax (1 iff the
    margin is positive)."""
    weight = next(decoder.parameters())
    x = images.permute(0, 3, 1, 2).to(weight.device, weight.dtype)
    logits = decoder(x)
    margins = (logits[..., 1] - logits[..., 0]).float()
    return logits.argmax(dim=-1), margins


def score_bits(bits, msg_gt: str, fpr: float = 1e-3) -> Tuple[float, float]:
    """(bit accuracy, TPR) of decoded bits [B, n] (tensor or array) against
    the bit string `msg_gt`.  An image counts as detected when its accuracy
    reaches tau / n, with tau the binomial threshold at `fpr`; accuracies
    are float64, as the JAX loop's numpy means, so acc == tau / n holds
    exactly where it should."""
    bits = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor) else bits)
    n = bits.shape[1]
    if len(msg_gt) != n:
        raise ValueError(f"msg_gt has {len(msg_gt)} bits, decoder "
                         f"extracts {n}")
    tau = get_threshold(n, fpr) / n
    acc = (bits == np.array([int(c) for c in msg_gt])).mean(axis=1)
    return float(np.mean(acc)), float(np.mean(acc >= tau))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def resolve_watermark_lora(train_folder: Optional[str],
                           lora_path: Optional[str],
                           lora_scale: float,
                           msg_gt: Optional[str], msg_bits: int,
                           hidinfo: Optional[str] = None,
                           rng=None) -> Tuple[Optional[str],
                                              Dict[str, torch.Tensor]]:
    """The two reference entries for watermarked eval generation:

    - `train_folder`: fold a message internally via create_wm_lora;
    - `lora_path`: a PRE-folded LoRA safetensors file (the reference's
      two-step flow: `create_wm_lora` then `run_eval_base --lora ...
      --msg_gt ...`); `msg_gt` carries the bits that file embeds.
      `lora_scale` multiplies the `up` weights (the delta is linear in
      them: fuse_lora(scale), `evaluation/utils_eval.py:80-82`).

    Returns (bitstring or None, folded LoRA state dict)."""
    if (train_folder is None) == (lora_path is None):
        raise SystemExit("pass exactly one of --train_folder (fold a "
                         "message internally) or --lora (pre-folded "
                         "safetensors from create_wm_lora)")
    if train_folder and (lora_scale != 1.0 or msg_gt is not None):
        # the train_folder path folds its own message at 1.03: ignoring
        # these would let a --lora_scale sweep return identical results
        raise SystemExit("--lora_scale/--msg_gt apply to the pre-folded "
                         "--lora flow only; with --train_folder use "
                         "--hidinfo to choose the embedded message")
    if lora_path:
        if hidinfo is not None:
            # the message is already in a pre-folded file: --hidinfo would
            # score against bits that were never embedded
            raise SystemExit("--hidinfo selects the message the "
                             "--train_folder flow folds; with a "
                             "pre-folded --lora file pass the embedded "
                             "bits as --msg_gt instead")
        state = load_safetensors(lora_path)
        if lora_scale != 1.0:
            if not any("up.weight" in k for k in state):
                raise SystemExit(
                    f"--lora_scale {lora_scale} matched no '*up.weight' "
                    f"tensors in {lora_path}: unrecognized LoRA key "
                    "layout; convert to the diffusers layout first")
            state = {k: (v * lora_scale if "up.weight" in k else v)
                     for k, v in state.items()}
        return msg_gt, state
    from aqualora_torch.tools.create_wm_lora import create_watermark_lora
    return create_watermark_lora(
        train_folder, scale=1.03, msg_bits=msg_bits, hidinfo=hidinfo,
        save=False, rng=rng if rng is not None
        else np.random.default_rng(0))


def square_resolution(args) -> None:
    """Map the reference's --height/--width onto --resolution (the
    protocol is square; reject non-square rather than silently crop)."""
    h = getattr(args, "height", None)
    w = getattr(args, "width", None)
    if h or w:
        h, w = h or w, w or h
        if h != w:
            raise SystemExit(f"--height {h} != --width {w}: non-square "
                             "generation is not part of the eval "
                             "protocol (512x512)")
        args.resolution = h


def image_generator(seed: int, index: int,
                    device: str | torch.device) -> torch.Generator:
    """The generator image `index` of seed `seed` draws from: seeded by
    SeedSequence((seed, index)), a function of the pair alone, so no
    batching changes an image (the JAX package's `key_stack`,
    `fold_in(PRNGKey(seed), index)`)."""
    state = np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _infer_rank(lora: Optional[Dict[str, torch.Tensor]]) -> int:
    if not lora:
        return 320
    for k, v in lora.items():
        if "down.weight" in k:
            return int(v.shape[0])
    return 320


def simple_sample(model_path: Optional[str], sampler: str,
                  prompts: Sequence[str],
                  lora: Optional[Dict[str, torch.Tensor]] = None,
                  seeds: Optional[Sequence[int]] = None,
                  output_dir: Optional[str] = None,
                  num_inference_steps: int = 25,
                  guidance_scale: float = 7.5,
                  batch_size: int = 4, resolution: int = 512,
                  negative_prompt: str = "",
                  config: Optional[PipelineConfig] = None,
                  params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                  tokenizer_vocab: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None, int8=False,
                  messages: Optional[Sequence[str]] = None,
                  train_folder: Optional[str] = None,
                  message_scale: float = 1.03,
                  device: str | torch.device = "cuda") -> List[np.ndarray]:
    """Generate len(prompts) x len(seeds) images; returns them as HWC uint8
    RGB arrays (seed-major), and writes `{seed}_{index}.png` under
    `output_dir` when it is given.

    `lora`: a *folded* (message-carrying) LoRA state dict from
    create_wm_lora: imported into the U-Net, folded at unit diagonal and
    stripped, so the plain U-Net runs (the reference's fuse_lora,
    `utils_eval.py:80-82`).
    `messages` + `train_folder`: one watermark per image in one batch: the
    unfolded LoRA and the mapper of `train_folder`, with
    `mapper(msg_i) * message_scale` as row i's [rank] diagonal (the same
    images as folding each message, `tests/test_fold.py`).
    `params`: weights to start from instead of seeded random ones (or
    `model_path`'s), as torch state dicts by module: {"text_encoder",
    "unet", "vae", "mapper"}.
    `dtype`: bfloat16 on a CUDA device, float32 on the CPU by default.
    `int8`: not ported (ROADMAP A.10); anything truthy raises."""
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.lora import fold_lora_tree, strip_lora_params
    from aqualora_torch.tools.create_wm_lora import (load_mapper_state,
                                                     mapper_diag_from_state)

    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler}; have {SAMPLER_NAMES}")
    if int8:
        raise NotImplementedError("int8 serving is not ported (ROADMAP A.10)")
    device = torch.device(device)
    lora_unfolded = mapper_state = None
    if messages is not None:
        if lora is not None:
            raise ValueError("pass either a folded `lora` or per-image "
                             "`messages` + `train_folder`, not both")
        if train_folder is None:
            raise ValueError("`messages` needs `train_folder` (unfolded "
                             "LoRA + mapper)")
        if len(messages) != len(prompts):
            raise ValueError(f"{len(messages)} messages for "
                             f"{len(prompts)} prompts")
        lora_unfolded = load_safetensors(os.path.join(train_folder,
                                                      LORA_FILE))
        mapper_state = load_mapper_state(train_folder)
    cfg = config or PipelineConfig.sd15(lora_rank=_infer_rank(
        lora if lora is not None else lora_unfolded))
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    pipe = StableDiffusionPipeline(cfg, dtype=dtype, device=device)
    if params is not None:
        for name, module in (("text_encoder", pipe.clip),
                             ("unet", pipe.unet), ("vae", pipe.vae),
                             ("mapper", pipe.mapper)):
            module.load_state_dict(params[name], strict=True)
    else:
        pipe.init_params(seed=0)
        if model_path:
            from aqualora_torch.train.ppft_train import _load_sd_checkpoint
            _load_sd_checkpoint(model_path, pipe)
    diag_all = None
    if lora is not None:
        import_lora_safetensors(pipe.unet, cfg.unet, lora)
        fold_lora_tree(pipe.unet, torch.ones(cfg.unet.lora.rank),
                       alpha_scale=cfg.unet.lora.alpha_scale)
        strip_lora_params(pipe.unet)
    elif lora_unfolded is not None:
        import_lora_safetensors(pipe.unet, cfg.unet, lora_unfolded)
        n_bits = int(mapper_state["bit_embeddings.weight"].shape[0])
        bad = [m for m in messages
               if len(m) != n_bits or set(m) - {"0", "1"}]
        if bad:
            raise ValueError(f"messages must be {n_bits}-char bitstrings; "
                             f"got {bad[:3]}")
        bits = np.array([[int(c) for c in m] for m in messages], np.float32)
        # the fold path's mapper forward x inference scale -> [N, rank]
        diag_all = mapper_diag_from_state(mapper_state, bits) * message_scale

    tok = load_tokenizer(tokenizer_vocab, vocab_size=cfg.clip.vocab_size)
    gen = pipe.make_generate(num_inference_steps, sampler, resolution,
                             resolution)
    seeds = list(seeds) if seeds is not None else [0]
    neg = tok([negative_prompt] * batch_size)
    out_images: List[np.ndarray] = []
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    for seed in seeds:
        for i in range(0, len(prompts), batch_size):
            chunk = list(prompts[i:i + batch_size])
            pad = batch_size - len(chunk)
            # every call has the batch's shape: empty prompts, the last
            # message repeated, as the JAX loop pads
            ids = tok(chunk + [""] * pad)
            scale = None
            if diag_all is not None:
                rows = diag_all[i:i + batch_size]
                if pad:
                    rows = np.concatenate(
                        [rows, np.repeat(rows[-1:], pad, 0)], 0)
                scale = torch.from_numpy(rows).to(device, torch.float32)
            gens = [image_generator(seed, i + j, device)
                    for j in range(batch_size)]
            imgs = gen(ids, neg, guidance_scale, scale, generator=gens)
            arrays = list(images_to_uint8(imgs)[: len(chunk)])
            out_images.extend(arrays)
            if output_dir:
                for j, img in enumerate(arrays):
                    save_png(os.path.join(output_dir, f"{seed}_{i + j}.png"),
                             img)
    return out_images


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def load_msgdecoder(msgdecoder_path: str, bitnum: int,
                    backbone: Optional[EfficientNetConfig] = None,
                    device: str | torch.device = "cuda"):
    """The port's `msgdecoder.pt` (a SecretDecoder state dict, written by
    `ppft_train.save_artifacts`) -> SecretDecoder(bitnum, backbone) in eval
    mode, loaded strictly.  (The JAX function reads an orbax directory.)"""
    from aqualora_torch.models.watermark import SecretDecoder
    dec = SecretDecoder(bitnum, backbone or EfficientNetConfig.b1(),
                        device=device)
    dec.load_state_dict(torch.load(msgdecoder_path, map_location=device,
                                   weights_only=True), strict=True)
    return dec.eval().requires_grad_(False)


def simple_decode(bitnum: int, msgdecoder_path: str, images,
                  msg_gt: Optional[str] = None, resolution: int = 512,
                  tpr_threshold: float = 1e-3,
                  backbone: Optional[EfficientNetConfig] = None,
                  batch_size: int = 16, return_margins: bool = False,
                  device: str | torch.device = "cuda"):
    """images: PNG paths or HWC uint8 images.  Returns (bit accuracy, TPR at
    tau(fpr), decoded bitstrings), and with `return_margins` a 4th element:
    float32 [N, bitnum] logit margins (logit_1 - logit_0).

    The preprocess is the protocol's: RGB, PIL's bicubic resize to
    resolution^2, / 127.5 - 1 (`image_io.preprocess`); batches of
    `batch_size`, the last zero-padded to the same shape."""
    if msg_gt is not None and len(msg_gt) != bitnum:
        # a length mismatch would zip-truncate the accuracy to a prefix
        raise ValueError(f"msg_gt has {len(msg_gt)} bits, decoder "
                         f"extracts {bitnum}")
    dec = load_msgdecoder(msgdecoder_path, bitnum, backbone, device)
    arr = [preprocess(im, resolution) for im in images]
    bits_all: List[np.ndarray] = []
    margins: List[np.ndarray] = []
    for i in range(0, len(arr), batch_size):
        chunk = np.stack(arr[i:i + batch_size])
        n_real = len(chunk)
        if n_real < batch_size:
            chunk = np.concatenate([chunk, np.zeros(
                (batch_size - n_real,) + chunk.shape[1:], chunk.dtype)])
        bits, marg = decode_bits(dec, torch.from_numpy(chunk).to(device))
        bits_all.append(bits[:n_real].cpu().numpy())
        margins.append(marg[:n_real].cpu().numpy())
    bits = (np.concatenate(bits_all) if bits_all
            else np.zeros((0, bitnum), np.int64))
    results = ["".join(map(str, row.tolist())) for row in bits]
    bitacc = tpr = float("nan")
    if msg_gt is not None:
        bitacc, tpr = (score_bits(bits, msg_gt, tpr_threshold) if results
                       else (float("nan"), 0.0))
        print(f"bit accuracy: {bitacc}")
        print(f"TPR: {tpr}")
    if return_margins:
        marg = (np.concatenate(margins, axis=0) if margins
                else np.zeros((0, bitnum), np.float32))
        return bitacc, tpr, results, marg
    return bitacc, tpr, results
