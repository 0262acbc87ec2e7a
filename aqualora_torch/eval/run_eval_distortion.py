"""Robustness benchmark (`evaluation/run_eval_distortion.py`), in PyTorch.

The port of `aqualora_tpu/eval/run_eval_distortion.py`: generate the
watermarked images once (`clean/`, seed 0), apply each distortion
(color_jitter, crop, blur, noise, jpeg_compress, rotation, sharpness, and
with --with_sdedit / --with_sdedit2 the SDEdit regeneration attacks), write
each distorted set as PNGs under its own directory, decode each set and
report its bit accuracy and TPR.

    python -m aqualora_torch.eval.run_eval_distortion --train_folder DIR \\
        --msgdecoder_path DIR/msgdecoder.pt [--with_sdedit] [--with_sdedit2]

`--device` defaults to cuda, where the clean set and the attacks run in
bfloat16 (float32 on the CPU); `--device cpu --tiny` runs the tiny configs
at 32 px and at most 2 steps.  The attacks' SD-1.5 and SD-2.1 weights come
from --model_path and --sd2_model_path (diffusers-layout directories), else
seeded random ones.  `--int8 [MODE]` generates the clean set with w8a8
serving (`ops/quant.py`).  `main` returns {kind: (bit accuracy, TPR)}.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from aqualora_torch.eval import distortions as dist
from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.image_io import load_png, save_png
from aqualora_torch.eval.prompts import load_prompts
from aqualora_torch.ops import quant

# every kind but the SDEdit attacks, which their own flags add
DEFAULT_DISTORTIONS = ",".join(dist.DISTORTION_TYPES[:7])


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # the reference's flag names as aliases, with the two-step folded-LoRA
    # flow (--lora + --lora_scale + --msg_gt)
    p.add_argument("--model_path", "--model", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None)
    p.add_argument("--lora", type=str, default=None,
                   help="pre-folded LoRA safetensors (reference two-step "
                        "flow); pass the embedded bits via --msg_gt")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--msg_gt", type=str, default=None)
    p.add_argument("--msgdecoder_path", "--msgdecoder", type=str,
                   required=True)
    p.add_argument("--output_dir", type=str, default="eval_dist_out")
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--num_inference_steps", "--steps", type=int,
                   default=25)
    p.add_argument("--guidance_scale", "--cfg", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--fpr", "--tpr_threshold", type=float, default=1e-6)
    p.add_argument("--num_prompts", type=int, default=100)
    p.add_argument("--prompt_file", "--prompt_path", type=str,
                   default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CI/smoke)")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   choices=quant.MODE_CHOICES,
                   help="generate the clean set with int8 serving "
                        "(ops/quant.py; bare --int8 = conv-only); default "
                        "bf16, the reference protocol")
    p.add_argument("--distortions", type=str, default=DEFAULT_DISTORTIONS)
    p.add_argument("--with_sdedit", action="store_true",
                   help="include the SDEdit regeneration attack (SD-1.5 "
                        "img2img at strength 0.1)")
    p.add_argument("--with_sdedit2", action="store_true",
                   help="include SDEdit2 (SD-2.1 img2img at strength 0.2, "
                        "utils_eval.py:244-262)")
    p.add_argument("--sd2_model_path", type=str, default=None,
                   help="SD-2.1 diffusers checkpoint dir for SDEdit2")
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_attack(cfg, seed: int, model_path, version: int, args, device,
                 dtype) -> dist.SDEditAttack:
    """An SDEdit attack on its own pipeline: seeded random weights, then
    `model_path`'s when given (the U-Net's LoRA, never used here, keeps its
    values)."""
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.train.ppft_train import _load_sd_checkpoint

    pipe = StableDiffusionPipeline(cfg, dtype=dtype, device=device)
    pipe.init_params(seed)
    if model_path:
        _load_sd_checkpoint(model_path, pipe)
    return dist.SDEditAttack(pipe, load_tokenizer(
        None, vocab_size=cfg.clip.vocab_size), version=version,
        resolution=args.resolution, batch_size=args.batch_size)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    cfg = backbone = None
    if args.tiny:
        cfg, backbone = PipelineConfig.tiny(), EfficientNetConfig.tiny()
        args.msg_bits = cfg.watermark.msg_bits
        args.resolution = 32
        args.num_inference_steps = min(args.num_inference_steps, 2)
    utils_eval.square_resolution(args)
    kinds = dist.check_kinds(args.distortions.split(",")
                             + ["SDEdit"] * args.with_sdedit
                             + ["SDEdit2"] * args.with_sdedit2)
    prompts = load_prompts(args.prompt_file, args.num_prompts)
    bitstring, lora = utils_eval.resolve_watermark_lora(
        args.train_folder, args.lora, args.lora_scale, args.msg_gt,
        args.msg_bits)
    if bitstring is None:
        # fail before the (hours-long) generation pass, not after it
        raise SystemExit("--lora given without --msg_gt: cannot score "
                         "decodes against unknown bits")
    print(f"message: {bitstring}")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    gen_dir = os.path.join(args.output_dir, "clean")
    if os.path.isdir(gen_dir):
        # stale PNGs from an earlier run (another message or prompt count)
        # would corrupt every distortion's decode set
        for f in glob.glob(os.path.join(gen_dir, "*.png")):
            os.remove(f)
    utils_eval.simple_sample(
        args.model_path, args.sampler, prompts, lora=lora, seeds=[0],
        output_dir=gen_dir, num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, batch_size=args.batch_size,
        resolution=args.resolution, config=cfg, int8=args.int8,
        device=device)
    paths = sorted(glob.glob(os.path.join(gen_dir, "*.png")))
    clean = np.stack([load_png(p) for p in paths])
    imgs01 = torch.from_numpy(clean).to(device).permute(0, 3, 1, 2).float() \
        / 255.0

    sdedit = sdedit2 = None
    if args.with_sdedit:
        # --tiny drives the attacks with the tiny pipeline too
        sdedit = build_attack(cfg or PipelineConfig.sd15(None), 0,
                              args.model_path, 1, args, device, dtype)
    if args.with_sdedit2:
        sdedit2 = build_attack(cfg or PipelineConfig.sd21(None), 1,
                               args.sd2_model_path, 2, args, device, dtype)
    results = {}
    gen = torch.Generator(device=device).manual_seed(0)
    for kind in kinds:
        out_dir = os.path.join(args.output_dir, kind)
        os.makedirs(out_dir, exist_ok=True)
        distorted = dist.distortion_unit(imgs01, kind, gen, sdedit=sdedit,
                                         sdedit2=sdedit2)
        # rounded, as the clean set's save (truncation would darken every
        # distorted pixel by up to one level against the clean protocol)
        outs = []
        for p, img in zip(paths, dist.to_uint8(distorted).cpu().numpy()):
            outs.append(os.path.join(out_dir, os.path.basename(p)))
            save_png(outs[-1], img)
        bitacc, tpr, _ = utils_eval.simple_decode(
            args.msg_bits, args.msgdecoder_path, outs, msg_gt=bitstring,
            tpr_threshold=args.fpr, backbone=backbone,
            resolution=args.resolution, device=device)
        results[kind] = (bitacc, tpr)
        print(f"{kind}: bit_accuracy={bitacc:.4f} TPR={tpr:.4f}")
    print("SUMMARY:", {k: (round(a, 4), round(t, 4))
                       for k, (a, t) in results.items()})
    return results


if __name__ == "__main__":
    main()
