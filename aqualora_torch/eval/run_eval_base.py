"""TPR / bit-accuracy benchmark (`evaluation/run_eval_base.py`), in PyTorch.

The port of `aqualora_tpu/eval/run_eval_base.py`.  Protocol: 100 prompts x
10 seed-sets, DPM-Solver++ (dpms_m) 25 steps, CFG 7.5, 512x512, FPR 1e-6
(`run_eval_base.py:15-54` of the reference); generate with a
message-folded watermark LoRA, write the PNGs, then decode every PNG and
report bit accuracy and TPR (`eval_base.json`).

    python -m aqualora_torch.eval.run_eval_base --train_folder DIR \\
        --msgdecoder_path DIR/msgdecoder.pt [--hidinfo 0101...]
    python -m aqualora_torch.eval.run_eval_base --lora FOLDED.safetensors \\
        --msg_gt 0101... --msgdecoder_path DIR/msgdecoder.pt

`--device` defaults to cuda; `--device cpu --tiny` runs the tiny configs
at 32 px and at most 2 steps.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.prompts import load_prompts


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # the reference's flag names (run_eval_base.py:9-26) as aliases, with
    # the two-step folded-LoRA flow (--lora + --lora_scale + --msg_gt)
    p.add_argument("--model_path", "--model", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None)
    p.add_argument("--lora", type=str, default=None,
                   help="pre-folded LoRA safetensors (reference two-step "
                        "flow); pass the embedded bits via --msg_gt")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--msg_gt", type=str, default=None)
    p.add_argument("--msgdecoder_path", "--msgdecoder", type=str,
                   default=None,
                   help="the port's msgdecoder.pt; omit to generate images "
                        "without decoding (the reference's behaviour when "
                        "--msgdecoder is unset)")
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--num_inference_steps", "--steps", type=int,
                   default=25)
    p.add_argument("--guidance_scale", "--cfg", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--fpr", "--tpr_threshold", type=float, default=1e-6)
    p.add_argument("--num_seeds", type=int, default=10)
    p.add_argument("--num_prompts", type=int, default=100)
    p.add_argument("--prompt_file", "--prompt_path", type=str,
                   default=None)
    p.add_argument("--hidinfo", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CI/smoke)")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   help="not ported (ROADMAP A.10): refused")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.int8:
        raise SystemExit("--int8: int8 serving is not ported (ROADMAP A.10)")
    cfg = backbone = None
    if args.tiny:
        from aqualora_torch.core.config import (EfficientNetConfig,
                                                PipelineConfig)
        cfg, backbone = PipelineConfig.tiny(), EfficientNetConfig.tiny()
        args.msg_bits = cfg.watermark.msg_bits
        args.resolution = 32
        args.num_inference_steps = min(args.num_inference_steps, 2)
    utils_eval.square_resolution(args)
    prompts = load_prompts(args.prompt_file, args.num_prompts)
    bitstring, lora = utils_eval.resolve_watermark_lora(
        args.train_folder, args.lora, args.lora_scale, args.msg_gt,
        args.msg_bits, hidinfo=args.hidinfo)
    if args.msgdecoder_path is not None and bitstring is None:
        # fail BEFORE the (hours-long) generation pass, not after it
        raise SystemExit("--lora given without --msg_gt: cannot score "
                         "decodes against unknown bits")
    print(f"message: {bitstring}")

    gen_dir = os.path.join(args.output_dir, "images")
    if os.path.isdir(gen_dir):
        # stale PNGs from an earlier run (another message or prompt count)
        # would corrupt the decode set
        for f in glob.glob(os.path.join(gen_dir, "*.png")):
            os.remove(f)
    # all seed-sets in one call: the pipeline is built once
    utils_eval.simple_sample(
        args.model_path, args.sampler, prompts, lora=lora,
        seeds=list(range(args.num_seeds)), output_dir=gen_dir,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        batch_size=args.batch_size, resolution=args.resolution,
        config=cfg, device=args.device)

    images = sorted(glob.glob(os.path.join(gen_dir, "*.png")))
    if args.msgdecoder_path is None:
        print(f"generated {len(images)} images (no --msgdecoder_path: "
              "decode skipped, reference parity)")
        result = {"bit_acc": None, "tpr": None, "n_images": len(images),
                  "message": bitstring, "sampler": args.sampler,
                  "int8": None}
        # a generation-only run still leaves the result file that
        # downstream tooling reads
        with open(os.path.join(args.output_dir, "eval_base.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
        return result
    bitacc, tpr, _ = utils_eval.simple_decode(
        args.msg_bits, args.msgdecoder_path, images, msg_gt=bitstring,
        tpr_threshold=args.fpr, backbone=backbone,
        resolution=args.resolution, device=args.device)
    print(f"FINAL bit_accuracy={bitacc:.4f} TPR={tpr:.4f} "
          f"({len(images)} images)")
    result = {"bit_acc": float(bitacc), "tpr": float(tpr),
              "n_images": len(images), "message": bitstring,
              "sampler": args.sampler, "fpr": args.fpr, "int8": None}
    with open(os.path.join(args.output_dir, "eval_base.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
