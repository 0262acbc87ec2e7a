"""FID benchmark (`evaluation/run_fid.py`, the Tree-Ring protocol), in PyTorch.

The port of `aqualora_tpu/eval/run_fid.py`: generate N images (default
5000) from COCO captions with the watermark LoRA (50 steps, CFG 7.5,
512x512, `run_fid.py:78-85` of the reference), write them as PNGs, then the
FID of that folder against the ground-truth folder or its .npz statistics
(`eval/fid.py`); the result goes to `<output_dir>/fid.json`.

    python -m aqualora_torch.eval.run_fid --meta_data meta_data.json \\
        --gt_dir COCO_DIR --train_folder DIR \\
        --inception_torch_weights pt_inception-2015-12-05-6726825d.pth

The Inception weights are resolved before the generation pass: without
them the runner stops at once (`--allow_random_inception` runs seeded
random ones, whose FID is meaningless).  `--device` defaults to cuda;
`--tiny --device cpu` runs the tiny configs at 32 px and at most 2 steps,
with the full InceptionV3.  `--int8` is refused (ROADMAP A.8).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.fid import InceptionExtractor, fid_given_paths


def load_captions(meta_path: str, n: int, start: int = 0):
    """COCO meta_data.json captions (`run_fid.py:29-33`: a dict with
    'annotations' rows carrying 'caption', or a list) or metadata.jsonl
    ('text' per line)."""
    caps = []
    if meta_path.endswith(".jsonl"):
        with open(meta_path) as f:
            for line in f:
                caps.append(json.loads(line).get("text", ""))
    else:
        with open(meta_path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("annotations", list(data.values()))
        for row in data:
            caps.append(row if isinstance(row, str)
                        else row.get("caption", row.get("text", "")))
    return caps[start:start + n]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # the reference's flag names (evaluation/run_fid.py:76-96) as aliases
    p.add_argument("--model_path", "--model_id", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None,
                   help="watermark LoRA folder (omit for the clean "
                        "baseline)")
    p.add_argument("--lora", type=str, default=None,
                   help="pre-folded LoRA safetensors file or the folder "
                        "holding pytorch_lora_weights.safetensors "
                        "(reference two-step flow)")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--meta_data", "--prompt_file", type=str, required=True)
    p.add_argument("--gt_dir", "--gt_folder", type=str, required=True,
                   help="ground-truth image dir (or precomputed .npz stats)")
    p.add_argument("--output_dir", type=str, default="fid_out")
    p.add_argument("--num_images", type=int, default=5000)
    p.add_argument("--start", type=int, default=0,
                   help="first caption index (reference --start)")
    p.add_argument("--end", type=int, default=None,
                   help="exclusive end caption index (overrides "
                        "--num_images, reference --end)")
    p.add_argument("--gen_seed", type=int, default=0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--resolution", "--image_length", type=int, default=512)
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--inception_params", type=str, default=None,
                   help="the port's own file of FID Inception weights: a "
                        "state dict of models/inception.InceptionV3Features "
                        "saved with torch.save (the JAX package's orbax "
                        "directories are not read)")
    p.add_argument("--inception_torch_weights", type=str, default=None,
                   help="torch FID InceptionV3 checkpoint "
                        "(pt_inception-2015-12-05 layout, "
                        "pytorch_fid/inception.py:16) imported directly")
    p.add_argument("--allow_random_inception", action="store_true",
                   help="permit a randomly initialized Inception (smoke "
                        "tests only: the FID is meaningless)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CI/smoke)")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   help="not ported (ROADMAP A.8): refused")
    p.add_argument("--device", type=str, default="cuda")
    return p


def resolve_extractor(args) -> InceptionExtractor:
    """The extractor of the run's weights, built before any generation."""
    if args.inception_torch_weights:
        from aqualora_torch.tools.torch_import import inception_from_torch
        return InceptionExtractor(
            inception_from_torch(args.inception_torch_weights), args.device)
    if args.inception_params:
        import torch
        return InceptionExtractor(
            torch.load(args.inception_params, map_location="cpu",
                       weights_only=True), args.device)
    if not args.allow_random_inception:
        # a random-init Inception prints a plausible but meaningless FID
        raise SystemExit(
            "no Inception weights: pass --inception_torch_weights or "
            "--inception_params (or --allow_random_inception for a smoke "
            "run whose FID is meaningless)")
    return InceptionExtractor(device=args.device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.int8:
        raise SystemExit("--int8: int8 serving is not ported (ROADMAP A.8)")
    cfg = None
    if args.tiny:
        from aqualora_torch.core.config import PipelineConfig
        cfg = PipelineConfig.tiny()
        args.msg_bits = cfg.watermark.msg_bits
        args.resolution = 32
        args.num_inference_steps = min(args.num_inference_steps, 2)
    n = (args.end - args.start if args.end is not None
         else args.num_images)
    captions = load_captions(args.meta_data, n, start=args.start)
    # before the (hours-long) generation pass: a missing-weights exit after
    # 5000 images at 50 steps would throw the run away
    extractor = resolve_extractor(args)

    lora = None
    if args.lora or args.train_folder:
        # both flows go through resolve_watermark_lora for its guards:
        # exactly one source, no --lora_scale with --train_folder
        path = args.lora
        if path and os.path.isdir(path):
            path = os.path.join(path, "pytorch_lora_weights.safetensors")
        bitstring, lora = utils_eval.resolve_watermark_lora(
            args.train_folder, path, args.lora_scale, None, args.msg_bits,
            rng=np.random.default_rng(0))
        if bitstring is not None:
            print(f"message: {bitstring}")

    gen_dir = os.path.join(args.output_dir, "images")
    if os.path.isdir(gen_dir):
        # stale PNGs of an earlier run would corrupt the FID set
        for f in glob.glob(os.path.join(gen_dir, "*.png")):
            os.remove(f)
    utils_eval.simple_sample(
        args.model_path, args.sampler, captions, lora=lora,
        seeds=[args.gen_seed], output_dir=gen_dir,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, batch_size=args.batch_size,
        resolution=args.resolution, config=cfg, device=args.device)

    fid = fid_given_paths(gen_dir, args.gt_dir, extractor=extractor)
    print(f"FID: {fid:.4f}")
    result = {"fid": float(fid), "n_images": len(captions),
              "random_inception": bool(args.allow_random_inception
                                       and not args.inception_params
                                       and not args.inception_torch_weights),
              "int8": None}
    with open(os.path.join(args.output_dir, "fid.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
