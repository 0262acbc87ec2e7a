"""Perceptual fidelity benchmark (`evaluation/run_dreamsim.py`), in PyTorch.

The port of `aqualora_tpu/eval/run_dreamsim.py`: the same prompts generated
with and without the watermark LoRA at the same seeds
(`run_dreamsim.py:49-79` of the reference), then the mean DreamSim distance
over the pairs (`eval/dreamsim.py`).

    python -m aqualora_torch.eval.run_dreamsim --train_folder DIR \\
        --dreamsim_cache_dir DREAMSIM_CKPT_DIR

The DreamSim weights are resolved before the generation passes: without
them the runner stops at once (`--allow_random_weights` runs seeded random
ones, whose distance is meaningless).  `--device` defaults to cuda; `--tiny
--device cpu` runs the tiny configs at 32 px and at most 2 steps, and
ViTs of width 32, depth 1 and 2 heads.  `--int8` is refused (ROADMAP A.8).
"""

from __future__ import annotations

import argparse

import numpy as np

from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.dreamsim import MODEL_CONFIGS, DreamSim
from aqualora_torch.eval.prompts import load_prompts


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # the reference's flag names (evaluation/run_dreamsim.py) as aliases,
    # with the two-step folded-LoRA flow (--lora file)
    p.add_argument("--model_path", "--model", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None)
    p.add_argument("--lora", type=str, default=None,
                   help="pre-folded LoRA safetensors (reference two-step "
                        "flow)")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--num_prompts", type=int, default=100)
    p.add_argument("--prompt_file", "--prompt_path", type=str, default=None)
    p.add_argument("--guidance_scale", "--cfg", type=float, default=7.5)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--num_inference_steps", "--steps", type=int, default=25)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--dreamsim_params", type=str, default=None,
                   help="the port's own file of DreamSim weights: "
                        "{backbone name: ViTB16 state dict} saved with "
                        "torch.save (the JAX package's orbax directories "
                        "are not read)")
    p.add_argument("--dreamsim_cache_dir", type=str, default=None,
                   help="unzipped reference DreamSim checkpoint dir "
                        "(dreamsim/model.py:160-191) imported directly")
    p.add_argument("--dreamsim_type", type=str, default="ensemble",
                   choices=list(MODEL_CONFIGS))
    p.add_argument("--allow_random_weights", action="store_true",
                   help="permit a randomly initialized DreamSim ensemble "
                        "(smoke tests only: the distance is meaningless)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CI/smoke)")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   help="not ported (ROADMAP A.8): refused")
    p.add_argument("--device", type=str, default="cuda")
    return p


def resolve_params(args):
    """The DreamSim weights of the run (None: seeded random ones), read
    before any generation."""
    if args.dreamsim_cache_dir:
        from aqualora_torch.tools.torch_import import dreamsim_from_torch
        return dreamsim_from_torch(args.dreamsim_cache_dir,
                                   args.dreamsim_type)
    if args.dreamsim_params:
        import torch
        return torch.load(args.dreamsim_params, map_location="cpu",
                          weights_only=True)
    if not args.allow_random_weights:
        # a random-init ensemble prints a plausible but meaningless
        # distance
        raise SystemExit(
            "no DreamSim weights: pass --dreamsim_cache_dir or "
            "--dreamsim_params (or --allow_random_weights for a smoke "
            "run whose distance is meaningless)")
    return None


def main(argv=None) -> np.ndarray:
    """-> the distance of each pair."""
    args = build_argparser().parse_args(argv)
    if args.int8:
        raise SystemExit("--int8: int8 serving is not ported (ROADMAP A.8)")
    cfg = vit_overrides = None
    if args.tiny:
        from aqualora_torch.core.config import PipelineConfig
        cfg = PipelineConfig.tiny()
        args.msg_bits = cfg.watermark.msg_bits
        args.resolution = 32
        args.num_inference_steps = min(args.num_inference_steps, 2)
        vit_overrides = {"dim": 32, "depth": 1, "heads": 2}
    prompts = load_prompts(args.prompt_file, args.num_prompts)
    utils_eval.square_resolution(args)
    bitstring, lora = utils_eval.resolve_watermark_lora(
        args.train_folder, args.lora, args.lora_scale, None, args.msg_bits)
    print(f"message: {bitstring}")
    # before the (hours-long) paired generation passes
    params = resolve_params(args)

    common = dict(seeds=[0], num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale,
                  batch_size=args.batch_size, resolution=args.resolution,
                  config=cfg, device=args.device)
    imgs_wm = utils_eval.simple_sample(args.model_path, args.sampler,
                                       prompts, lora=lora, **common)
    imgs_clean = utils_eval.simple_sample(args.model_path, args.sampler,
                                          prompts, lora=None, **common)

    ds = DreamSim(params=params, dreamsim_type=args.dreamsim_type,
                  vit_overrides=vit_overrides, device=args.device)
    a = np.stack([np.asarray(i, np.float32) / 255.0 for i in imgs_wm])
    b = np.stack([np.asarray(i, np.float32) / 255.0 for i in imgs_clean])
    dists = np.concatenate([ds(a[i:i + args.batch_size],
                               b[i:i + args.batch_size])
                            for i in range(0, len(a), args.batch_size)])
    print(f"mean DreamSim distance: {float(dists.mean()):.6f}")
    return dists


if __name__ == "__main__":
    main()
