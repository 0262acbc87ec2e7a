#!/usr/bin/env python3
"""How far the merge workflow's single file is from the fold path, on one
CUDA card, with seeded random SD weights and synthetic release files.

The golden gate (`aqualora_torch/tools/golden_gate.py --via_merge`) holds
the images of a checkpoint merged on the host against those of the
pipeline's fold on the card (mean |d| < 4/255).  This script measures,
for one model and resolution, 2 prompts at B2, dpms_m-25:

  - two fold-path generations from the same weights (determinism);
  - the port's merge (`tools/merge_lora.py`: the delta summed in float64,
    rounded to float32 once, as `models/lora.fold_lora_tree` does) and a
    merge whose delta is summed in float32 by numpy (the JAX package's
    arithmetic): for each, the U-Net weights that differ from the folded
    ones once both are rounded to bf16, and the mean |d| of the images.

    python3 scripts/torch_fold_merge_probe.py --model sd15 --resolution 512
    python3 scripts/torch_fold_merge_probe.py --model sd21 --resolution 768
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _f32_merge(unet, lora_state):
    """merge_lora_into_states with the delta summed in float32 (numpy), for
    the sites this LoRA has (all linear or 1x1)."""
    from aqualora_torch.tools.merge_lora import webui_name_to_module
    table = webui_name_to_module()
    for name in sorted({k.rsplit(".", 2)[0] for k in lora_state
                        if ".lora_down." in k}):
        down = lora_state[f"{name}.lora_down.weight"].float().numpy()
        up = lora_state[f"{name}.lora_up.weight"].float().numpy()
        key = f"{table[name][1]}.weight"
        w = unet[key].float().numpy()
        if down.ndim == 2:
            delta = up @ down
        else:
            delta = (up[:, :, 0, 0] @ down[:, :, 0, 0])[:, :, None, None]
        unet[key] = torch.from_numpy(w + delta)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("sd15", "sd21"), default="sd15")
    p.add_argument("--resolution", type=int, default=512)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.io import import_lora_safetensors
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.eval import utils_eval
    from aqualora_torch.eval.prompts import load_prompts
    from aqualora_torch.tools import (create_wm_lora, golden_gate,
                                      lora_layouts, port_reference_artifacts,
                                      synthetic_artifacts)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = (PipelineConfig.sd21(320) if args.model == "sd21"
           else PipelineConfig.sd15(320))
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_artifacts.synthesize_reference_artifacts(
            f"{tmp}/rel", unet=cfg.unet, backbone=EfficientNetConfig.b1(96))
        port_reference_artifacts.port(
            f"{tmp}/p", f"{tmp}/rel/pretrained_latentwm.pth",
            f"{tmp}/rel/ppft_trained")
        _, lora = create_wm_lora.create_watermark_lora(
            f"{tmp}/p", save=False, rng=np.random.default_rng(0))
        params = golden_gate.base_params(cfg, None, "cuda")
        prompts = load_prompts(None, 2)
        kw = dict(seeds=[0], config=cfg, num_inference_steps=25,
                  batch_size=2, resolution=args.resolution, device="cuda")

        def sample(weights, folded):
            return utils_eval.simple_sample(
                None, "dpms_m", prompts, lora=lora if folded else None,
                params=weights, **kw)

        def diff(a, b):
            return float(np.mean([np.abs(x.astype(np.int16)
                                         - y.astype(np.int16)).mean()
                                  for x, y in zip(a, b)]))

        fold = sample(params, True)
        again = sample(params, True)
        pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16,
                                       device="cuda")
        pipe.unet.load_state_dict(params["unet"])
        import_lora_safetensors(pipe.unet, cfg.unet, lora)
        pipe.fold_diag(torch.ones(cfg.unet.lora.rank))
        folded = {k: v for k, v in pipe.unet.state_dict().items()
                  if v.dtype == torch.bfloat16}
        del pipe
        merged = golden_gate.merged_params_via_ldm(
            params, lora, tmp, v2=args.model == "sd21")
        f32 = dict(merged)
        f32["unet"] = {k: v for k, v in params["unet"].items()}
        _f32_merge(f32["unet"], lora_layouts.diffusers_to_webui(lora))
        print(f"{args.model} {args.resolution}^2 B2 dpms_m-25, seeded "
              f"random weights: fold vs fold {diff(fold, again):.4f}/255 "
              f"| {smi}", flush=True)
        for tag, weights in (("the port's merge (float64 sum)", merged),
                             ("a float32-sum merge (JAX's arithmetic)",
                              f32)):
            flips = sum(int((weights["unet"][k].to("cuda", torch.bfloat16)
                             != v).sum()) for k, v in folded.items())
            total = sum(v.numel() for v in folded.values())
            d = diff(fold, sample(weights, False))
            print(f"{tag}: {flips} of {total} bf16 U-Net weights differ "
                  f"from the fold's; images {d:.4f}/255 from the fold "
                  f"path's | {smi}", flush=True)


if __name__ == "__main__":
    main()
