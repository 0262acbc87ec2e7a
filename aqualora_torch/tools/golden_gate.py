"""The golden parity gate: one command that drives the release's artifact
protocol end to end.

The port of `scripts/golden_gate.py`.  Given SD weights and the reference
release (`README.md:46-51`: pretrained_latentwm.pth and
ppft_trained/{lora, mapper.pt, msgdecoder.pt}), it runs the reference's
serving path (`run_gradio_demo.py:10-29`, `evaluation/run_eval_base.py`):

  port -> create_wm_lora fold -> generate (DPM-Solver++ 25) -> decode
  -> bit accuracy + TPR (tau from the FPR)  [+ the FID protocol's smoke]

and asserts bit accuracy >= --min_bit_acc (0.99).  `--synthetic` first
writes random-weight artifacts in the reference's file formats
(`tools/synthetic_artifacts.py`), so the gate runs without the published
checkpoints; the accuracy is then reported, not asserted (random weights
carry no message).  `--via_merge` also drives the README's merge workflow:
the folded LoRA in the webui layout, merged into the SD weights, written
as a single-file LDM checkpoint, read back and generated from with the
LoRA branch off; its images must match the fold path's.

Generation and decoding run on `--device` (cuda unless asked for the CPU);
the merge, the conversions and the file I/O run on the host.  The w8a8
legs (`--int8`, `--train_decoder_steps`) are not ported (ROADMAP A.8).

    python -m aqualora_torch.tools.golden_gate --synthetic --tiny \\
        --via_merge --device cpu --out /tmp/gate
    python -m aqualora_torch.tools.golden_gate --sd_model SD15_DIR \\
        --latentwm pretrained_latentwm.pth --train_folder ppft_trained \\
        --out gate_out --min_bit_acc 0.99
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
from aqualora_torch.core.io import load_safetensors, save_safetensors
from aqualora_torch.eval import fid as fid_mod
from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.prompts import load_prompts
from aqualora_torch.tools import (create_wm_lora, ldm_convert, lora_layouts,
                                  merge_lora, port_reference_artifacts,
                                  synthetic_artifacts)

Params = Dict[str, Dict[str, torch.Tensor]]

UNPORTED = "int8 serving is not ported (ROADMAP A.8)"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--sd_model", type=str, default=None,
                   help="diffusers-layout SD checkpoint directory; seeded "
                        "random weights when absent")
    p.add_argument("--latentwm", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="write reference-format artifacts first")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (CPU scale)")
    p.add_argument("--model", type=str, default="sd15",
                   choices=("sd15", "sd21"),
                   help="pipeline family (ignored with --tiny)")
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--rank", type=int, default=320)
    p.add_argument("--hidinfo", type=str, default=None)
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--num_prompts", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--fpr", type=float, default=1e-6)
    p.add_argument("--min_bit_acc", type=float, default=0.99,
                   help="asserted unless --synthetic")
    p.add_argument("--via_merge", action="store_true",
                   help="also drive the README merge workflow "
                        "(README.md:39-43): folded LoRA -> webui layout -> "
                        "merge_lora -> LDM checkpoint -> reload -> "
                        "generate; asserts that the merged model "
                        "reproduces the fold path's images")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   help="not ported (ROADMAP A.8): refused")
    p.add_argument("--min_int8_agreement", type=float, default=0.98,
                   help="the --int8 leg's bound (ROADMAP A.8)")
    p.add_argument("--train_decoder_steps", type=int, default=0,
                   help="not ported (ROADMAP A.8): refused")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def base_params(cfg: PipelineConfig, sd_model: Optional[str],
                device: str | torch.device) -> Params:
    """The base weights both compared paths start from, float32 on the
    host: the pipeline's seeded init (as `simple_sample` draws it) on
    `device`, or `sd_model` loaded over it."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    pipe = StableDiffusionPipeline(cfg, device=device)
    pipe.init_params(seed=0)
    if sd_model:
        from aqualora_torch.train.ppft_train import _load_sd_checkpoint
        _load_sd_checkpoint(sd_model, pipe)
    return {name: {k: v.cpu() for k, v in module.state_dict().items()}
            for name, module in (("text_encoder", pipe.clip),
                                 ("unet", pipe.unet), ("vae", pipe.vae),
                                 ("mapper", pipe.mapper))}


def merged_params_via_ldm(params: Params, lora: Dict[str, torch.Tensor],
                          out_dir: str, v2: bool = False) -> Params:
    """The README's merge workflow (README.md:39-43) on real files:
    diffusers_lora_to_webui -> merge_lora into the SD states -> a
    single-file LDM checkpoint -> read back and converted to the port's
    state dicts.  Returns the weights to generate from with no runtime LoRA
    (the message is in the base weights; the U-Net's LoRA tensors are the
    ones of `params`, which a generate with the LoRA branch off never
    reads).  `v2` writes SD-2.x's single-file layout (the open-CLIP tower,
    linear proj_in/out; model_util.py:244-392,560-574); the reader finds it
    by itself.  The text encoder goes in under `text_model.` with the
    port's own names (no `embeddings.` / `encoder.`), as the JAX gate
    writes it (`scripts/golden_gate.py:122-124`)."""
    unet_t = {k: v for k, v in params["unet"].items() if ".lora." not in k}
    vae_t = dict(params["vae"])
    te_t = {f"text_model.{k}": v for k, v in params["text_encoder"].items()}

    # 1: the diffusers LoRA in the webui layout (diffusers_lora_to_webui.py)
    webui_path = os.path.join(out_dir, "watermark.safetensors")
    save_safetensors(lora_layouts.diffusers_to_webui(lora), webui_path)
    # 2: merged into the SD states (merge_lora.py:80-127)
    merge_lora.merge_lora_into_states(unet_t, te_t,
                                      load_safetensors(webui_path))
    # 3: the single-file LDM checkpoint on disk (merge_lora.py:130-179)
    merged_path = os.path.join(out_dir, "watermark_SDmodel.safetensors")
    save_safetensors(ldm_convert.diffusers_to_ldm(unet_t, vae_t, te_t, v2=v2),
                     merged_path)
    del unet_t, vae_t, te_t
    # the consumer's side: LDM -> diffusers -> the port's modules
    u_new, v_new, t_new = ldm_convert.ldm_to_diffusers(
        load_safetensors(merged_path))
    out = dict(params)
    out["unet"] = {k: (v if ".lora." in k else u_new[k])
                   for k, v in params["unet"].items()}
    out["vae"] = v_new
    t_new = {k[len("text_model."):] if k.startswith("text_model.") else k: v
             for k, v in t_new.items()}
    out["text_encoder"] = {k.replace("embeddings.", "").replace("encoder.",
                                                                ""): v
                           for k, v in t_new.items()
                           if "position_ids" not in k}
    return out


def _mean_abs_diff(images, others) -> float:
    return float(np.mean([np.abs(np.asarray(a, np.int16)
                                 - np.asarray(b, np.int16)).mean()
                          for a, b in zip(images, others)]))


def run(args) -> dict:
    if args.int8:
        raise SystemExit(f"--int8: {UNPORTED}")
    if args.train_decoder_steps:
        raise SystemExit(f"--train_decoder_steps: the trained-decoder leg "
                         f"measures the int8 agreement; {UNPORTED}")
    if args.tiny:
        cfg = PipelineConfig.tiny()
        backbone = EfficientNetConfig.tiny(num_classes=args.msg_bits * 2)
        args.resolution = min(args.resolution, 64)
        args.num_inference_steps = min(args.num_inference_steps, 4)
    else:
        cfg = (PipelineConfig.sd21(lora_rank=args.rank)
               if args.model == "sd21"
               else PipelineConfig.sd15(lora_rank=args.rank))
        backbone = EfficientNetConfig.b1(num_classes=args.msg_bits * 2)
    if cfg.watermark.msg_bits != args.msg_bits:
        cfg = dataclasses.replace(cfg, watermark=dataclasses.replace(
            cfg.watermark, msg_bits=args.msg_bits))

    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        synth_dir = os.path.join(args.out, "reference_release")
        synthetic_artifacts.synthesize_reference_artifacts(
            synth_dir, msg_bits=args.msg_bits,
            rank=cfg.unet.lora.rank if args.tiny else args.rank,
            unet=cfg.unet, backbone=backbone, seed=args.seed)
        args.latentwm = os.path.join(synth_dir, "pretrained_latentwm.pth")
        args.train_folder = os.path.join(synth_dir, "ppft_trained")
        print(f"synthesized reference-format artifacts in {synth_dir}")

    ported = os.path.join(args.out, "ported")
    port_reference_artifacts.port(ported, latentwm=args.latentwm,
                                  train_folder=args.train_folder,
                                  backbone=backbone)
    msgdecoder = os.path.join(ported, port_reference_artifacts.MSGDECODER_FILE)

    # fold the message (the demo's path, run_gradio_demo.py:16-19)
    bitstring, lora = create_wm_lora.create_watermark_lora(
        ported, scale=1.03, msg_bits=args.msg_bits, hidinfo=args.hidinfo,
        save=False, rng=np.random.default_rng(args.seed))
    print(f"message: {bitstring} ({len(lora)} folded tensors)")

    # one base-weight set shared by the compared paths
    params = (base_params(cfg, args.sd_model, args.device)
              if args.via_merge else None)
    prompts = load_prompts(None, args.num_prompts)
    sample_kw = dict(seeds=[args.seed], config=cfg,
                     num_inference_steps=args.num_inference_steps,
                     batch_size=args.batch_size, resolution=args.resolution,
                     device=args.device)
    decode_kw = dict(msg_gt=bitstring, resolution=backbone.decoder_resolution,
                     tpr_threshold=args.fpr, backbone=backbone,
                     device=args.device)
    images = utils_eval.simple_sample(
        args.sd_model if params is None else None, args.sampler, prompts,
        lora=lora, output_dir=os.path.join(args.out, "images"),
        params=params, **sample_kw)
    print(f"generated {len(images)} images at {args.resolution}^2")
    bit_acc, tpr, decoded = utils_eval.simple_decode(
        args.msg_bits, msgdecoder, images, **decode_kw)
    print(f"bit accuracy: {bit_acc:.4f}  TPR@FPR{args.fpr:g}: {tpr:.4f}")

    merge_img_diff = None
    if args.via_merge:
        # the merged single file must reproduce the fold path's images
        # (the runtime LoRA folded at scale 1 == the baked W + dW); its
        # generate runs with the LoRA branch off (lora=None), or the
        # message would be applied twice
        merged = merged_params_via_ldm(
            params, lora, args.out,
            v2=not args.tiny and args.model == "sd21")
        del params
        images_m = utils_eval.simple_sample(
            None, args.sampler, prompts, lora=None,
            output_dir=os.path.join(args.out, "images_merged"),
            params=merged, **sample_kw)
        del merged
        merge_img_diff = _mean_abs_diff(images, images_m)
        if not merge_img_diff < 4.0:
            raise AssertionError(
                f"merged-model images diverge from the fold path: mean abs "
                f"diff {merge_img_diff:.2f}/255")
        acc_m, _, _ = utils_eval.simple_decode(args.msg_bits, msgdecoder,
                                               images_m, **decode_kw)
        print(f"merge workflow: mean image diff {merge_img_diff:.3f}/255, "
              f"bit accuracy {acc_m:.4f} (fold path {bit_acc:.4f}) OK")

    # the FID protocol's smoke: pool3 statistics of the generated set
    # (seeded random Inception weights)
    fid_self = None
    if len(images) >= 2:      # a covariance needs two observations
        arr = np.stack([np.asarray(im, np.float32) / 255.0 for im in images])
        feats = fid_mod.InceptionExtractor(device=args.device)(arr)
        mu, sigma = fid_mod.activation_statistics(feats)
        fid_self = fid_mod.frechet_distance(mu, sigma, mu, sigma)
        if not abs(fid_self) < 1e-3:
            raise AssertionError(f"FID protocol self-distance {fid_self} "
                                 "is not ~0")
        print(f"FID protocol smoke: self-distance {fid_self:.2e} OK")

    result = {"bit_acc": float(bit_acc), "tpr": float(tpr),
              "message": bitstring, "decoded": decoded,
              "synthetic": bool(args.synthetic),
              "model": "tiny" if args.tiny else args.model,
              "merge_img_diff": merge_img_diff, "int8": None}
    with open(os.path.join(args.out, "golden_gate.json"), "w") as f:
        json.dump(result, f, indent=1)
    if not args.synthetic:
        if not bit_acc >= args.min_bit_acc:
            raise AssertionError(f"bit accuracy {bit_acc:.4f} < "
                                 f"{args.min_bit_acc}: parity gate FAILED")
        print("GOLDEN GATE PASSED")
    else:
        print("plumbing gate passed (synthetic weights: accuracy reported, "
              "not asserted)")
    return result


def main(argv=None) -> dict:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
