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

`--int8 [MODE]` also generates with w8a8 serving (`ops/quant.py`; bare
`--int8` is conv) from the same weights and seeds and reports the mean
bf16 <-> int8 image difference, the decoded-bit agreement and the logit
margins' change (asserted against `--min_int8_agreement`, 0 to disable);
`--train_decoder_steps N` also trains a tiny stage-1 decoder for N steps
(`train.latent_wm_pretrain --tiny --device cpu`, in a subprocess) and
reads both image sets through it, beside JPEG-50 and JPEG-95 controls at
full resolution (`eval/jpeg.py`).

Generation and decoding run on `--device` (cuda unless asked for the CPU);
the merge, the conversions and the file I/O run on the host.

Under `torchrun` (`core/sharding.init_distributed`, as the eval runners)
each rank generates and decodes its rows of every batch
(`utils_eval.simple_sample`, `simple_decode`), so the results equal one
process's at the batch per rank.  The world size must divide
`--batch_size` and the decoder's batch of 16 (a ValueError before any
image).  Rank 0 alone writes the synthetic release, the ported files, the
merge workflow's two files, the trained decoder and golden_gate.json, and
computes the FID smoke's Frechet distance; the ranks meet before any of
them reads what rank 0 wrote.  Each rank writes the PNGs of its own rows.

    torchrun --nproc_per_node 2 -m aqualora_torch.tools.golden_gate \\
        --synthetic --tiny --via_merge --device cpu --out /tmp/gate2

    python -m aqualora_torch.tools.golden_gate --synthetic --tiny \\
        --via_merge --device cpu --out /tmp/gate
    python -m aqualora_torch.tools.golden_gate --synthetic --tiny \\
        --int8 conv --min_int8_agreement 0 --train_decoder_steps 4 \\
        --device cpu --out /tmp/gate8
    python -m aqualora_torch.tools.golden_gate --sd_model SD15_DIR \\
        --latentwm pretrained_latentwm.pth --train_folder ppft_trained \\
        --out gate_out --min_bit_acc 0.99
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from aqualora_torch.core import sharding
from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
from aqualora_torch.core.io import load_safetensors, save_safetensors
from aqualora_torch.eval import distortions
from aqualora_torch.eval import fid as fid_mod
from aqualora_torch.eval import utils_eval
from aqualora_torch.eval.prompts import load_prompts
from aqualora_torch.ops import quant
from aqualora_torch.tools import (create_wm_lora, ldm_convert, lora_layouts,
                                  merge_lora, port_reference_artifacts,
                                  synthetic_artifacts)

Params = Dict[str, Dict[str, torch.Tensor]]


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
                   choices=quant.MODE_CHOICES,
                   help="also generate with int8 serving (ops/quant.py; "
                        "bare --int8 = conv) and report the bf16 <-> int8 "
                        "image difference and decoded-bit agreement")
    p.add_argument("--min_int8_agreement", type=float, default=0.98,
                   help="asserted lower bound on the bf16 <-> int8 "
                        "decoded-bit agreement whenever --int8 runs "
                        "(synthetic included); 0 disables")
    p.add_argument("--train_decoder_steps", type=int, default=0,
                   help="also train a tiny stage-1 decoder for N steps "
                        "(latent_wm_pretrain --tiny, CPU subprocess) and "
                        "measure the bf16 <-> int8 agreement through it, "
                        "against JPEG-50 and JPEG-95 controls; needs "
                        "--int8")
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
    merged_path = os.path.join(out_dir, "watermark_SDmodel.safetensors")
    if sharding.is_main_process():       # rank 0 writes, every rank reads
        unet_t = {k: v for k, v in params["unet"].items()
                  if ".lora." not in k}
        vae_t = dict(params["vae"])
        te_t = {f"text_model.{k}": v
                for k, v in params["text_encoder"].items()}
        # 1: the diffusers LoRA in the webui layout
        # (diffusers_lora_to_webui.py)
        webui_path = os.path.join(out_dir, "watermark.safetensors")
        save_safetensors(lora_layouts.diffusers_to_webui(lora), webui_path)
        # 2: merged into the SD states (merge_lora.py:80-127)
        merge_lora.merge_lora_into_states(unet_t, te_t,
                                          load_safetensors(webui_path))
        # 3: the single-file LDM checkpoint on disk (merge_lora.py:130-179)
        save_safetensors(ldm_convert.diffusers_to_ldm(unet_t, vae_t, te_t,
                                                      v2=v2), merged_path)
        del unet_t, vae_t, te_t
    sharding.barrier()
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


def _agreement(a, b) -> float:
    """Mean over images of the share of equal bits of two decode lists."""
    return float(np.mean([np.mean([x == y for x, y in zip(d, dq)])
                          for d, dq in zip(a, b)]))


def _logit_sensitivity(marg_bf16: np.ndarray, marg_q: np.ndarray,
                       decoded) -> dict:
    """How far the int8 path moves the decoder's logit margins, against
    the smallest margin and the spread across images
    (`scripts/golden_gate.py:300-335`)."""
    delta = np.abs(marg_bf16 - marg_q)
    spread = np.abs(marg_bf16 - marg_bf16.mean(axis=0, keepdims=True))
    min_margin = float(np.abs(marg_bf16).min())
    spread_mean = float(spread.mean())
    return {
        "mean_abs_margin": float(np.abs(marg_bf16).mean()),
        "min_abs_margin": min_margin,
        "int8_margin_delta_mean": float(delta.mean()),
        "int8_margin_delta_max": float(delta.max()),
        "cross_image_spread_mean": spread_mean,
        "max_delta_over_min_margin":
            float(delta.max() / max(min_margin, 1e-12)),
        # zero spread (one image, or a margin-constant decoder) leaves the
        # ratio undefined
        "mean_delta_over_spread":
            float(delta.mean() / spread_mean) if spread_mean > 0 else None,
        "release_decoder_bit_constant": bool(len(set(decoded)) == 1)}


def _jpeg_full_res(images, quality: int, device) -> list:
    """The protocol's JPEG at generation size (then the decoder's own
    resize): `distortions.jpeg_compress` on the images / 255, back to
    uint8 as the JAX gate does."""
    x01 = torch.from_numpy(np.stack([np.asarray(im, np.float32) / 255.0
                                     for im in images])).to(device)
    out = distortions.jpeg_compress(x01.permute(0, 3, 1, 2), None, quality)
    return list((out.permute(0, 2, 3, 1).cpu().numpy() * 255).clip(
        0, 255).astype(np.uint8))


def train_tiny_decoder(steps: int, out_dir: str) -> tuple:
    """Stage 1 at the tiny config for `steps` steps on the CPU, in a
    subprocess (`latent_wm_pretrain --tiny --warmup 0`, batch 8, epochs
    sized so the steps run) whose torch uses this process's thread count;
    -> (its SecretDecoder's state-dict file, its final bit accuracy).  Rank
    0 trains; the other ranks read its files after the barrier."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "msgdecoder.pt")
    acc_json = os.path.join(out_dir, "train_result.json")
    steps_per_epoch = max(1, 256 // 8)   # the 256-sample synthetic set
    epochs = max(1, -(-steps // steps_per_epoch))
    argv = ["--tiny", "--epochs", str(epochs), "--batch_size", "8",
            "--warmup", "0", "--max_train_steps", str(steps),
            "--output_dir", out_dir, "--log_every", str(max(1, steps // 4)),
            "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    script = (
        f"import sys, json, torch; sys.path.insert(0, {root!r})\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from aqualora_torch.train import latent_wm_pretrain as s1\n"
        f"res = s1.run(s1.build_argparser().parse_args({argv!r}))\n"
        "torch.save(res['trainer'].models.sec_decoder.state_dict(), "
        f"{path!r})\n"
        f"json.dump({{'final_acc': res['final_acc']}}, open({acc_json!r}, "
        "'w'))\n")
    if sharding.is_main_process():
        # a subprocess of its own: no torchrun variables, a world of 1
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT")}
        subprocess.run([sys.executable, "-c", script], check=True, env=env)
    sharding.barrier()
    with open(acc_json) as f:
        return path, float(json.load(f)["final_acc"])


def trained_decoder_leg(args, images, images_q) -> dict:
    """The bf16 <-> int8 agreement through a trained tiny decoder, against
    the protocol's JPEG-50 distortion and a JPEG-95 control
    (`scripts/golden_gate.py:360-488`)."""
    from aqualora_torch.core.config import WatermarkConfig
    path, final_acc = train_tiny_decoder(
        args.train_decoder_steps,
        os.path.join(args.out, "trained_tiny_decoder"))
    bits = WatermarkConfig.tiny().msg_bits
    backbone = EfficientNetConfig.tiny(num_classes=bits * 2)

    def decode(imgs):
        _, _, decoded, marg = utils_eval.simple_decode(
            bits, path, imgs, msg_gt=None,
            resolution=backbone.decoder_resolution, backbone=backbone,
            return_margins=True, device=args.device)
        return decoded, marg

    dec_t, marg_t = decode(images)
    dec_q, marg_q = decode(images_q)
    dec_50, marg_50 = decode(_jpeg_full_res(images, 50, args.device))
    dec_95, marg_95 = decode(_jpeg_full_res(images, 95, args.device))
    d_i8 = float(np.abs(marg_t - marg_q).mean())
    d_50 = float(np.abs(marg_t - marg_50).mean())
    d_95 = float(np.abs(marg_t - marg_95).mean())
    report = {"stage1_steps": args.train_decoder_steps,
              "stage1_final_acc": final_acc,
              "decode_agreement_vs_bf16": _agreement(dec_t, dec_q),
              "jpeg50_control_agreement": _agreement(dec_t, dec_50),
              "jpeg95_control_agreement": _agreement(dec_t, dec_95),
              "margin_delta_int8": d_i8, "margin_delta_jpeg50": d_50,
              "margin_delta_jpeg95": d_95,
              "int8_delta_over_jpeg50": float(d_i8 / max(d_50, 1e-12)),
              # recorded, not asserted: a default-setting decision
              "demotion_rule_met": bool(d_i8 > d_50)}
    sharding.say(f"int8[{args.int8}] trained-decoder leg: decoded-bit "
                 f"agreement vs bf16 "
                 f"{report['decode_agreement_vs_bf16']:.4f} over "
                 f"{len(images)} images (JPEG-q50 control "
                 f"{report['jpeg50_control_agreement']:.4f}, q95 "
                 f"{report['jpeg95_control_agreement']:.4f}; stage-1 "
                 f"{args.train_decoder_steps} steps, train acc "
                 f"{final_acc:.3f}); logit deltas int8 {d_i8:.4g}, "
                 f"JPEG-q50 {d_50:.4g}, q95 {d_95:.4g}")
    return report


def int8_leg(args, prompts, lora, params, images, decoded, marg_bf16,
             bit_acc, msgdecoder, sample_kw, decode_kw) -> dict:
    """Generate with int8 serving from the same weights and seeds and
    compare with the bf16 images (`scripts/golden_gate.py:280-360`)."""
    images_q = utils_eval.simple_sample(
        args.sd_model if params is None else None, args.sampler, prompts,
        lora=lora, output_dir=os.path.join(args.out,
                                           f"images_int8_{args.int8}"),
        params=params, int8=args.int8, **sample_kw)
    img_diff = _mean_abs_diff(images, images_q)
    acc_q, tpr_q, decoded_q, marg_q = utils_eval.simple_decode(
        args.msg_bits, msgdecoder, images_q, return_margins=True,
        **decode_kw)
    agree = _agreement(decoded, decoded_q)
    sens = _logit_sensitivity(marg_bf16, marg_q, decoded)
    report = {"mode": args.int8, "img_diff": img_diff,
              "bit_acc": float(acc_q), "tpr": float(tpr_q),
              "n_images": len(images), "decode_agreement_vs_bf16": agree,
              "logit_sensitivity": sens}
    ds = sens["mean_delta_over_spread"]
    sharding.say(f"int8[{args.int8}] serving: mean image diff "
                 f"{img_diff:.3f}/255, decoded-bit agreement vs bf16 "
                 f"{agree:.4f} over {len(images)} images, bit accuracy "
                 f"{acc_q:.4f} (bf16 {bit_acc:.4f}); margin delta mean "
                 f"{sens['int8_margin_delta_mean']:.4g} / max "
                 f"{sens['int8_margin_delta_max']:.4g} vs min margin "
                 f"{sens['min_abs_margin']:.4g}, delta/spread "
                 f"{f'{ds:.3f}' if ds is not None else 'n/a (zero spread)'}")
    if args.train_decoder_steps:
        report["trained_decoder"] = trained_decoder_leg(args, images,
                                                        images_q)
    if not args.synthetic and not acc_q >= args.min_bit_acc:
        raise AssertionError(f"int8 bit accuracy {acc_q:.4f} < "
                             f"{args.min_bit_acc}")
    return report


def check_int8(args, report: dict) -> None:
    """The promotion gate (`scripts/golden_gate.py:515-544`), after the
    JSON is written: the release decoder's agreement against
    --min_int8_agreement, a trained decoder's against its JPEG-50
    control."""
    if report is None or args.min_int8_agreement <= 0:
        return
    a = report["decode_agreement_vs_bf16"]
    if not a >= args.min_int8_agreement:
        raise AssertionError(f"int8[{args.int8}] decode agreement {a:.4f} < "
                             f"{args.min_int8_agreement}: int8 serving "
                             "stays opt-in")
    td = report.get("trained_decoder")
    if td and not (td["decode_agreement_vs_bf16"]
                   >= td["jpeg50_control_agreement"] - 0.005):
        raise AssertionError(
            f"int8[{args.int8}] trained-decoder agreement "
            f"{td['decode_agreement_vs_bf16']:.4f} is below its JPEG-q50 "
            f"control {td['jpeg50_control_agreement']:.4f}: int8 serving "
            "stays opt-in")


def run(args) -> dict:
    world = sharding.init_distributed(args.device)
    args.device = world.device
    sharding.check_world_divides(args.batch_size, world.size)
    sharding.check_world_divides(utils_eval.DECODE_BATCH, world.size,
                                 "the decoder's batch")
    if args.train_decoder_steps and not args.int8:
        # the trained-decoder leg measures the int8 agreement; without
        # --int8 it would never run
        raise SystemExit("--train_decoder_steps measures bf16 <-> int8 "
                         "decode agreement and requires --int8 (e.g. "
                         "--int8 conv)")
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

    main = sharding.is_main_process()
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        synth_dir = os.path.join(args.out, "reference_release")
        if main:
            synthetic_artifacts.synthesize_reference_artifacts(
                synth_dir, msg_bits=args.msg_bits,
                rank=cfg.unet.lora.rank if args.tiny else args.rank,
                unet=cfg.unet, backbone=backbone, seed=args.seed)
            print(f"synthesized reference-format artifacts in {synth_dir}")
        args.latentwm = os.path.join(synth_dir, "pretrained_latentwm.pth")
        args.train_folder = os.path.join(synth_dir, "ppft_trained")

    ported = os.path.join(args.out, "ported")
    if main:
        port_reference_artifacts.port(ported, latentwm=args.latentwm,
                                      train_folder=args.train_folder,
                                      backbone=backbone)
    sharding.barrier()
    msgdecoder = os.path.join(ported, port_reference_artifacts.MSGDECODER_FILE)

    # fold the message (the demo's path, run_gradio_demo.py:16-19)
    bitstring, lora = create_wm_lora.create_watermark_lora(
        ported, scale=1.03, msg_bits=args.msg_bits, hidinfo=args.hidinfo,
        save=False, rng=np.random.default_rng(args.seed))
    sharding.say(f"message: {bitstring} ({len(lora)} folded tensors)")

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
    sharding.say(f"generated {len(images)} images at {args.resolution}^2")
    bit_acc, tpr, decoded, marg_bf16 = utils_eval.simple_decode(
        args.msg_bits, msgdecoder, images, return_margins=True, **decode_kw)
    sharding.say(f"bit accuracy: {bit_acc:.4f}  TPR@FPR{args.fpr:g}: "
                 f"{tpr:.4f}")

    merge_img_diff = None
    if args.via_merge:
        # the merged single file must reproduce the fold path's images
        # (the runtime LoRA folded at scale 1 == the baked W + dW); its
        # generate runs with the LoRA branch off (lora=None), or the
        # message would be applied twice
        merged = merged_params_via_ldm(
            params, lora, args.out,
            v2=not args.tiny and args.model == "sd21")
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
        sharding.say(f"merge workflow: mean image diff "
                     f"{merge_img_diff:.3f}/255, bit accuracy {acc_m:.4f} "
                     f"(fold path {bit_acc:.4f}) OK")

    int8_report = None
    if args.int8:
        int8_report = int8_leg(args, prompts, lora, params, images, decoded,
                               marg_bf16, bit_acc, msgdecoder, sample_kw,
                               decode_kw)
    del params

    # the FID protocol's smoke: pool3 statistics of the generated set
    # (seeded random Inception weights)
    fid_self = None
    if len(images) >= 2:      # a covariance needs two observations
        arr = np.stack([np.asarray(im, np.float32) / 255.0 for im in images])
        feats = fid_mod.InceptionExtractor(device=args.device)(arr)
        mu, sigma = fid_mod.activation_statistics(feats)
        fid_self = sharding.broadcast_value(   # the host's sqrtm, once
            fid_mod.frechet_distance(mu, sigma, mu, sigma) if main
            else None)
        if not abs(fid_self) < 1e-3:
            raise AssertionError(f"FID protocol self-distance {fid_self} "
                                 "is not ~0")
        sharding.say(f"FID protocol smoke: self-distance {fid_self:.2e} OK")

    result = {"bit_acc": float(bit_acc), "tpr": float(tpr),
              "message": bitstring, "decoded": decoded,
              "synthetic": bool(args.synthetic),
              "model": "tiny" if args.tiny else args.model,
              "merge_img_diff": merge_img_diff, "int8": int8_report}
    if main:
        with open(os.path.join(args.out, "golden_gate.json"), "w") as f:
            json.dump(result, f, indent=1)
    check_int8(args, int8_report)
    if not args.synthetic:
        if not bit_acc >= args.min_bit_acc:
            raise AssertionError(f"bit accuracy {bit_acc:.4f} < "
                                 f"{args.min_bit_acc}: parity gate FAILED")
        sharding.say("GOLDEN GATE PASSED")
    else:
        sharding.say("plumbing gate passed (synthetic weights: accuracy "
                     "reported, not asserted)")
    return result


def main(argv=None) -> dict:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
