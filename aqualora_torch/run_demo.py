"""End-to-end watermarking demo (the port of the top-level `run_demo.py`,
the reference's `run_gradio_demo.py`).

process(): fold a secret into the trained LoRA (create_wm_lora, save=False)
-> generate with DDIM -> decode the bits back -> report
(`run_gradio_demo.py:10-29`).  Comma-separated secrets generate one batch
with a distinct watermark per image (simple_sample's per-image messages).

Runs as a Gradio app with --web when gradio is installed (the same
controls: model path, AquaLoRA folder, 48-bit secret, prompt/negative,
steps/cfg/seed sliders, `run_gradio_demo.py:32-58`); otherwise as a CLI
that writes PNGs and prints the decoded bits:

    python -m aqualora_torch.run_demo --aqualora_folder DIR [--secret BITS]
    python -m aqualora_torch.run_demo --tiny --device cpu --aqualora_folder DIR

The folder is a PPFT output (`pytorch_lora_weights.safetensors`,
`mapper.safetensors`, `msgdecoder.pt`).  Runs on the CUDA card unless
--device says otherwise.

Under `torchrun` (`core/sharding.init_distributed`, as the eval runners)
each rank generates and decodes its rows of the batch, so the images and
bits equal one process's at the batch per rank; the world size must divide
the batch (one image, or one a comma-separated secret) and the decoder's
16, else a ValueError before any image.  Each rank writes its own rows'
PNGs; rank 0 prints:

    torchrun --nproc_per_node 2 -m aqualora_torch.run_demo --tiny \\
        --device cpu --aqualora_folder DIR --secret ,
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aqualora_torch.core import sharding
from aqualora_torch.eval.utils_eval import (DECODE_BATCH, simple_decode,
                                            simple_sample)
from aqualora_torch.tools.create_wm_lora import create_watermark_lora
from aqualora_torch.train.ppft_train import MSGDECODER_FILE


def process(src_model: str | None, aqualora_folder: str, secret: str,
            prompt: str, negative_prompt: str = "", steps: int = 25,
            cfg: float = 7.5, seed: int = 0, msg_bits: int = 48,
            msgdecoder_path: str | None = None, resolution: int = 512,
            output_dir: str | None = None, int8=False,
            config=None, backbone=None, device: str = "cuda",
            batch_size: int | None = None):
    """-> (images as HWC uint8 arrays, the embedded bitstring (a list of
    them for comma-separated secrets), the decoded bitstrings or None when
    no decoder is found).  The images go through the pipeline in batches of
    `batch_size`, by default all in one (across the ranks under
    `torchrun`)."""
    if secret and "," in secret:
        # comma-separated secrets: ONE batch, a distinct watermark per
        # image via the per-sample diag path (simple_sample messages=...).
        # The reference serves N messages with N folded LoRAs + pipelines.
        rng = np.random.default_rng(seed)
        bitstring = ["".join(map(str, rng.integers(0, 2, msg_bits)))
                     if not s.strip() else s.strip()
                     for s in secret.split(",")]
        images = simple_sample(src_model, "ddim",
                               [prompt] * len(bitstring),
                               messages=bitstring,
                               train_folder=aqualora_folder, seeds=[seed],
                               output_dir=output_dir,
                               num_inference_steps=steps,
                               guidance_scale=cfg,
                               batch_size=batch_size or len(bitstring),
                               resolution=resolution,
                               negative_prompt=negative_prompt, int8=int8,
                               config=config, device=device)
        gt_for_decode = None                 # per-image gt handled by caller
    else:
        # seed the random-secret draw too: a blank --secret must be
        # reproducible under --seed exactly like the comma-separated path
        bitstring, lora = create_watermark_lora(
            aqualora_folder, scale=1.03, msg_bits=msg_bits,
            hidinfo=secret or None, save=False,
            rng=np.random.default_rng(seed))
        images = simple_sample(src_model, "ddim", [prompt], lora=lora,
                               seeds=[seed], output_dir=output_dir,
                               num_inference_steps=steps, guidance_scale=cfg,
                               batch_size=1, resolution=resolution,
                               negative_prompt=negative_prompt, int8=int8,
                               config=config, device=device)
        gt_for_decode = bitstring
    decoded = None
    if msgdecoder_path is None:
        cand = os.path.join(aqualora_folder, MSGDECODER_FILE)
        msgdecoder_path = cand if os.path.exists(cand) else None
    if msgdecoder_path:
        _, _, decoded = simple_decode(
            msg_bits, msgdecoder_path, images, msg_gt=gt_for_decode,
            backbone=backbone,
            resolution=(backbone.decoder_resolution if backbone is not None
                        else 512), device=device)
    return images, bitstring, decoded


def batch_size(secret: str) -> int:
    """The demo's batch: one image, or one for each comma-separated
    secret."""
    return len(secret.split(",")) if secret and "," in secret else 1


def main_cli(args):
    world = sharding.init_distributed(args.device)
    args.device = world.device
    sharding.check_world_divides(batch_size(args.secret), world.size,
                                 "the demo's batch")
    sharding.check_world_divides(DECODE_BATCH, world.size,
                                 "the decoder's batch")
    config = backbone = None
    if getattr(args, "tiny", False):
        # same smoke-scale plumbing as every eval runner: tiny pipeline
        # + tiny decoder backbone, so the demo is drivable end to end
        # without full SD weights
        from aqualora_torch.core.config import (EfficientNetConfig,
                                                PipelineConfig)
        config = PipelineConfig.tiny()
        backbone = EfficientNetConfig.tiny()
        args.msg_bits = config.watermark.msg_bits
        args.resolution = min(args.resolution, 64)
        args.steps = min(args.steps, 4)
    images, bitstring, decoded = process(
        args.model_path, args.aqualora_folder, args.secret, args.prompt,
        args.negative_prompt, args.steps, args.cfg, args.seed,
        args.msg_bits, args.msgdecoder_path, args.resolution,
        args.output_dir, int8=args.int8, config=config, backbone=backbone,
        device=args.device)
    sharding.say(f"embedded secret: {bitstring}")
    if decoded:
        for i, d in enumerate(decoded):
            gt = bitstring[i] if isinstance(bitstring, list) else bitstring
            acc = np.mean([a == b for a, b in zip(d, gt)])
            sharding.say(f"image {i}: decoded {d} (bit acc {acc:.3f})")
    sharding.say(f"saved {len(images)} image(s) to {args.output_dir}")
    return images, bitstring, decoded


def main_gradio(args):  # pragma: no cover - requires gradio
    import gradio as gr

    def _run(src_model, folder, secret, prompt, negative, steps, cfg, seed):
        images, bitstring, decoded = process(
            src_model or None, folder, secret, prompt, negative,
            int(steps), float(cfg), int(seed), args.msg_bits,
            msgdecoder_path=args.msgdecoder_path,
            resolution=args.resolution, int8=args.int8, device=args.device)
        label = f"embedded: {bitstring}"
        if decoded:
            label += f" | decoded: {decoded[0]}"
        return images, label

    with gr.Blocks(title="AquaLoRA demo") as demo:
        src = gr.Textbox(label="clean SD model path (diffusers layout)")
        folder = gr.Textbox(label="AquaLoRA train folder")
        secret = gr.Textbox(label=f"{args.msg_bits}-bit secret (blank=random)")
        prompt = gr.Textbox(label="prompt")
        negative = gr.Textbox(label="negative prompt")
        steps = gr.Slider(1, 100, value=25, label="steps")
        cfg = gr.Slider(1.0, 20.0, value=7.5, label="cfg scale")
        seed = gr.Slider(0, 2 ** 31, value=0, step=1, label="seed")
        btn = gr.Button("Generate")
        gallery = gr.Gallery()
        out = gr.Textbox(label="bits")
        btn.click(_run, [src, folder, secret, prompt, negative, steps,
                         cfg, seed], [gallery, out])
    demo.launch()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--aqualora_folder", type=str, required=True)
    p.add_argument("--secret", type=str, default="",
                   help="bitstring (blank = random). Comma-separated "
                        "bitstrings generate ONE batch with a distinct "
                        "watermark per image (per-sample diag path; blank "
                        "entries are random)")
    p.add_argument("--prompt", type=str, default="a photo of a cat")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--cfg", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--msgdecoder_path", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--output_dir", type=str, default="demo_out")
    p.add_argument("--int8", nargs="?", const="conv", default=False,
                   choices=("conv", "dense", "all", "vae", "conv+vae",
                            "dense+vae", "all+vae"),
                   help="w8a8 int8 serving (ops/quant.py); bare --int8 = "
                        "conv-only (validate bit accuracy on real weights "
                        "before production use)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (smoke runs, same as the eval "
                        "runners)")
    p.add_argument("--web", action="store_true", help="launch Gradio UI")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the pipeline and the decoder")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.web:
        try:
            main_gradio(args)
        except ImportError:
            print("gradio not installed; falling back to CLI")
            return main_cli(args)
    else:
        return main_cli(args)


if __name__ == "__main__":
    main()
