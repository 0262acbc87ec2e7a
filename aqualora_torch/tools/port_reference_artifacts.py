"""One command to port the reference's released artifacts into the port's
own files.

The port of `aqualora_tpu/tools/port_reference_artifacts.py`.  The AquaLoRA
release (`README.md:46-51`) ships:
  pretrained_latentwm.pth      (stage 1: sec_encoder + sec_decoder)
  ppft_trained/pytorch_lora_weights.safetensors
  ppft_trained/mapper.pt
  ppft_trained/msgdecoder.pt

This writes them as the port's trainers and eval CLIs read them (the JAX
package writes orbax directories instead):
  <out>/pretrained_latentwm.pt            (--start_from_pretrain)
  <out>/pytorch_lora_weights.safetensors  (copied; the same format)
  <out>/mapper.safetensors
  <out>/msgdecoder.pt                     (--msgdecoder_path)

    python -m aqualora_torch.tools.port_reference_artifacts --out DIR \\
        [--latentwm pretrained_latentwm.pth] [--train_folder ppft_trained]

Everything stays on the host.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from aqualora_torch.core.io import LORA_FILE, MAPPER_FILE, save_safetensors
from aqualora_torch.tools import torch_import

LATENTWM_FILE = "pretrained_latentwm.pt"
MSGDECODER_FILE = "msgdecoder.pt"


def port(out: str, latentwm: str | None = None,
         train_folder: str | None = None, backbone=None) -> None:
    """Port the release files into `out` (the callable form of the CLI,
    which `tools/golden_gate.py` uses).  `backbone`: the decoder's
    EfficientNetConfig (B1 when None)."""
    os.makedirs(out, exist_ok=True)
    if latentwm:
        torch.save(torch_import.latentwm_from_torch(latentwm, cfg=backbone),
                   os.path.join(out, LATENTWM_FILE))
        print(f"ported stage-1 artifacts -> {out}/{LATENTWM_FILE}")

    if train_folder:
        lora_src = os.path.join(train_folder, LORA_FILE)
        mapper_pt = os.path.join(train_folder, "mapper.pt")
        dec_pt = os.path.join(train_folder, "msgdecoder.pt")
        if not any(os.path.exists(p) for p in (lora_src, mapper_pt, dec_pt)):
            # a mistyped --train_folder must not be a silent no-op that
            # only shows up as a confusing error downstream
            raise FileNotFoundError(
                f"found none of {LORA_FILE} / mapper.pt / msgdecoder.pt in "
                f"{train_folder!r}: is this the ppft_trained/ release "
                "folder?")
        if os.path.exists(lora_src):
            shutil.copy(lora_src, os.path.join(out, LORA_FILE))
            print("copied the LoRA safetensors (the same format)")
        if os.path.exists(mapper_pt):
            save_safetensors(torch_import.mapper_from_torch(mapper_pt),
                             os.path.join(out, MAPPER_FILE))
            print(f"ported mapper.pt -> {MAPPER_FILE}")
        if os.path.exists(dec_pt):
            torch.save(torch_import.secret_decoder_from_torch(
                dec_pt, cfg=backbone), os.path.join(out, MSGDECODER_FILE))
            print(f"ported msgdecoder.pt -> {out}/{MSGDECODER_FILE}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--latentwm", type=str, default=None,
                   help="pretrained_latentwm.pth")
    p.add_argument("--train_folder", type=str, default=None,
                   help="ppft_trained/ with lora + mapper.pt + msgdecoder.pt")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    port(args.out, args.latentwm, args.train_folder)


if __name__ == "__main__":
    main()
