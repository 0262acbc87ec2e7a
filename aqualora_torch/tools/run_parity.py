"""The real-weight parity runbook: one command from checkpoint paths to
PARITY.json.

The port of `scripts/run_parity.py`.  Given an SD checkpoint and the
reference release (`README.md:46-51`: pretrained_latentwm.pth and
ppft_trained/{pytorch_lora_weights.safetensors, mapper.pt,
msgdecoder.pt}), it chains the acceptance protocol:

  1. port + golden gate (`tools/golden_gate.py`: fold -> generate ->
     decode, the --via_merge merged-LDM leg; bit accuracy >= --min_bit_acc
     asserted);
  2. run_eval_base (the reference's evaluation/run_eval_base.py:15-54
     protocol: N prompts x num_seeds, DPM-Solver++ 25, CFG 7.5, 512^2,
     FPR 1e-6);
  3. run_fid (evaluation/run_fid.py:38-70; only with --fid_meta and
     --fid_gt_dir)
  -> <out>/PARITY.json with every leg's numbers.

With --synthetic the chain runs on random-weight artifacts in the
reference's formats (accuracies reported, not asserted).  The gate's int8
leg is not ported (ROADMAP A.8): pass --skip_int8, or the run stops before
it starts.  Every leg runs on --device (cuda unless asked for the CPU).

    python -m aqualora_torch.tools.run_parity --out parity_out --skip_int8 \\
        --sd_model SD15_DIR --latentwm pretrained_latentwm.pth \\
        --train_folder ppft_trained [--fid_meta meta_data.json \\
        --fid_gt_dir coco_gt/ --inception_torch_weights pt_inception.pth]
"""

from __future__ import annotations

import argparse
import json
import os

from aqualora_torch.core.config import WatermarkConfig
from aqualora_torch.eval import run_eval_base, run_fid
from aqualora_torch.tools import golden_gate
from aqualora_torch.tools.port_reference_artifacts import MSGDECODER_FILE


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--sd_model", type=str, default=None)
    p.add_argument("--latentwm", type=str, default=None)
    p.add_argument("--train_folder", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="write reference-format artifacts first; "
                        "accuracies reported, not asserted")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (CPU scale)")
    p.add_argument("--min_bit_acc", type=float, default=0.99)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--rank", type=int, default=320)
    p.add_argument("--sampler", type=str, default="dpms_m")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--gate_num_prompts", type=int, default=16)
    p.add_argument("--skip_merge", action="store_true",
                   help="skip the gate's merged-LDM leg")
    p.add_argument("--skip_int8", action="store_true",
                   help="skip the gate's int8-conv leg (required until "
                        "ROADMAP A.8)")
    p.add_argument("--eval_num_prompts", type=int, default=100)
    p.add_argument("--eval_num_seeds", type=int, default=10)
    p.add_argument("--fid_meta", type=str, default=None,
                   help="COCO meta_data.json / metadata.jsonl captions")
    p.add_argument("--fid_gt_dir", type=str, default=None,
                   help="ground-truth image dir or precomputed .npz stats")
    p.add_argument("--fid_num_images", type=int, default=5000)
    p.add_argument("--inception_torch_weights", type=str, default=None,
                   help="pt_inception-2015-12-05 checkpoint for real FID")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def run(args) -> dict:
    if bool(args.fid_meta) != bool(args.fid_gt_dir):
        # fail before the long gate and eval legs, not with fid: null after
        raise SystemExit("--fid_meta and --fid_gt_dir must be given "
                         "together (the FID leg needs captions and the "
                         "ground-truth images or statistics)")
    if not args.skip_int8:
        # the JAX runbook runs the gate's int8-conv leg here; skipping it
        # without being asked would return a PARITY.json missing a leg
        raise SystemExit(f"the gate's int8-conv leg: "
                         f"{golden_gate.UNPORTED}; pass --skip_int8")
    os.makedirs(args.out, exist_ok=True)
    # the tiny bit count from the config, so the gate leg and the eval
    # runners' --tiny configs cannot drift apart
    tiny_bits = WatermarkConfig.tiny().msg_bits

    # legs 1 and 2: port + golden gate (fold, merge)
    gate_out = os.path.join(args.out, "gate")
    gate_argv = ["--out", gate_out, "--seed", str(args.seed),
                 "--sampler", args.sampler,
                 "--num_prompts", str(args.gate_num_prompts),
                 "--batch_size", str(args.batch_size),
                 "--min_bit_acc", str(args.min_bit_acc),
                 "--msg_bits", str(tiny_bits if args.tiny
                                   else args.msg_bits),
                 "--rank", str(args.rank), "--device", args.device]
    for flag, value in (("--sd_model", args.sd_model),
                        ("--latentwm", args.latentwm),
                        ("--train_folder", args.train_folder)):
        if value:
            gate_argv += [flag, value]
    if args.synthetic:
        gate_argv += ["--synthetic"]
    if args.tiny:
        gate_argv += ["--tiny"]
    if not args.skip_merge:
        gate_argv += ["--via_merge"]
    gate_result = golden_gate.main(gate_argv)
    ported = os.path.join(gate_out, "ported")

    # leg 3: run_eval_base (the TPR / bit-accuracy protocol)
    eval_argv = ["--train_folder", ported,
                 "--msgdecoder_path", os.path.join(ported, MSGDECODER_FILE),
                 "--output_dir", os.path.join(args.out, "eval_base"),
                 "--sampler", args.sampler,
                 "--batch_size", str(args.batch_size),
                 "--num_prompts", str(args.eval_num_prompts),
                 "--num_seeds", str(args.eval_num_seeds),
                 "--msg_bits", str(args.msg_bits), "--device", args.device]
    if args.sd_model:
        eval_argv += ["--model_path", args.sd_model]
    if args.tiny:
        eval_argv += ["--tiny"]
    eval_result = run_eval_base.main(eval_argv)

    # leg 4: run_fid (only with captions and ground truth)
    fid_result = None
    if args.fid_meta and args.fid_gt_dir:
        fid_argv = ["--train_folder", ported,
                    "--meta_data", args.fid_meta,
                    "--gt_dir", args.fid_gt_dir,
                    "--output_dir", os.path.join(args.out, "fid"),
                    "--num_images", str(args.fid_num_images),
                    "--sampler", args.sampler,
                    "--batch_size", str(args.batch_size),
                    "--msg_bits", str(args.msg_bits),
                    "--device", args.device]
        if args.sd_model:
            fid_argv += ["--model_path", args.sd_model]
        if args.inception_torch_weights:
            fid_argv += ["--inception_torch_weights",
                         args.inception_torch_weights]
        elif args.synthetic or args.tiny:
            fid_argv += ["--allow_random_inception"]
        if args.tiny:
            fid_argv += ["--tiny"]
        fid_result = run_fid.main(fid_argv)

    parity = {"synthetic": bool(args.synthetic), "sd_model": args.sd_model,
              "gate": gate_result, "eval_base": eval_result,
              "fid": fid_result}
    path = os.path.join(args.out, "PARITY.json")
    with open(path, "w") as f:
        json.dump(parity, f, indent=1)
    print(f"wrote {path}")
    if not args.synthetic:
        acc = eval_result["bit_acc"]
        if not acc >= args.min_bit_acc:
            raise AssertionError(f"run_eval_base bit accuracy {acc:.4f} < "
                                 f"{args.min_bit_acc}: REAL-WEIGHT PARITY "
                                 "FAILED")
        print(f"REAL-WEIGHT PARITY PASSED (bit_acc={acc:.4f}, "
              f"tpr={eval_result['tpr']:.4f})")
    else:
        print("plumbing parity chain passed (synthetic weights: accuracies "
              "reported, not asserted)")
    return parity


def main(argv=None) -> dict:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
