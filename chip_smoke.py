#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA GPU and hold every kernel against
its plain version.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 0,2    # some phases (no kernels line)
    python3 chip_smoke.py --phases 15     # the publisher's chain only
    python3 chip_smoke.py --phases 16     # the chain, then the auditor's path
    python3 chip_smoke.py --phases 18     # the chain, then stage 3
    python3 chip_smoke.py --phases 19     # the chain, then the robustness
                                          # benchmark
    python3 chip_smoke.py --phases 20     # training from a folder of JPEGs
    python3 chip_smoke.py --phases 21     # the trainers' remaining options
    python3 chip_smoke.py --phases 22     # the chain, then the fidelity
                                          # benchmarks (FID, DreamSim)
    python3 chip_smoke.py --phases 23     # the reference release: the
                                          # golden gate and run_parity

Phases (any failure raises, so the exit code is not 0):
  0. torch and CUDA versions, the card's name and power limit (nvidia-smi).
     Without a CUDA card the script stops here with an error.
  1. Build the three kernel sources of aqualora_torch/csrc (flash_fwd,
     flash_bwd, secret_inject), one nvcc each, and the host JPEG decoder
     and PNG unfilter (jpeg_decode.cpp, png_unfilter.cpp, g++), all
     started together, and
     count the tensor-core instructions (HMMA, HGMMA) of every attention
     kernel in the built libraries with cuobjdump: each bfloat16 forward,
     dQ and dK/dV instance (`*_tc_kernel`) and the float32 d = 512
     forward, dQ and dK/dV instances (`*_d512_tc_kernel<float>`, 3xTF32)
     must have some, each other float32 instance (the CUDA-core kernels at
     d <= 160) none.
  2. The forward kernel against `flash_attention_plain` on the card at every
     attention shape of the serving path, O and lse: float32 and bfloat16
     at batch 2, then bfloat16 at the serving batch, where the tiling the
     kernel picks (printed: 16-row tiles or wide ones) is the one the
     generate call launches, and at the eval protocol's batch (4 images:
     2 x 4 for the U-Net under CFG, 4 for the VAE), whose tiling may
     differ.  Then the same at SD-2.1's 512^2 shapes, d = 64 at every level
     (the DP = 80 instances, 16 columns masked), self- and
     cross-attention.  At each batch two kernel calls must give the same
     bits; then the kernel's time, the plain version's, PyTorch's
     scaled_dot_product_attention's (a yardstick only: the port never
     calls it) and the H100 bound.
  3. The serving path: SD-1.5 at full width with seeded random bfloat16
     weights and the rank-320 message LoRA, one random 48-bit message folded
     into the U-Net, 8 prompts at 512x512, DDIM-25, CFG 7.5, VAE decode and
     SecretDecoder (EfficientNet-B1) bits.  Every generate call must launch
     the forward kernel exactly 801 times.  Then the first call once more,
     same seed, with this script swapping `flash_attention_fwd` for
     `flash_attention_plain`: its images must agree with the kernel's
     within PLAIN_SWAP_MAX_TOL and PLAIN_SWAP_MEAN_TOL (a supplement to
     phase 2: see their comment).
  4. The tiny serving slice on the card (kernel path) against the same
     slice on the CPU (plain path), same weights and initial latents.
  5. The backward kernels (dQ, dK/dV) against their plain versions at
     every differentiated attention shape of the training step, float32
     and bfloat16 (batch cut to 2); then at the training batch in bfloat16
     the forward against its plain version (the step's forward instances),
     each backward kernel's time and bound, and the pair's (flash_attention_bwd,
     delta included) beside the plain backward's.  At 64^2 self two
     bfloat16 calls must give the same bits.
  6. The secret-injection kernel against `inject_plain` at the training
     latent [8, 4, 64, 64], float32 and bfloat16 latents with float32 and
     bfloat16 weights (the PPFT trainer's are bf16), with its time and
     bound.  First of the profiled phases, one call under torch.profiler
     must run exactly one CUDA kernel, the injection's.
  7. The tiny PPFT step on the card (kernels) against the CPU (plain), the
     same weights and draws, float32: the loss and every trainable's
     gradient.
  8. The training path: one PPFT step of SD-1.5 at full width (rank-320
     LoRA on 192 sites, 48 bits, 512^2 synthetic pixels, B8, bfloat16
     frozen modules and float32 trainables, AdamW) through
     `aqualora_torch.train.ppft_train`, 1 warm-up and 3 timed steps.  Every
     step must launch 65 forward, 32 dQ, 32 dK/dV and 1 injection kernels;
     the loss and gradient norm must be finite and positive and the LoRA up
     weights must move.  After phase 12's profile, one more step under
     torch.profiler.
  9. SDPA's backward at each training shape, B8 bf16, as device time under
     torch.profiler (a yardstick for the pair; the port never calls it),
     beside the pair's own device time (delta, dQ and dK/dV kernels): at
     the small shapes phase 5's times are the host's launch cost.
 10. The forward kernel and SDPA's forward at each serving shape and batch,
     at the protocol's batch and at SD-2.1's d = 64 shapes, bf16, as device
     time under torch.profiler.
 11. One more generate call of phase 3's pipeline, kept from phase 3,
     under torch.profiler: the device's busy share of the median call, its
     largest kernels and the forward kernel's share (`--phases 11` runs
     phase 3 too).
 12. Stage 1's attention, the VAE mid-block at d = 512 differentiated
     through the watermarked decode: the d = 512 forward and backward
     kernels (dQ, dK/dV) against their plain versions at the stage-1 batch
     (5, 1, 4096, 4096, 512) and at a ragged (2, 1, 1000, 1000, 512),
     float32 and bfloat16, two calls of either type bit-identical; then at
     B5 each kernel's time, the plain version's and the bound (float32: at
     the 3xTF32 rate, beside the bound at the CUDA cores' float32 rate).
     After phase 10, the forward's and SDPA's forward, the pair's and SDPA's
     backward (a yardstick; the port never calls it) as device time under
     torch.profiler, with the SDPA backend torch picked.
 13. The tiny stage-1 step on the card (kernels) against the CPU (plain),
     the same weights and draws, float32: the loss and every trainable's
     gradient, once for each of the six stage-1 distortions.
 14. The stage-1 path: the full-width step through
     `aqualora_torch.train.latent_wm_pretrain` (SD-1.5 VAE, 48-bit
     SecretEncoder, EfficientNet-B1 SecretDecoder in train mode,
     LPIPS-VGG16, 512^2 synthetic pixels, B5), loss weights (5, 1, 1.5)
     and the late distortion probabilities, 1 warm-up and 3 timed steps in
     float32, then the same in bf16.  Every step must launch the d = 512
     forward 3 times and the dQ and dK/dV kernels once each; the loss must
     be finite and positive, every encoder and decoder parameter and the
     BatchNorm statistics must move.  After phase 12's profile, one step of
     each under torch.profiler: the busy share and the d = 512 pair's
     share of device time.
 15. The publisher's chain at full width, each stage through the entry
     point a user calls: stage 1 (`latent_wm_pretrain.run`, 512^2 B5 bf16,
     2 steps) writes pretrained_latentwm.pt to a temporary directory; PPFT
     (`ppft_train.run`, 512^2 B8 rank 320 bf16, 2 steps) starts from it
     with --start_from_pretrain, saves the LoRA, mapper and msgdecoder with
     --output_dir and runs its final sanity inference; the LoRA file must
     hold 384 tensors and a second export the same bytes (its size, write
     and read seconds printed), the PPFT SecretEncoder must be stage 1's bit
     for bit and float32; a fresh SD-1.5 pipeline loads the LoRA, mapper and
     decoder (bit for bit the trained ones), folds a message and generates
     8 images at 512^2 with DPM-Solver++(2M) 25 steps, CFG 7.5, from
     per-image generators: 801 forward launches a call, imgs/s (median of
     3 after a warm-up) beside phase 3's DDIM-25, peak memory, finite
     images, a repeat call bit-identical, row i of the initial latent the
     B1 draw of generator i, the decoded bit accuracy (printed only: the
     weights are random).  Each stage's launches are counted from 0.  Then
     the tiny dpms_m slice on the card against the CPU, as phase 4 for DDIM.
     The temporary directory stays until phase 16 ends.
 16. The auditor's path at full width on phase 15's artifacts, through the
     entry points a user calls (`--phases 16` runs phase 15 too):
     `aqualora_torch.eval.run_eval_base` with --train_folder --hidinfo
     (SD-1.5 512^2, dpms_m 25, CFG 7.5, bf16, batch 4, 8 prompts x 2 seeds:
     16 images written as PNGs, read back through the PIL-exact bicubic
     preprocess and decoded), then create_wm_lora's CLI and run_eval_base
     with --lora --msg_gt.  Every generate call must launch the forward
     801 times; 16 PNGs and eval_base.json as written; the PNGs must equal
     the device-quantized images and decode to the same bits; both flows
     must give the same images and fields.  Then simple_sample with four
     messages in one B4 batch (801 launches), each image beside the same
     message folded (printed).  Prints images/s end to end, the seconds of
     the parts (generate calls, quantize and fetch, PNG write, PNG read and
     preprocess, decode, the rest), peak memory and the bit accuracy
     (printed: the weights are random).
 17. The twelve samplers: each on the tiny slice on the card against the
     CPU (the stochastic ones with the same draws on both sides); then at
     full width (SD-1.5 512^2, B8, CFG 7.5, 25 steps, bf16, a folded
     message) one timed call each after a shared warm-up, beside DDIM-25's
     in the same run: finite images, forward launches = 32 per U-Net
     evaluation of the sampler + 1 (801; 833 for pndm; 1569 for heun,
     kdpm2, kdpm2a and dpms_s).
 18. Stage 3, the decoder's robustness fine-tune (`--phases 18` runs phase
     15 too), whose generation draws one resolution of 512^2-768^2 a step:
     (a) every forward shape of a B4 generate at 576^2, 640^2, 704^2 and
     768^2 (U-Net self and cross at each level at B8, the VAE at B4) in
     bf16 as phase 2 holds the serving shapes, the plain version one batch
     item at a time where its logits would pass 4 GiB; at 768^2 also float32
     and bf16 at batch 2; (b) the tiny stage-3 step on the card against the
     CPU, float32, the same weights and draws, for each of the five
     distortions: the images, the loss and every decoder gradient; (c)
     `rob_enhance_finetune.run` at full width on phase 15's stage-1 file and
     LoRA directory (SD-1.5, rank 320, 48 bits, B4, bf16, a constant
     learning rate, a checkpoint every 2 steps): 4 steps, resumed from the
     latest checkpoint to 6, and an uninterrupted 6-step run; every step
     launches the forward 641 times at its resolution's shapes, the loss is
     finite and positive, every decoder tensor moves, the resumed steps and
     decoder equal the uninterrupted run's bit for bit (cuDNN's
     deterministic algorithms on), msgdecoder.pt read by load_msgdecoder
     equals the trained decoder, and phase 15's image decodes (printed);
     (d) 1 warm-up and 3 timed steps at 512^2 and at 768^2 through the step
     functions `run` uses (steps/s, the generation's and the decoder step's
     shares, peak memory), then one float32 step at 512^2, the JAX CLI's
     default precision.  After the timed phases, the 768^2 shapes' device
     time beside SDPA's (with the short sessions) and one profiled step of
     each kind of (d) (with the whole-step profiles).
 19. The robustness benchmark (`--phases 19` runs phase 15 too): (a)
     SD-2.1's d = 64 shapes at B8, the batch of an SDEdit2 call, as phase 2
     holds the serving shapes; (b) the tiny img2img slice on the card
     against the CPU, float32, epsilon and v-prediction, strength 0.1 and
     0.2 of 10 steps and 0.5 of 4; (c) the JPEG quality-50 round trip
     (`eval/jpeg.py`) at B8 512^2 on the card against the same on the CPU,
     bit for bit, and against Pillow where the machine has it (printed),
     with its time; (d) `run_eval_distortion.main` at full width on phase
     15's artifacts (8 prompts, 512^2, dpms_m 25, CFG 7.5, bf16, B4, the
     seven distortions, --with_sdedit on SD-1.5 and --with_sdedit2 on
     SD-2.1, seeded random weights): every generate call launches the
     forward 801 times, every SDEdit call 34 (the VAE encoder, one U-Net
     evaluation, the decoder) and every SDEdit2 call 66 (two evaluations),
     every kind's directory holds 8 PNGs of the right size, every distorted
     batch is finite; the seconds of the clean set, of each distortion, of
     each SDEdit call and of each decode, images/s, peak memory, each
     kind's bit accuracy (printed: random weights); (e) the float32
     forward at d <= 160 (the CUDA-core instances) at stage 3's 512^2
     shapes, B8, against its plain version, with its time, SDPA's float32
     time and the bound at the CUDA cores' float32 rate, and after the
     timed phases the same as device time (with the short sessions).
 20. Training on real images: the data path of `train/data.py` on the
     committed fixtures of tests/torch_port_images (the card's machine has
     no PIL): (a) on the host, every small fixture decodes to its committed
     Pillow (JPEG) or libpng (PNG) pixels bit for bit, every JPEG also
     through `decode_from_coefficients` on the card fed the decoder's
     coefficients, a truncated copy of each raises, each refused kind
     raises naming its feature, each realistic file (512x512 to 1024x768)
     decodes to the SHA-256 of Pillow's pixels; then `decode_batch` alone
     at 512^2 on the realistic set copied under 64 names, with the host's
     thread count and with one (images/s, the host's CPU count), and the
     PNG path on the same images; (b) two steps of stage 1 from a folder
     of those 64 files with metadata.jsonl captions (--dataset, B5, bf16),
     whose file the PPFT runs start from; (c) `ppft_train.run` from the
     folder (SD-1.5, rank 320, 48 bits, B8, 512^2, bf16), 1 warm-up and 5
     timed steps, in turns with the same run on synthetic images (folder,
     synthetic, synthetic, folder), then once on 2 decoder threads: every
     step launches 65 forward, 32 dQ, 32 dK/dV and 1 injection kernels, the
     loss is finite and positive; samples/s beside synthetic images' (and
     phase 8's step rate); (d) the same with --cache_latents: the cache's
     build seconds, host bytes and encode launches, 64 forward launches a
     step (no VAE encoder), steps/s; (e) two steps of stage 3
     (--train_data_dir, B4, --resolution 512): finite losses, the prompts
     the folder's captions.  With the whole-step profiles, one profiled
     step of the folder-fed and of the synthetic PPFT trainer: the device's
     busy share of the step's own wall time and of the unprofiled median.
     Stage 1's runs through `run` (here and in phase 15) launch the d = 512
     forward 3 times a step and 4 times an epoch: the epoch's sample image
     and its eval each encode and decode once.
 21. The trainers' remaining options at full width (SD-1.5, rank 320, 48
     bits, 512^2, B8, bf16, seeded random weights and stage-1 file), each
     through `ppft_train`'s and `latent_wm_pretrain`'s entry points: (a)
     `--use_8bit_adam`: the state's bytes beside float32 moments', one
     update's host time, samples/s beside phase 8's float32 AdamW; then
     one update on the card and on the CPU from the same state and
     gradients: the codes and scales bit for bit; with the whole-step
     profiles, one update's device time and kernels; (b)
     `--gradient_checkpointing` with lora, module and rank dropout 0.1: the
     same draws give the loss (1e-4 relative) and every gradient (the bf16
     tolerance of the card tests) of the trainer without remat; 97 forward,
     32 dQ, 32 dK/dV and 1 injection launches a step; peak memory and
     samples/s with and without remat at B8 and B16, lower with; (c)
     `--gradient_accumulation_steps 2` at B4 against one B8 step over the
     same samples and draws, in float32: the mean gradient and the update
     agree (P21_ACC_*), the micro-steps' seconds; (d) `--train_text_encoder`
     through `run` (3 steps, --output_dir, the sanity inference): samples/s,
     528 tensors in the LoRA file (144 of the text encoder); a fresh
     pipeline with CLIP LoRA loads them bit for bit and generates 2 images
     through them (801 launches, finite, changed by the text-encoder LoRA);
     (e) `--teacher_skip_lora 0`: the loss torch.equal to the skipping
     teacher's, the step times of both; (f) `--validation_steps 2` in a
     4-step `run`: validations at steps 2 and 4, their seconds, 4 x 65 + 2 x
     801 forward launches; (g) with cuDNN's and torch's deterministic
     algorithms: PPFT with 8-bit AdamW and accumulation 2 resumed from
     micro-step 3 (mid-window) equals the uninterrupted 4-step run bit for
     bit; stage 1 (B5 bf16, a folder of 5 PNGs, one step an epoch) resumed
     from epoch 1's checkpoint equals the run resumed from epoch 0 at epoch
     2; (h) stage 1's loss and backward at B5, bf16 and float32, with
     neither, either and both of `--remat_vae_decode` and `--remat_lpips`:
     peak memory (lower with the decode's remat), seconds, the d = 512
     forward's launches (4 with `--remat_vae_decode`, else 3), the loss
     torch.equal in all four.
 22. The fidelity benchmarks (`--phases 22` runs phase 15 too), every
     network in float32 with seeded random weights: (a) the float32 forward
     (the CUDA-core instance at d <= 80) at the ViTs' shapes, B4 and B8:
     ViT-B/16 (12 heads, T = 197, d = 64: the ensemble's three backbones),
     ViT-B/32 (T = 50), MAE ViT-L/16 (16 heads, T = 197) and ViT-H/14 (16
     heads, T = 257, d = 80), O and lse against the plain version, two
     calls bit-identical, kernel_ms, plain_ms, SDPA's float32 time (a
     yardstick only) and the bound at the CUDA cores' float32 rate, and
     after the timed phases the same as device time (with the short
     sessions); (b) InceptionV3 at full width on the card against the CPU
     on 16 images (1e-4 of the largest feature + 1e-5) with TF32 allowed
     around the call (the extractor turns it off for itself and gives the
     flags back), the 8 realistic JPEGs of tests/torch_port_images (mixed
     sizes) through `fid.py --save-stats` against the CPU's statistics, the
     extractor's images/s at 299^2 B32 over 512 images; (c) the DreamSim
     ensemble on the card against the CPU on 8 pairs (distances within
     1e-5), 72 forward launches a call, pairs/s at B4, mae_vith14 once (64
     launches at T = 257, d = 80); (d) `run_fid.main` on phase 15's
     artifacts: 16 captions, 512^2, dpms_m 50 steps (the protocol's), CFG
     7.5, bf16, B4, the folder against itself (|FID| < 1e-3), 1601 forward
     launches a generate call, the seconds of the generation, PNG write and
     read, features and the host's Frechet distance; (e) `run_dreamsim.main`
     on the same artifacts: 8 prompts, dpms_m 25, B4, with and without the
     LoRA: 801 launches a generate call, 72 a DreamSim call, the mean
     distance (printed: random weights).
 23. The reference release (synthetic release files, seeded random weights,
     needs no other phase): (a) the forward at every shape of an SD-2.1
     generate at its native 768^2, B2 under CFG (d = 64 at the four U-Net
     levels, 96^2 to 12^2, on the DP = 80 instance with 16 columns masked,
     and the VAE's mid-block at d = 512), bf16 at its batch: two calls
     bit-identical, against the plain version, the tiling, kernel_ms,
     plain_ms, SDPA's time and the bound, and after the timed phases the
     same as device time (with the short sessions); (b) `run_parity.run`
     at SD-1.5 512^2 (`--synthetic --skip_int8`, 4 gate prompts and 4
     eval_base prompts x 1 seed, B2, the merge leg on): the LoRA file holds
     384 tensors, the ported files load strictly, the ported msgdecoder.pt
     gives the CPU's logits on the card (float32, 1e-4 of the largest),
     801 forward launches a generate call, merge_img_diff < 4/255,
     PARITY.json with its gate and eval_base entries; the seconds of each
     part (synthesis, port, fold, each generate, merge, LDM write and read,
     reload, the FID smoke, eval_base), the LDM file's GB, images/s and the
     fold and merge paths' decoded-bit agreement; (c) `golden_gate.run` at
     SD-2.1 768^2 (`--synthetic --model sd21 --via_merge`, 2 prompts, B2):
     the v2 single file found to be v2 on reload, merge_img_diff < 4/255,
     801 launches a call, images/s and the peak device memory.  Each leg's
     LDM file (4-5 GB) is deleted when the leg ends.
The timed phases run first (0-7, 12, 13, 14, 8, 15, 16, 18b-d, 19d, 22d-e,
17, 18a, 19a-c, 19e, 20, 21, 22a-c, 23a-c) and the profiled ones after
them, so that the profiler touches no timed phase: first the short
sessions (6's profile, 9, 10, 12's profile, 18a's, 19e's, 22a's, 23a's),
then the profiles of
whole steps (8, 14, 18d's, 20's, 21a's update) and of a generate call
(11).  After a session of a whole step, short sessions in the same process
have recorded some device events or none (PERF.md, section 7).  The line
before the last names the card and its power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# H100 SXM data sheet: dense bf16 tensor-core rate, the float32 rate of the
# CUDA cores (the float32 kernels' units at d <= 160), the dense TF32
# tensor-core rate and HBM3 bandwidth.  The float32 d = 512 kernels do each
# product as three TF32 products (3xTF32): PEAK_TF32_FLOPS / 3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_PER_S = 3.35e12

# name, heads, Tq, Tk, head dim, serving batch (the CFG batch of 2 x 8
# prompts for the U-Net, 8 images for the VAE), launches per generate call
SHAPES = [
    ("unet64_self", 8, 4096, 4096, 40, 16, 125),
    ("unet64_cross", 8, 4096, 77, 40, 16, 125),
    ("unet32_self", 8, 1024, 1024, 80, 16, 125),
    ("unet32_cross", 8, 1024, 77, 80, 16, 125),
    ("unet16_self", 8, 256, 256, 160, 16, 125),
    ("unet16_cross", 8, 256, 77, 160, 16, 125),
    ("unet8_self", 8, 64, 64, 160, 16, 25),
    ("unet8_cross", 8, 64, 77, 160, 16, 25),
    ("vae_mid", 1, 4096, 4096, 512, 8, 1),
]
LAUNCHES_PER_GENERATE = sum(s[-1] for s in SHAPES)          # 801
# the eval protocol's batch (run_eval_base): 4 prompts, so 2 x 4 for the
# U-Net under CFG and 4 for the VAE; the bf16 tiling depends on the batch
PROTOCOL_IMAGES = 4
# SD-2.1 at 512^2: the JAX package sends d = 64 to the forward kernel at every
# level (flash_shapes_ok), which the port runs on its DP = 80 instances with
# 16 columns masked.  name, heads, Tq, Tk, head dim, serving batch (CFG of 8)
SD21_SHAPES = [
    ("sd21_64_self", 5, 4096, 4096, 64, 16),
    ("sd21_64_cross", 5, 4096, 77, 64, 16),
    ("sd21_32_self", 10, 1024, 1024, 64, 16),
    ("sd21_32_cross", 10, 1024, 77, 64, 16),
    ("sd21_16_self", 20, 256, 256, 64, 16),
    ("sd21_16_cross", 20, 256, 77, 64, 16),
    ("sd21_8_self", 20, 64, 64, 64, 16),
    ("sd21_8_cross", 20, 64, 77, 64, 16),
]
SOURCES = ("flash_fwd", "flash_bwd", "secret_inject")
# host code built with g++ beside the kernels: the training data's JPEG
# decoder and PNG's row filters
HOST_SOURCES = ("jpeg_decode", "png_unfilter")
# the differentiated attentions of one PPFT step at 512 px: name, heads,
# Tq, Tk, head dim, student launches per step (each also runs once in the
# teacher, forward only).  16 transformer blocks, self + cross each.
TRAIN_SHAPES = [
    ("unet64_self", 8, 4096, 4096, 40, 5),
    ("unet64_cross", 8, 4096, 77, 40, 5),
    ("unet32_self", 8, 1024, 1024, 80, 5),
    ("unet32_cross", 8, 1024, 77, 80, 5),
    ("unet16_self", 8, 256, 256, 160, 5),
    ("unet16_cross", 8, 256, 77, 160, 5),
    ("unet8_self", 8, 64, 64, 160, 1),
    ("unet8_cross", 8, 64, 77, 160, 1),
]
TRAIN_BATCH = 8
BWD_PER_STEP = sum(s[-1] for s in TRAIN_SHAPES)              # 32
# forward launches per step: teacher and student at every shape, plus the
# VAE encoder's mid-block (H1, T4096, d512)
FWD_PER_STEP = 2 * BWD_PER_STEP + 1                          # 65
TRAIN_STEPS = 4                # 1 warm-up + 3 timed
CHECK_BATCH = 2
# max abs error allowed against the plain version.  float32 O: both sides
# accumulate in float32 in different orders (~1e-6).  lse is float32 on both
# sides for either input type.
TOL_F32 = 1e-4
TOL_LSE = 1e-4
TINY_IMAGE_TOL = 2e-3
# tiny PPFT step, card against CPU (float32, TF32 off): the loss to 1e-4
# relative; each gradient to 1e-3 of its leaf's largest value, since the
# card sums in other orders (cuDNN's convolutions, the kernels' tiles)
# through the whole U-Net and its backward
TINY_LOSS_RTOL = 1e-4
TINY_GRAD_TOL = 1e-3
# phase 3, the kernel's generate call against the same call with the plain
# forward, images in [-1, 1]: the 25 denoising steps amplify single bf16
# ulps of O, so the earlier float32 CUDA-core forward already gave max |d|
# 0.8096 and mean |d| 0.0382 (and other bits) on an NVIDIA H100 80GB HBM3,
# one seed.  The limits are twice those readings.  The max limit spans most
# of the range of 2 and cannot fail a wrong kernel; the mean limit can.
# The kernel's correctness is phase 2's check of every instance the paths
# launch; this one shows how far a whole call drifts.
PLAIN_SWAP_MAX_TOL = 1.62
PLAIN_SWAP_MEAN_TOL = 0.076
# stage 1: the VAE mid-block's single-head attention (T 4096 at 512 px, d
# 512), differentiated through the watermarked decode.  name, batch, heads,
# Tq, Tk, head dim; the first is the stage-1 batch (the CLI default).
S1_SHAPES = [("vae_mid_b5", 5, 1, 4096, 4096, 512),
             ("vae_mid_ragged", 2, 1, 1000, 1000, 512)]
S1_BATCH = 5
S1_RES = 512
S1_STEPS = 4                   # 1 warm-up + 3 timed, per type
# launches of one stage-1 step: the forward in the encode, the clean decode
# and the watermarked decode; the backward in the watermarked decode
S1_PER_STEP = {"fwd": 3, "dq": 1, "dkv": 1, "inject": 0}
S1_KEY = (1, 4096, 4096, 512)
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def is_kernel(e) -> bool:
    """A profiler event of device work: on the CUDA timeline, and not a
    user annotation (`Optimizer.step#AdamW.step` spans the optimizer's
    kernels and the gaps between them)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of `fn`: the CUDA kernels' time under
    torch.profiler over `iters` calls, so host gaps between its launches do
    not count.  NaN if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if is_kernel(e))
    return us / 1e3 / iters if us > 0 else float("nan")


def tolerance_o(dtype: torch.dtype, o_ref: torch.Tensor) -> float:
    """bfloat16 O is rounded on both sides from float32 values that differ
    by the float32 limit, so an element may differ by one bf16 ulp at its own
    magnitude: at most 2^-7 * max|O_ref|, which scales with O (about
    Tk^-1/2 at randn inputs)."""
    if dtype == torch.float32:
        return TOL_F32
    return 2.0 ** -7 * o_ref.float().abs().max().item() + TOL_F32


def attention_bound(b, h, tq, tk, d, elem_bytes=2, peak=PEAK_BF16_FLOPS):
    """The forward's least time: QK^T and PV, or the bytes of q, k, v read
    once and o (+ float32 lse) written once."""
    return bound(4.0 * b * h * tq * tk * d,
                 (2 * b * h * tq * d + 2 * b * h * tk * d) * elem_bytes
                 + 4 * b * h * tq, peak)


def tolerance_grad(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """float32 gradients: both sides accumulate in float32 in other orders
    over up to Tq or Tk terms, so 1e-4 of the largest reference gradient
    plus 1e-5.  bfloat16 adds one bf16 ulp at that value (2^-7 of it):
    each side rounds its float32 gradient once."""
    m = ref.float().abs().max().item()
    tol = 1e-4 * m + 1e-5
    return tol if dtype == torch.float32 else tol + 2.0 ** -7 * m


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """Least time on the card, ms: the operations at `peak` (the bf16
    tensor-core rate unless said otherwise) or the bytes at the HBM rate,
    whichever is larger."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_bounds(b, h, tq, tk, d, elem_bytes=2, peak=PEAK_BF16_FLOPS) -> dict:
    """Per kernel and for the pair: operations are 2*Tq*Tk*d per product
    and (b, h); dQ computes S, dP and dQ (3), dK/dV computes S, dP, dV and dK
    (4), the pair's least work is S, dP, dQ, dK, dV (5).  Bytes: each input
    read once and each output written once, lse and delta float32."""
    bh, e = b * h, elem_bytes
    row_q, row_k, stats = bh * tq * d * e, bh * tk * d * e, 2 * 4 * bh * tq
    prod = 2.0 * bh * tq * tk * d
    return {
        "dq": bound(3 * prod, 3 * row_q + 2 * row_k + stats, peak),
        "dkv": bound(4 * prod, 2 * row_q + 4 * row_k + stats, peak),
        "pair": bound(5 * prod, 4 * row_q + 4 * row_k + stats, peak),  # + o
    }


def phase0() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = nvidia_smi()
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" | nvidia-smi: {smi}", flush=True)
    # state both precisions: float32 products and convolutions in full
    # float32, so the float32 comparisons hold the kernel to float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[0] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def tensor_core_counts(name: str) -> dict:
    """{kernel symbol: (HMMA, HGMMA)} of the built csrc/<name>.cu, from
    cuobjdump -sass of the toolkit that built it."""
    from aqualora_torch.ops import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][1] += "HGMMA" in line
            counts[fn][0] += "HMMA" in line and "HGMMA" not in line
    return {f: tuple(c) for f, c in counts.items()}


def phase1():
    from aqualora_torch.ops import _build
    seconds = _build.build_all(SOURCES + HOST_SOURCES, verbose=True)
    for name in SOURCES + HOST_SOURCES:
        src = _build.source(name).relative_to(_build.CSRC.parent)
        print(f"[1] built {src} in {seconds[name]:.1f} s (all "
              f"{len(SOURCES)} nvcc and {len(HOST_SOURCES)} g++ started "
              "together)", flush=True)
    # bf16 instances: forward 3 head-dim tiles x 2 row tilings + d = 512;
    # backward 3 x 2 x (dQ, dK/dV) + d = 512 x (dQ, dK/dV).  float32 on the
    # tensor cores (3xTF32): the d = 512 forward, dQ and dK/dV.  float32 on
    # the CUDA cores (d <= 160): forward 3, backward 3 x (dQ, dK/dV).
    for name, n_tc, n_tf32, n_f32 in (("flash_fwd", 7, 1, 3),
                                      ("flash_bwd", 14, 2, 6)):
        counts = tensor_core_counts(name)
        for fn, (hmma, hgmma) in sorted(counts.items()):
            print(f"[1] {name} SASS {fn}: HMMA {hmma} HGMMA {hgmma}",
                  flush=True)
        # the float32 instances of the d = 512 template, mangled or not
        tf32 = {fn: c for fn, c in counts.items()
                if re.search(r"d512_tc_kernel(IfE|<float>)", fn)}
        tc = {fn: c for fn, c in counts.items()
              if "_tc_kernel" in fn and fn not in tf32}
        f32 = {fn: c for fn, c in counts.items()
               if fn not in tc and fn not in tf32}
        if len(tc) != n_tc or not all(sum(c) > 0 for c in tc.values()):
            raise AssertionError(f"{name}: bf16 instances without "
                                 f"tensor-core instructions: {tc}")
        if len(tf32) != n_tf32 or not all(sum(c) > 0 for c in tf32.values()):
            raise AssertionError(f"{name}: float32 d = 512 instances without "
                                 f"tensor-core instructions: {tf32}")
        if len(f32) != n_f32 or any(sum(c) for c in f32.values()):
            raise AssertionError(f"{name}: CUDA-core float32 instances with "
                                 f"tensor-core instructions: {f32}")


def counters() -> dict:
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.ops import secret_inject as si
    return {"fwd": fa.launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches, "inject": si.launches}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def counts() -> dict:
    return {k: c.count for k, c in counters().items()}


def plain_by_batch(q, k, v, scale: float) -> tuple:
    """`flash_attention_plain`, one batch item at a time where the whole
    batch's float32 logits would take more than 4 GiB (the plain version
    materialises them: 22 GB at stage 3's (8, 8, 9216, 9216, 40))."""
    from aqualora_torch.ops import flash_attention as fa
    b, h, tq, _ = q.shape
    if b * h * tq * k.shape[2] * 4 <= 2 ** 32:
        return fa.flash_attention_plain(q, k, v, scale)
    outs = [fa.flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     scale) for i in range(b)]
    return torch.cat([o for o, _ in outs]), torch.cat([lse for _, lse in outs])


def check_fwd(tag: str, q, k, v, scale: float, out=None,
              plain=None) -> float:
    """Hold the forward kernel's (o, lse) (`out`, else one call) against
    `plain` (`flash_attention_plain` unless given) on the same inputs;
    print the line, with the query rows per block of the bf16 instance
    that ran, and return max|dO|."""
    from aqualora_torch.ops import flash_attention as fa
    o, lse = fa.flash_attention_fwd(q, k, v, scale) if out is None else out
    o_ref, lse_ref = (plain or fa.flash_attention_plain)(q, k, v, scale)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    tol_o = tolerance_o(q.dtype, o_ref)
    b, h, tq, d = q.shape
    tiles = (f", {fa.fwd_tile_rows(q)}-row tiles"
             if q.dtype == torch.bfloat16 else "")
    line = (f"{tag} B{b} H{h} Tq{tq} Tk{k.shape[2]} d{d} {str(q.dtype)[6:]}"
            f"{tiles}: max|dO| {err_o:.3e} (tol {tol_o:.3e}, "
            f"{err_o / tol_o:.2f} of it, max|O| "
            f"{o_ref.float().abs().max().item():.3e}) max|dlse| {err_l:.3e} "
            f"(tol {TOL_LSE:g})")
    print(line, flush=True)
    if not (err_o <= tol_o and err_l <= TOL_LSE):
        raise AssertionError(f"kernel disagrees with plain: {line}")
    return err_o


def check_serving_shape(tag: str, h, tq, tk, d, b, gen, smi: str,
                        at_b2: bool = True, phase: int = 2,
                        plain=None) -> dict:
    """The forward at one attention shape: float32 and bf16 against the
    plain version (`plain`, else `flash_attention_plain`) at batch 2
    (`at_b2`), then bf16 at batch `b`, whose tiling is the one a call at
    that batch launches: two calls bit-identical, against the plain version,
    then the kernel's, the plain version's and SDPA's times (SDPA a
    yardstick only: the port never calls it) and the H100 bound.  Returns
    the row."""
    from aqualora_torch.ops import flash_attention as fa
    scale = d ** -0.5
    plain = plain or fa.flash_attention_plain
    for dtype in (torch.float32, torch.bfloat16) if at_b2 else ():
        q, k, v = (torch.randn(CHECK_BATCH, h, t, d, device="cuda",
                               generator=gen).to(dtype)
                   for t in (tq, tk, tk))
        check_fwd(f"[{phase}] {tag}", q, k, v, scale, plain=plain)
        del q, k, v
    q, k, v = (torch.randn(b, h, t, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for t in (tq, tk, tk))
    first, again = (fa.flash_attention_fwd(q, k, v, scale) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{tag}: two forward calls differ")
    err = check_fwd(f"[{phase}] {tag}", q, k, v, scale, out=first,
                    plain=plain)
    del first, again
    kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
    plain_ms = time_ms(lambda: plain(q, k, v, scale), iters=3, warmup=1)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale))
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d)
    print(f"[{phase}] {tag} B{b} bf16 (two calls bit-identical): "
          f"kernel_ms {kernel_ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms(sdpa) {library_ms:.4f} "
          f"= {kernel_ms / library_ms:.2f}x, bound_ms {bound_ms:.4f} "
          f"({bound_by}) | {smi}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def protocol_shapes():
    """SHAPES at the eval protocol's batch: (key, name, heads, Tq, Tk, d,
    batch)."""
    return [(f"protocol_b{PROTOCOL_IMAGES}/{name}", name, h, tq, tk, d,
             b * PROTOCOL_IMAGES // N_IMG)
            for name, h, tq, tk, d, b, _ in SHAPES]


def phase2(smi: str) -> dict:
    """Every serving shape at batch 2 and at the serving batch, each of them
    at the protocol's batch, and SD-2.1's d = 64 shapes; rows keyed by the
    shape's name (the protocol's under `protocol_b4/`)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, h, tq, tk, d, serve_b, _ in SHAPES:
        rows[name] = check_serving_shape(name, h, tq, tk, d, serve_b, gen,
                                         smi)
    for key, name, h, tq, tk, d, b in protocol_shapes():
        rows[key] = check_serving_shape(key, h, tq, tk, d, b, gen, smi,
                                        at_b2=False)
    for name, h, tq, tk, d, serve_b in SD21_SHAPES:
        rows[name] = check_serving_shape(name, h, tq, tk, d, serve_b, gen,
                                         smi)
    return rows


N_IMG, STEPS, RES = 8, 25, 512
PROMPTS = ["a photograph of an astronaut riding a horse",
           "a watercolor of a lighthouse at dusk",
           "a bowl of ramen, studio lighting",
           "a red fox in fresh snow",
           "an isometric city block at night",
           "a portrait of an old fisherman",
           "a field of sunflowers under storm clouds",
           "a cat reading a newspaper"]


def serving_setup():
    """SD-1.5 at full width with seeded random bf16 weights, the rank-320
    LoRA with one folded message, the SecretDecoder, 8 prompts; returns
    (run, decoder, msg_bits), run(seed) being one generate call."""
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretDecoder

    cfg = PipelineConfig.sd15(lora_rank=320)
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device="cuda")
    pipe.init_params(seed=0)
    decoder = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.b1(),
                            dtype=torch.bfloat16).eval()
    init_module_weights(decoder, torch.Generator(device="cuda").manual_seed(1))
    msg = torch.bernoulli(torch.full((cfg.watermark.msg_bits,), 0.5),
                          generator=torch.Generator().manual_seed(2))
    pipe.fold_message(msg)
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)
    generate = pipe.make_generate(num_steps=STEPS, sampler="ddim",
                                  height=RES, width=RES)
    torch.cuda.synchronize()
    print(f"[3] SD-1.5 bf16 weights ready in "
          f"{time.perf_counter() - t0:.1f} s (rank-320 LoRA folded)",
          flush=True)

    def run(seed):
        return generate(ids, neg, guidance_scale=7.5,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(seed))

    return run, decoder, cfg.watermark.msg_bits


def phase3(smi: str) -> tuple:
    """The serving path; returns its launches per shape, the median call in
    seconds and the generate call, which phase 11 profiles."""
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.ops import flash_attention as fa

    run, decoder, msg_bits = serving_setup()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                              # counts start here
    images = run(3)
    torch.cuda.synchronize()
    by_shape = dict(fa.launches.by_shape)
    total = fa.launches.count
    print(f"[3] kernel launches in one generate call: {counts()}", flush=True)
    if total != LAUNCHES_PER_GENERATE:
        raise AssertionError(f"{total} launches, want {LAUNCHES_PER_GENERATE}")
    if counts() != {"fwd": total, "dq": 0, "dkv": 0, "inject": 0}:
        raise AssertionError("serving launched a training kernel")
    launches = {}
    for name, h, tq, tk, d, _, want in SHAPES:
        got = by_shape.get((h, tq, tk, d), 0)
        if got != want:
            raise AssertionError(f"{name}: {got} launches, want {want}")
        launches[name] = got
    if tuple(images.shape) != (N_IMG, RES, RES, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError("non-finite image values")
    if images.min() < -1 or images.max() > 1:
        raise AssertionError("images outside [-1, 1]")
    bits, margins = decode_bits(decoder, images)
    if tuple(bits.shape) != (N_IMG, msg_bits):
        raise AssertionError(f"bits {tuple(bits.shape)}")
    if not torch.isfinite(margins).all():
        raise AssertionError("non-finite decoder margins")
    print(f"[3] images {tuple(images.shape)} finite in "
          f"[{images.min().item():.3f}, {images.max().item():.3f}] "
          f"std {images.float().std().item():.3f}; bits "
          f"{tuple(bits.shape)}, first "
          f"{''.join(map(str, bits[0].tolist()))}", flush=True)

    times = []
    for i in range(3):
        before = fa.launches.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(10 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if fa.launches.count - before != LAUNCHES_PER_GENERATE:
            raise AssertionError("launch count changed between calls")
    med = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[3] generate 8 x 512^2 DDIM-25 CFG 7.5 bf16: "
          f"{N_IMG / med:.4f} imgs/s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)} s), peak memory "
          f"{peak_gib:.2f} GiB (7.36 when the fold rounded twice) | {smi}",
          flush=True)

    # the first call again with the plain forward in the kernel's place
    kernel_fwd, before = fa.flash_attention_fwd, fa.launches.count
    fa.flash_attention_fwd = fa.flash_attention_plain
    try:
        plain_images = run(3)
    finally:
        fa.flash_attention_fwd = kernel_fwd
    diff = (images.float() - plain_images.float()).abs()
    same_bits = torch.equal(bits, decode_bits(decoder, plain_images)[0])
    print(f"[3] the same call with the plain forward "
          f"({fa.launches.count - before} kernel launches): max|d image| "
          f"{diff.max().item():.4e} (tol {PLAIN_SWAP_MAX_TOL:g}), mean "
          f"{diff.mean().item():.4e} (tol {PLAIN_SWAP_MEAN_TOL:g}), images "
          f"bit-identical {torch.equal(images, plain_images)}, bits equal "
          f"{same_bits}", flush=True)
    if not (diff.max().item() <= PLAIN_SWAP_MAX_TOL
            and diff.mean().item() <= PLAIN_SWAP_MEAN_TOL
            and fa.launches.count == before):
        raise AssertionError("the kernel's images disagree with the plain "
                             "forward's")
    del decoder, images, plain_images, diff
    torch.cuda.empty_cache()
    return launches, med, run


def phase4():
    """Tiny slice: kernel path on the card against the plain path on the
    CPU, float32, the same weights and the same initial latents."""
    import numpy as np

    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=5)
    pipes["cuda"].load_state_from(pipes["cpu"])
    decs = {dev: SecretDecoder(cfg.watermark.msg_bits,
                               EfficientNetConfig.tiny(), device=dev).eval()
            for dev in ("cpu", "cuda")}
    init_module_weights(decs["cpu"], torch.Generator().manual_seed(6))
    decs["cuda"].load_state_dict(decs["cpu"].state_dict())
    rng = np.random.default_rng(7)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    out = {}
    fa.launches.reset()
    for dev, pipe in pipes.items():
        pipe.fold_message(msg)
        gen = pipe.make_generate(num_steps=2, sampler="ddim", height=32,
                                 width=32)
        images = gen(ids, neg, guidance_scale=7.5,
                     z=torch.from_numpy(z).to(dev))
        bits, _ = decode_bits(decs[dev], images)
        out[dev] = (images.cpu(), bits.cpu())
    err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    same_bits = torch.equal(out["cuda"][1], out["cpu"][1])
    print(f"[4] tiny slice card vs CPU: max|d image| {err:.3e} "
          f"(tol {TINY_IMAGE_TOL:g}), bits equal {same_bits}, kernel "
          f"launches {fa.launches.count}", flush=True)
    if not (err <= TINY_IMAGE_TOL and same_bits and fa.launches.count > 0):
        raise AssertionError("tiny slice on the card disagrees with the CPU")


def phase5(smi: str) -> dict:
    """The backward kernels against their plain versions at every
    differentiated attention shape of the training step; times at B8."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, h, tq, tk, d, _ in TRAIN_SHAPES:
        scale = d ** -0.5
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(CHECK_BATCH, h, tq, d, device="cuda",
                                 generator=gen).to(dtype) for _ in range(2))
            k, v = (torch.randn(CHECK_BATCH, h, tk, d, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_plain(q, k, v, scale)
            delta = fa.attention_delta(o, do)
            got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
                   *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               scale))
            want = (fa.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                scale),
                    *fa.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                  scale))
            torch.cuda.synchronize()
            parts = []
            for gname, g, r in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - r.float()).abs().max().item()
                tol = tolerance_grad(dtype, r)
                parts.append(f"{gname} {err:.3e} (tol {tol:.3e}, max "
                             f"{r.float().abs().max().item():.3e})")
                if not err <= tol:
                    raise AssertionError(f"backward kernel disagrees with "
                                         f"plain: {name} {dtype} {gname} "
                                         f"{err} > {tol}")
                errs[(dtype, gname)] = err
            print(f"[5] {name} B{CHECK_BATCH} H{h} Tq{tq} Tk{tk} d{d} "
                  f"{str(dtype)[6:]}: " + ", ".join(parts), flush=True)
            del q, k, v, do, o, lse, delta, got, want
        b = TRAIN_BATCH
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        # the training batch's forward instance, which the step launches
        check_fwd(f"[5] {name} forward", q, k, v, scale, out=(o, lse))
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        t = {"dq": time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
             "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
             "pair": time_ms(lambda: fa.flash_attention_bwd(
                 q, k, v, o, lse, do, scale)),
             "dq_plain": time_ms(lambda: fa.flash_attention_dq_plain(*args),
                                 iters=3, warmup=1),
             "dkv_plain": time_ms(
                 lambda: fa.flash_attention_dkv_plain(*args), iters=3,
                 warmup=1),
             "pair_plain": time_ms(lambda: fa.flash_attention_bwd_plain(
                 q, k, v, o, lse, do, scale), iters=3, warmup=1)}
        if name == "unet64_self":
            first = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            print(f"[5] {name} B{b} bf16: two backward calls bit-identical "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError("the backward kernels are not "
                                     "deterministic")
            del first, again
        bounds = bwd_bounds(b, h, tq, tk, d)
        print(f"[5] {name} B{b} bf16: dq kernel_ms {t['dq']:.4f} plain_ms "
              f"{t['dq_plain']:.4f} bound_ms {bounds['dq'][0]:.4f} "
              f"({bounds['dq'][1]}); dkv kernel_ms {t['dkv']:.4f} plain_ms "
              f"{t['dkv_plain']:.4f} bound_ms {bounds['dkv'][0]:.4f} "
              f"({bounds['dkv'][1]}) | {smi}", flush=True)
        print(f"[5] {name} B{b} bf16 dQ + dK/dV pair: kernel_ms "
              f"{t['pair']:.4f} plain_ms {t['pair_plain']:.4f} bound_ms "
              f"{bounds['pair'][0]:.4f} ({bounds['pair'][1]}) | {smi}",
              flush=True)
        for kern in ("dq", "dkv"):
            err = errs[(torch.bfloat16, "dq")] if kern == "dq" else max(
                errs[(torch.bfloat16, "dk")], errs[(torch.bfloat16, "dv")])
            rows[(kern, name)] = {
                "max_abs_err": err, "ms": t[kern],
                "plain_ms": t[f"{kern}_plain"], "bound_ms": bounds[kern][0],
                "bound_by": bounds[kern][1], "library_ms": None}
        rows[("pair", name)] = t["pair"]
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    return rows


def inject_inputs(wdtype: torch.dtype, seed: int = 6) -> tuple:
    """The training latent's message and SecretEncoder weights [8, 48],
    dense [1024, 48] and [1024], conv [4, 4, 3, 3] and [4], the weights in
    `wdtype`, and a float32 latent maker."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    b, c, res, base, bits = TRAIN_BATCH, 4, 64, 32, 48
    msg = torch.bernoulli(torch.full((b, bits), 0.5, device="cuda"),
                          generator=gen)
    weights = tuple(w.to(wdtype) for w in (
        0.2 * rnd(base * base, bits), 0.1 * rnd(base * base),
        0.1 * rnd(c, c, 3, 3), 0.1 * rnd(c)))
    return msg, weights, lambda: rnd(b, c, res, res)


def phase6(smi: str) -> dict:
    """The injection kernel against `inject_plain` at the training latent,
    float32 and bf16 latents and weights; the time and bound at the PPFT
    trainer's types (bf16 latent, bf16 weights)."""
    from aqualora_torch.ops import secret_inject as si
    b, c, res, base, bits = TRAIN_BATCH, 4, 64, 32, 48
    row = {}
    for wdtype in (torch.float32, torch.bfloat16):
        msg, weights, latent_of = inject_inputs(wdtype)
        for dtype in (torch.float32, torch.bfloat16):
            latent = latent_of().to(dtype)
            before = si.launches.count
            out = si.fused_secret_inject(latent, msg, *weights,
                                         base_res=base)
            ref = si.inject_plain(latent, msg, *weights, base_res=base)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # float32: float32 sums in other orders; bf16: one ulp at the
            # output's largest value (both sides round float32 once)
            tol = 1e-5 if dtype == torch.float32 else \
                2.0 ** -7 * ref.float().abs().max().item() + 1e-5
            line = (f"[6] inject [{b}, {c}, {res}, {res}] latent "
                    f"{str(dtype)[6:]}, weights {str(wdtype)[6:]}: max|d| "
                    f"{err:.3e} (tol {tol:.3e}, {err / tol:.2f} of it)")
            print(line, flush=True)
            if not (err <= tol and si.launches.count == before + 1):
                raise AssertionError(f"inject kernel disagrees: {line}")
            row["max_abs_err"] = err       # the last: the PPFT types
    args = (latent, msg, *weights)
    ms = time_ms(lambda: si.fused_secret_inject(*args, base_res=base),
                 iters=100)
    plain_ms = time_ms(lambda: si.inject_plain(*args, base_res=base),
                       iters=100)
    n, cells = b * c * res * res, base * base
    # bytes: latent in and out, msg (float32), the dense and conv weights
    # and biases (bf16), each once; operations: the dense layer (a
    # multiply-add per bit, the bias) and the stencil (nine multiply-adds,
    # the latent and the bias), SiLU not counted
    nbytes = (2 * 2 * n + 4 * b * bits
              + 2 * (cells * bits + cells + 9 * c * c + c))
    bound_ms, bound_by = bound(b * cells * (2.0 * bits + 1) + 20.0 * n,
                               nbytes)
    print(f"[6] inject B{b} bf16 latent and weights: kernel_ms {ms:.4f} (the "
          f"whole wrapper: one launch) plain_ms {plain_ms:.4f} library_ms "
          f"none (no one PyTorch call computes it) bound_ms "
          f"{bound_ms:.6f} ({bound_by}) | {smi}", flush=True)
    row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    return row


def phase6_profile(smi: str) -> None:
    """One injection call at the PPFT types under torch.profiler: it must
    run exactly one CUDA kernel, the injection's; then its device time."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.ops import secret_inject as si
    msg, weights, latent_of = inject_inputs(torch.bfloat16)
    args = (latent_of().to(torch.bfloat16), msg, *weights)
    si.fused_secret_inject(*args, base_res=32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        si.fused_secret_inject(*args, base_res=32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if is_kernel(e)]
    dev = device_ms(lambda: si.fused_secret_inject(*args, base_res=32),
                    iters=20)
    print(f"[6] one inject call B{TRAIN_BATCH} bf16 runs {len(kernels)} CUDA "
          f"kernel(s): {kernels}; its device time {dev:.4f} ms | {smi}",
          flush=True)
    if len(kernels) != 1 or "secret_inject_kernel" not in kernels[0]:
        raise AssertionError(f"one inject call ran {kernels}")


def phase7():
    """Tiny PPFT step: the card (kernels) against the CPU (plain versions),
    float32, the same weights and the same draws, at 32 px so that the
    latent is 2 * secret_grid and the fused injection is taken."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretEncoder
    from aqualora_torch.train import ppft_train as pt

    cfg = PipelineConfig.tiny()
    wm = cfg.watermark
    gen = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(12)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    losses, grads = {}, {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        pipe = StableDiffusionPipeline(cfg, dtype=torch.float32, device=dev)
        sec = SecretEncoder(wm.msg_bits, wm.secret_grid, 16,
                            cfg.vae.latent_channels).to(dev)
        if side == "cpu":
            pipe.init_params(seed=11)
            init_module_weights(sec, gen)          # non-zero conv_out too
            cpu_pipe, cpu_sec = pipe, sec
            draws = pt.draw(pipe, gen, pixels)
        else:
            pipe.load_state_from(cpu_pipe)
            sec.load_state_dict(cpu_sec.state_dict())
            reset_counts()
        sec.requires_grad_(False)
        groups = pt.trainable_groups(pipe)
        loss, _ = pt.make_loss_fn(pipe, sec)(
            pixels, ids, pt.Draws(*(t.to(dev) for t in (
                draws.msg, draws.vae_noise, draws.noise, draws.t))))
        loss.backward()
        losses[side] = loss.item()
        grads[side] = [p.grad.cpu() for params in groups.values()
                       for p in params]
    launched = counts()
    worst = max(((g - r).abs().max() / r.abs().max()).item()
                for g, r in zip(grads["card"], grads["cpu"]))
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"[7] tiny PPFT step card vs CPU: loss {losses['card']:.6e} vs "
          f"{losses['cpu']:.6e} (rel {rel:.2e}, tol {TINY_LOSS_RTOL:g}); "
          f"{len(grads['cpu'])} trainable gradients, worst "
          f"max|d|/max|g| {worst:.2e} (tol {TINY_GRAD_TOL:g}); kernel "
          f"launches {launched}", flush=True)
    if not (rel <= TINY_LOSS_RTOL and worst <= TINY_GRAD_TOL
            and losses["cpu"] > 0 and min(launched.values()) > 0):
        raise AssertionError("tiny PPFT step on the card disagrees with the "
                             "CPU or skipped a kernel")


# substrings of the kernels' symbols: flash_bwd_dq matches the float32
# flash_bwd_dq_kernel and the bf16 flash_bwd_dq_tc_kernel, and not dK/dV's;
# flash_fwd every forward instance
KERNEL_NAMES = {"flash_fwd": "flash fwd", "flash_bwd_dq": "dQ",
                "flash_bwd_dkv": "dK/dV", "secret_inject_kernel": "inject"}


def profile_step(tr, step_s: float, smi: str) -> None:
    """One more training step under torch.profiler: device time by kernel
    name, the port's kernels summed, and the busy share of the median
    unprofiled step (the profiler's own cost is on the host, so the device
    times hold; the wall time under it does not)."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import ppft_train as pt
    pixels, captions = next(tr.batches)
    ids = tr.tokenizer(captions)
    draws = pt.draw(tr.pipe, tr.generator, pixels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(pixels, ids, draws)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if is_kernel(e)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("[8] device time by kernel: not measured (the profiler saw no "
              "CUDA kernel)", flush=True)
        return
    ours = {label: 0.0 for label in KERNEL_NAMES.values()}
    for e in events:
        for key, label in KERNEL_NAMES.items():
            if key in e.key:
                ours[label] += e.self_device_time_total / 1e3
    print(f"[8] profiled step: device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (step_s * 1e3):.1f}% of the {step_s * 1e3:.1f} "
          f"ms median step; the port's kernels "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items())
          + f" ({100 * sum(ours.values()) / busy_ms:.1f}% of device time) "
          f"| {smi}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[8]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d}"
              f" {e.key[:100]}", flush=True)


def phase8(smi: str) -> tuple:
    """The training path at full width through the trainer's entry point;
    returns the launches per shape and of the injection, and the trainer
    with its median step, for the profiled step after phase 12's profile."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.ops import secret_inject as si
    from aqualora_torch.train import ppft_train as pt

    args = pt.build_argparser().parse_args([
        "--rank", "320", "--msg_bits", "48", "--resolution", "512",
        "--train_batch_size", str(TRAIN_BATCH), "--mixed_precision", "bf16",
        "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
        "--max_train_steps", str(TRAIN_STEPS), "--seed", "0"])
    # phase 3's pipeline stays resident for phase 11: the step's peak is
    # counted above it
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = pt.build_trainer(args)
    # a non-zero SecretEncoder conv stands in for stage 1's weights (phase
    # 15 loads real ones with --start_from_pretrain): with its zero init
    # and the zero-init LoRA ups, student == teacher and the loss and every
    # gradient are exactly 0
    with torch.no_grad():
        w = tr.sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, device="cuda",
                                  generator=torch.Generator(device="cuda")
                                  .manual_seed(21)))
    ups = {n: p.detach().clone() for n, p in pt.split_lora(tr.pipe.unet)[1]
           .items() if n.endswith("up.weight")}
    torch.cuda.synchronize()
    print(f"[8] SD-1.5 trainer ready in {time.perf_counter() - t0:.1f} s: "
          f"{len(ups)} LoRA sites, rank {tr.pipe.config.unet.lora.rank}, "
          f"{sum(p.numel() for g in tr.groups.values() for p in g)} "
          f"float32 trainables, frozen modules in bf16", flush=True)
    want = {"fwd": FWD_PER_STEP, "dq": BWD_PER_STEP, "dkv": BWD_PER_STEP,
            "inject": 1}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                              # counts start here
    times = []
    for step in range(TRAIN_STEPS):
        pixels, captions = next(tr.batches)
        ids = tr.tokenizer(captions)
        draws = pt.draw(tr.pipe, tr.generator, pixels)
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = tr.train_step(pixels, ids, draws)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = {k: v - before[k] for k, v in counts().items()}
        loss, gnorm = (float(metrics[k]) for k in ("ppft_loss", "grad_norm"))
        print(f"[8] step {step}: {dt:.4f} s, ppft_loss {loss:.6e}, "
              f"grad_norm {gnorm:.6e}, launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"launches {got} in one step, want {want}")
        if not (math.isfinite(loss) and loss > 0 and math.isfinite(gnorm)
                and gnorm > 0):
            raise AssertionError("loss or gradient norm not finite positive")
        if step:
            times.append(dt)
    per_shape = {}
    for name, h, tq, tk, d, n in TRAIN_SHAPES:
        key = (h, tq, tk, d)
        got = (fa.launches.by_shape[key], fa.dq_launches.by_shape[key],
               fa.dkv_launches.by_shape[key])
        if got != (2 * n * TRAIN_STEPS, n * TRAIN_STEPS, n * TRAIN_STEPS):
            raise AssertionError(f"{name}: launches {got}")
        per_shape[name] = n * TRAIN_STEPS
    if fa.launches.by_shape[(1, 4096, 4096, 512)] != TRAIN_STEPS:
        raise AssertionError("VAE encoder mid-block launches")
    inject_launches = si.launches.count
    moved = sum(not torch.equal(p, ups[n]) for n, p in
                pt.split_lora(tr.pipe.unet)[1].items() if n in ups)
    print(f"[8] LoRA up weights moved at {moved} of {len(ups)} sites",
          flush=True)
    if moved != len(ups):
        raise AssertionError("LoRA up weights did not all move")
    med = statistics.median(times)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"[8] PPFT step SD-1.5 512^2 B{TRAIN_BATCH} rank 320 bf16/f32: "
          f"{TRAIN_BATCH / med:.4f} samples/s (median of {len(times)}: "
          f"{', '.join(f'{x:.4f}' for x in times)} s), peak memory "
          f"{peak_gib:.2f} GiB | {smi}", flush=True)
    return per_shape, inject_launches, (tr, med)


def phase9(smi: str, bwd_rows: dict) -> None:
    """SDPA's backward and the pair at each training shape, device time."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, h, tq, tk, d, _ in TRAIN_SHAPES:
        b, scale = TRAIN_BATCH, d ** -0.5
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        pair_dev = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, scale))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        library_ms = device_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True))
        host = (f" (phase 5's kernel_ms {bwd_rows[('pair', name)]:.4f})"
                if ("pair", name) in bwd_rows else "")
        print(f"[9] {name} B{b} bf16: library_ms(sdpa bwd, device time) "
              f"{library_ms:.4f}; the pair's device time {pair_dev:.4f} "
              f"= {pair_dev / library_ms:.2f}x{host} | {smi}", flush=True)
        del q, k, v, do, o, lse, out
        torch.cuda.empty_cache()


def phase10(smi: str, rows: dict) -> None:
    """The forward kernel and SDPA's forward at each serving shape and
    batch, at the protocol's batch and at SD-2.1's d = 64 shapes, device
    time (phase 2's kernel_ms is host-timed, which at the small shapes is
    the wrapper's launch cost)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = ([(name, h, tq, tk, d, b) for name, h, tq, tk, d, b, _ in SHAPES]
             + [(key, h, tq, tk, d, b)
                for key, _, h, tq, tk, d, b in protocol_shapes()]
             + SD21_SHAPES)
    for name, h, tq, tk, d, b in cases:
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for t in (tq, tk, tk))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d)
        host = (f" (phase 2's kernel_ms {rows[name]['ms']:.4f})"
                if name in rows else "")
        print(f"[10] {name} B{b} bf16: forward device time {kernel_dev:.4f} "
              f"ms, sdpa forward {library_dev:.4f} = "
              f"{kernel_dev / library_dev:.2f}x, bound {bound_ms:.4f} "
              f"({bound_by}){host} | {smi}", flush=True)
        if name in rows:
            rows[name].update(device_ms=kernel_dev,
                              library_device_ms=library_dev)
        del q, k, v
        torch.cuda.empty_cache()


def phase11(smi: str, run, call_s: float) -> None:
    """One more generate call of phase 3 (its pipeline, already warm) under
    torch.profiler: device time by kernel, the forward kernel's share and
    the busy share of phase 3's median unprofiled call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if is_kernel(e)
              and e.self_device_time_total > 0]
    if not events:
        print("[11] device time by kernel: not measured (the profiler saw "
              "no CUDA kernel)", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    fwd_ms = sum(e.self_device_time_total for e in events
                 if "flash_fwd" in e.key) / 1e3
    call_ms = call_s * 1e3
    print(f"[11] profiled generate call: device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / call_ms:.1f}% of the {call_ms:.1f} ms median "
          f"call; the forward kernel {fwd_ms:.1f} ms "
          f"({100 * fwd_ms / busy_ms:.1f}% of device time) | {smi}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[11]   {e.self_device_time_total / 1e3:9.2f} ms  "
              f"x{e.count:<5d} {e.key[:100]}", flush=True)


def phase12(smi: str) -> dict:
    """The d = 512 forward and backward against the plain versions at the
    stage-1 shapes; times at B5."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for name, b, h, tq, tk, d in S1_SHAPES:
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            tag = DTYPE_NAMES[dtype]
            # the kernels' peak: float32 runs 3xTF32 on the tensor cores
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else \
                PEAK_TF32_FLOPS / 3
            q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                    .to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_plain(q, k, v, scale)
            delta = fa.attention_delta(o, do)
            args = (q, k, v, do, lse, delta, scale)
            got = (fa.flash_attention_bwd_dq(*args),
                   *fa.flash_attention_bwd_dkv(*args))
            want = (fa.flash_attention_dq_plain(*args),
                    *fa.flash_attention_dkv_plain(*args))
            torch.cuda.synchronize()
            errs, parts = {}, []
            for gname, g, r in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - r.float()).abs().max().item()
                tol = tolerance_grad(dtype, r)
                parts.append(f"{gname} {err:.3e} (tol {tol:.3e}, {err / tol:.2f}"
                             f" of it, max {r.float().abs().max().item():.3e})")
                if not err <= tol:
                    raise AssertionError(f"d = 512 backward disagrees with "
                                         f"plain: {name} {tag} {gname} "
                                         f"{err} > {tol}")
                errs[gname] = err
            again = (fa.flash_attention_bwd_dq(*args),
                     *fa.flash_attention_bwd_dkv(*args))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two d = 512 backward "
                                     f"calls differ")
            del again
            print(f"[12] {name} B{b} H{h} Tq{tq} Tk{tk} d{d} {tag} (two calls "
                  f"bit-identical): "
                  + ", ".join(parts), flush=True)
            del got, want
            # the forward's instance of this type, two calls bit-identical
            fwd_out = fa.flash_attention_fwd(q, k, v, scale)
            fwd_again = fa.flash_attention_fwd(q, k, v, scale)
            if not all(torch.equal(x, y) for x, y in zip(fwd_out, fwd_again)):
                raise AssertionError(f"{name} {tag}: two d = 512 forward "
                                     f"calls differ")
            fwd_err = check_fwd(f"[12] {name} forward (two calls "
                                f"bit-identical)", q, k, v, scale,
                                out=fwd_out)
            del fwd_out, fwd_again
            if b != S1_BATCH:
                del q, k, v, do, o, lse, delta, args
                continue
            t = {"fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale),
                                iters=5, warmup=1),
                 "fwd_plain": time_ms(lambda: fa.flash_attention_plain(
                     q, k, v, scale), iters=3, warmup=1),
                 "fwd_library": time_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale), iters=5, warmup=1),
                 "dq": time_ms(lambda: fa.flash_attention_bwd_dq(*args),
                               iters=5, warmup=1),
                 "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(*args),
                                iters=5, warmup=1),
                 "dq_plain": time_ms(lambda: fa.flash_attention_dq_plain(
                     *args), iters=3, warmup=1),
                 "dkv_plain": time_ms(lambda: fa.flash_attention_dkv_plain(
                     *args), iters=3, warmup=1)}
            eb = 2 if dtype == torch.bfloat16 else 4
            bounds = bwd_bounds(b, h, tq, tk, d, eb, peak)
            fb, fby = attention_bound(b, h, tq, tk, d, eb, peak)
            cuda_core = ""
            if dtype == torch.float32:
                cc = bwd_bounds(b, h, tq, tk, d, eb, PEAK_F32_FLOPS)
                cf = attention_bound(b, h, tq, tk, d, eb, PEAK_F32_FLOPS)
                cuda_core = (f" (at the CUDA cores' float32 rate: forward "
                             f"{cf[0]:.4f}, dq {cc['dq'][0]:.4f}, dkv "
                             f"{cc['dkv'][0]:.4f}, pair {cc['pair'][0]:.4f})")
            print(f"[12] {name} B{b} {tag}: forward kernel_ms {t['fwd']:.4f} "
                  f"plain_ms {t['fwd_plain']:.4f} library_ms(sdpa) "
                  f"{t['fwd_library']:.4f} bound_ms {fb:.4f} ({fby}); dq "
                  f"kernel_ms {t['dq']:.4f} plain_ms {t['dq_plain']:.4f} "
                  f"bound_ms {bounds['dq'][0]:.4f} ({bounds['dq'][1]}); dkv "
                  f"kernel_ms {t['dkv']:.4f} plain_ms {t['dkv_plain']:.4f} "
                  f"bound_ms {bounds['dkv'][0]:.4f} ({bounds['dkv'][1]}); "
                  f"pair bound_ms {bounds['pair'][0]:.4f}{cuda_core} | {smi}",
                  flush=True)
            rows[("fwd", tag)] = {
                "max_abs_err": fwd_err, "ms": t["fwd"],
                "plain_ms": t["fwd_plain"], "bound_ms": fb, "bound_by": fby,
                "library_ms": t["fwd_library"]}
            for kern, err in (("dq", errs["dq"]),
                              ("dkv", max(errs["dk"], errs["dv"]))):
                rows[(kern, tag)] = {
                    "max_abs_err": err, "ms": t[kern],
                    "plain_ms": t[f"{kern}_plain"],
                    "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                    "library_ms": None}
            del q, k, v, do, o, lse, delta, args
            torch.cuda.empty_cache()
    return rows


def phase12_profile(smi: str) -> None:
    """The d = 512 forward and SDPA's forward, the pair and SDPA's backward,
    at the stage-1 batch as device time, and the SDPA backend torch picked
    (its backward node)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    name, b, h, tq, tk, d = S1_SHAPES[0]
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(dtype) for _ in range(2))
        fwd_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale),
                            iters=3)
        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), iters=3)
        bound_ms, bound_by = attention_bound(
            b, h, tq, tk, d, 2 if dtype == torch.bfloat16 else 4,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else
            PEAK_TF32_FLOPS / 3)
        print(f"[12] {name} B{b} {DTYPE_NAMES[dtype]}: the d = 512 forward's "
              f"device time {fwd_dev:.4f} ms; library_ms(sdpa forward, "
              f"device time) {sdpa_fwd:.4f} = {fwd_dev / sdpa_fwd:.2f}x; "
              f"bound {bound_ms:.4f} ({bound_by}) | {smi}", flush=True)
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        pair_dev = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, scale), iters=3)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        backend = type(out.grad_fn).__name__
        library_ms = device_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True), iters=3)
        print(f"[12] {name} B{b} {DTYPE_NAMES[dtype]}: the d = 512 pair's "
              f"device time {pair_dev:.4f} ms; library_ms(sdpa bwd, device "
              f"time, {backend}) {library_ms:.4f} = "
              f"{pair_dev / library_ms:.2f}x | {smi}", flush=True)
        del q, k, v, do, o, lse, out
        torch.cuda.empty_cache()


def phase13():
    """The tiny stage-1 step: the card (kernels) against the CPU (plain),
    float32, the same weights and draws, for each stage-1 distortion."""
    from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                            WatermarkConfig)
    from aqualora_torch.train import latent_wm_pretrain as s1

    pixels = torch.rand(2, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(13)) * 2 - 1
    models = {dev: s1.build_models(VAEConfig.tiny(), WatermarkConfig.tiny(),
                                   EfficientNetConfig.tiny(), dev)
              for dev in ("cpu", "cuda")}
    s1.init_models(models["cpu"], 13)
    with torch.no_grad():      # a non-zero encoder conv: every term lives
        w = models["cpu"].sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, generator=torch.Generator()
                                  .manual_seed(14)))
    for part in ("vae", "lpips", "sec_encoder", "sec_decoder"):
        getattr(models["cuda"], part).load_state_dict(
            getattr(models["cpu"], part).state_dict())
    gen = torch.Generator().manual_seed(15)
    names = models["cpu"].noiser.names
    for index, layer in enumerate(names):
        probs = [float(i == index) for i in range(len(names))]
        draws = s1.draw(models["cpu"], gen, (2, 3, 64, 64), probs)
        out = {}
        for dev, m in models.items():
            for part in ("sec_encoder", "sec_decoder"):
                getattr(m, part).zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = s1.make_loss_fn(m)(pixels.to(dev).permute(0, 3, 1, 2),
                                         draws.to(dev), s1.Control())
            loss.backward()
            out[dev] = (loss.item(), counts(), {
                f"{part}.{n}": p.grad.cpu() for part in
                ("sec_encoder", "sec_decoder") for n, p in
                getattr(m, part).named_parameters()})
        (l_card, launched, g_card), (l_cpu, _, g_cpu) = out["cuda"], out["cpu"]
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        parts = {}
        for key, g in g_cpu.items():
            part = key.split(".")[0]
            parts[part] = max(parts.get(part, 0.0), g.abs().max().item())
        # 1e-3 of each leaf's largest gradient (phase 7's limit) plus 1e-5
        # of its module's: leaves with an exact gradient of 0 (the decoder's
        # project BatchNorm biases) read float32 noise on both sides
        worst = max((g_card[key] - g).abs().max().item()
                    / (TINY_GRAD_TOL * g.abs().max().item()
                       + 1e-5 * parts[key.split(".")[0]])
                    for key, g in g_cpu.items())
        print(f"[13] tiny stage-1 step, {layer}: loss {l_card:.6e} vs "
              f"{l_cpu:.6e} (rel {rel:.2e}, tol {TINY_LOSS_RTOL:g}); "
              f"{len(g_cpu)} gradients, worst {worst:.2f} of the limit; "
              f"kernel launches {launched}", flush=True)
        want = {"fwd": 3, "dq": 1, "dkv": 1, "inject": 0}
        if not (rel <= TINY_LOSS_RTOL and worst <= 1.0 and l_cpu > 0
                and launched == want):
            raise AssertionError(f"tiny stage-1 step ({layer}) on the card "
                                 f"disagrees with the CPU or skipped a kernel")


def phase14(smi: str) -> tuple:
    """The stage-1 path at full width through the trainer's entry points,
    float32 then bf16; returns the launches per type and the trainers with
    their median step, for the profiled step after phase 12's profile."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import latent_wm_pretrain as s1

    launches, kept = {}, {}
    for mp, dtype in (("no", torch.float32), ("bf16", torch.bfloat16)):
        tag = DTYPE_NAMES[dtype]
        args = s1.build_argparser().parse_args([
            "--batch_size", str(S1_BATCH), "--mixed_precision", mp,
            "--seed", "0"])
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = s1.build_trainer(args)
        models = tr.models
        # a non-zero encoder conv (it starts at zero): every loss term and
        # every encoder gradient live from the first step
        with torch.no_grad():
            w = models.sec_encoder.conv_out.weight
            w.copy_(0.1 * torch.randn(w.shape, device="cuda", generator=torch
                                      .Generator(device="cuda").manual_seed(
                                          14)))
        trainable = {f"{part}.{n}": p.detach().clone() for part in
                     ("sec_encoder", "sec_decoder") for n, p in
                     getattr(models, part).named_parameters()}
        stats = {n: b.clone() for n, b in
                 models.sec_decoder.named_buffers() if "running" in n}
        ctl = s1.Control()
        batches = tr.dataset.batches(S1_BATCH, seed=0)
        torch.cuda.synchronize()
        print(f"[14] stage-1 trainer ({tag}) ready in "
              f"{time.perf_counter() - t0:.1f} s: {len(trainable)} trainable "
              f"tensors, {sum(p.numel() for p in trainable.values())} "
              f"parameters; frozen VAE and LPIPS in {tag}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                          # counts start here
        times = []
        for step in range(S1_STEPS):
            pixels, _ = next(batches)
            draws = s1.draw(models, tr.generator, (S1_BATCH, 3, S1_RES,
                                                   S1_RES), ctl.distort_probs)
            before = counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = tr.train_step(pixels, draws, ctl)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            got = {k: v - before[k] for k, v in counts().items()}
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[14] {tag} step {step}: {dt:.4f} s, "
                  + ", ".join(f"{k} {v:.6e}" for k, v in m.items())
                  + f", distortion {models.noiser.names[draws.noise.index]}, "
                  f"launches {got}", flush=True)
            if got != S1_PER_STEP:
                raise AssertionError(f"launches {got} in one step, want "
                                     f"{S1_PER_STEP}")
            if not (math.isfinite(m["loss"]) and m["loss"] > 0):
                raise AssertionError("stage-1 loss not finite positive")
            if step:
                times.append(dt)
        n_steps = S1_STEPS
        by_shape = (fa.launches.by_shape[S1_KEY], fa.dq_launches.by_shape[
            S1_KEY], fa.dkv_launches.by_shape[S1_KEY])
        if by_shape != (3 * n_steps, n_steps, n_steps):
            raise AssertionError(f"d = 512 launches {by_shape}")
        launches[tag] = {"fwd": by_shape[0], "dq": by_shape[1],
                         "dkv": by_shape[2]}
        moved = sum(not torch.equal(p.detach(), trainable[f"{part}.{n}"])
                    for part in ("sec_encoder", "sec_decoder") for n, p in
                    getattr(models, part).named_parameters())
        stats_moved = sum(not torch.equal(b, stats[n]) for n, b in
                          models.sec_decoder.named_buffers() if n in stats)
        print(f"[14] {tag}: {moved} of {len(trainable)} trainable tensors "
              f"moved, {stats_moved} of {len(stats)} BatchNorm statistics "
              f"moved", flush=True)
        if moved != len(trainable) or stats_moved != len(stats):
            raise AssertionError("a trainable or a BatchNorm statistic did "
                                 "not move")
        med = statistics.median(times)
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[14] stage-1 step SD-1.5 VAE, EfficientNet-B1, LPIPS-VGG16, "
              f"{S1_RES}^2 B{S1_BATCH} {tag}: {S1_BATCH / med:.4f} samples/s "
              f"(median of {len(times)}: {', '.join(f'{x:.4f}' for x in times)}"
              f" s), peak memory {peak_gib:.2f} GiB | {smi}", flush=True)
        kept[tag] = (tr, med)
    return launches, kept


def kernel_union_ms(prof) -> float:
    """Device time covered by at least one CUDA event of the profile: the
    union of their intervals (events on several streams can overlap, so
    their summed time can exceed the wall time)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events()
                   if is_kernel(e))
    total, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def phase14_profile(smi: str, kept: dict) -> None:
    """One stage-1 step of each type under torch.profiler: the busy share
    (`kernel_union_ms`) of that step's own wall time, synchronised around
    it, and the d = 512 kernels' shares of the summed kernel time.  A
    step's work depends on its draws (the distortion), so the same pixels
    and draws are first timed without the profiler, beside phase 14's
    median step."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import latent_wm_pretrain as s1
    for tag, (tr, med) in kept.items():
        ctl = s1.Control()
        pixels, _ = next(tr.dataset.batches(S1_BATCH, seed=1))
        draws = s1.draw(tr.models, tr.generator, (S1_BATCH, 3, S1_RES,
                                                  S1_RES), ctl.distort_probs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(pixels, draws, ctl)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_step(pixels, draws, ctl)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if is_kernel(e)
                  and e.self_device_time_total > 0]
        if not events:
            print(f"[14] {tag} device time by kernel: not measured (the "
                  f"profiler saw no CUDA kernel)", flush=True)
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        ours = {label: 0.0 for label in KERNEL_NAMES.values()}
        for e in events:
            for key, label in KERNEL_NAMES.items():
                if key in e.key:
                    ours[label] += e.self_device_time_total / 1e3
        pair = ours["dQ"] + ours["dK/dV"]
        name = tr.models.noiser.names[draws.noise.index]
        union_ms = kernel_union_ms(prof)
        print(f"[14] profiled {tag} stage-1 step ({name}): device busy "
              f"{union_ms:.1f} ms = {100 * union_ms / wall_ms:.1f}% of its "
              f"own {wall_ms:.1f} ms wall time (the same draws unprofiled "
              f"{plain_s * 1e3:.1f} ms, phase 14's median step "
              f"{med * 1e3:.1f} ms); kernel time summed {busy_ms:.1f} ms; "
              f"the d = 512 pair "
              f"{pair:.1f} ms ({100 * pair / busy_ms:.1f}% of device time: "
              f"dQ {ours['dQ']:.1f}, dK/dV {ours['dK/dV']:.1f}), the forward "
              f"{ours['flash fwd']:.1f} ms "
              f"({100 * ours['flash fwd'] / busy_ms:.1f}%) | {smi}",
              flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[14]   {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<5d} {e.key[:100]}", flush=True)


# phase 15, the publisher's chain: steps of each stage, the LoRA file's
# tensors at SD-1.5 widths (192 sites, down and up), the sampler's steps,
# and the tiny dpms_m slice's steps (three or more, so that a second-order
# step runs: below 15 steps the first and the last are first order)
CHAIN_STEPS = 2
CHAIN_LORA_TENSORS = 384
CHAIN_TINY_STEPS = 4


def chain_stage1(tmp: str):
    """Chain step 1: stage 1 through its entry point at 512^2 B5 bf16."""
    from aqualora_torch.train import latent_wm_pretrain as s1
    out_dir = str(Path(tmp) / "stage1")
    args = s1.build_argparser().parse_args([
        "--batch_size", str(S1_BATCH), "--mixed_precision", "bf16",
        "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
        "--output_dir", out_dir])
    reset_counts()
    res = s1.run(args)
    torch.cuda.synchronize()
    got = counts()
    # each step 3 / 1 / 1, and the epoch's sample image and eval each
    # encode and decode once
    want = {"fwd": 3 * CHAIN_STEPS + 4, "dq": CHAIN_STEPS, "dkv": CHAIN_STEPS,
            "inject": 0}
    print(f"[15] stage 1 bf16 512^2 B{S1_BATCH}, {CHAIN_STEPS} steps through "
          f"latent_wm_pretrain.run: step wall times "
          f"{', '.join(f'{x:.4f}' for x in res['seconds'])} s, final loss "
          f"{res['history'][-1]['loss']:.6e}, launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"stage-1 launches {got}, want {want}")
    if not all(math.isfinite(h["loss"]) and h["loss"] > 0
               for h in res["history"]):
        raise AssertionError("stage-1 loss not finite positive")
    enc = {k: v.detach().clone() for k, v in
           res["trainer"].models.sec_encoder.state_dict().items()}
    return str(Path(out_dir) / "pretrained_latentwm.pt"), enc


def chain_ppft(tmp: str, s1_file: str, s1_encoder: dict):
    """Chain steps 2-3: PPFT from stage 1's file through its entry point
    at 512^2 B8 rank 320 bf16, with the artifacts and the final sanity
    inference; then the three files and the LoRA file's write and read
    times.  Returns the output directory and the trained tensors."""
    from aqualora_torch.core import io as aio
    from aqualora_torch.train import ppft_train as pt
    out_dir = str(Path(tmp) / "ppft")
    args = pt.build_argparser().parse_args([
        "--rank", "320", "--msg_bits", "48", "--resolution", "512",
        "--train_batch_size", str(TRAIN_BATCH), "--mixed_precision", "bf16",
        "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
        "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
        "--start_from_pretrain", s1_file, "--output_dir", out_dir,
        "--validation_prompt", PROMPTS[0],
        "--num_validation_images", "1"])
    reset_counts()
    res = pt.run(args)
    torch.cuda.synchronize()
    got = counts()
    # each step 65 / 32 / 32 / 1; the sanity inference is one generate call
    want = {"fwd": FWD_PER_STEP * CHAIN_STEPS + LAUNCHES_PER_GENERATE,
            "dq": BWD_PER_STEP * CHAIN_STEPS,
            "dkv": BWD_PER_STEP * CHAIN_STEPS, "inject": CHAIN_STEPS}
    hist = res["history"]
    print(f"[15] PPFT 512^2 B{TRAIN_BATCH} rank 320 bf16 from stage 1's file, "
          f"{CHAIN_STEPS} steps through ppft_train.run: step wall times "
          f"{', '.join(f'{x:.4f}' for x in res['seconds'])} s, ppft_loss "
          f"{', '.join(f'{h['ppft_loss']:.6e}' for h in hist)}, grad_norm "
          f"{', '.join(f'{h['grad_norm']:.6e}' for h in hist)}; sanity "
          f"inference (dpms_m 25, B1) bit accuracy "
          f"{res['sanity_bit_accuracy']:.4f}; launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"PPFT launches {got}, want {want}")
    if not all(math.isfinite(h[k]) and h[k] > 0 for h in hist
               for k in ("ppft_loss", "grad_norm")):
        raise AssertionError("PPFT loss or gradient norm not finite positive")
    tr = res["trainer"]
    enc = tr.sec_encoder.state_dict()
    same_enc = all(torch.equal(enc[k], s1_encoder[k]) for k in s1_encoder)
    f32_enc = all(v.dtype == torch.float32 for v in enc.values())
    print(f"[15] PPFT SecretEncoder equals stage 1's bit for bit: "
          f"{same_enc}; float32: {f32_enc}", flush=True)
    if not (same_enc and f32_enc and set(enc) == set(s1_encoder)):
        raise AssertionError("the PPFT encoder is not stage 1's, in float32")

    lora_path = Path(out_dir) / aio.LORA_FILE
    header, _, _, data_len = aio.read_safetensors_header(str(lora_path))
    n_params = sum(math.prod(h["shape"]) for h in header.values())
    mapper = aio.load_safetensors(str(Path(out_dir) / aio.MAPPER_FILE))
    dec_state = torch.load(Path(out_dir) / pt.MSGDECODER_FILE,
                           map_location="cpu", weights_only=True)
    # the LoRA file's write (the export save_artifacts makes) and read times
    again = Path(tmp) / "again.safetensors"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aio.export_lora_safetensors(tr.pipe.unet, tr.pipe.config.unet, str(again))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = aio.load_safetensors(str(lora_path), "cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same_bytes = again.read_bytes() == lora_path.read_bytes()
    size = lora_path.stat().st_size
    print(f"[15] {aio.LORA_FILE}: {len(header)} tensors, {n_params} "
          f"parameters, {size} bytes ({size / 2 ** 30:.4f} GiB); write "
          f"{write_s:.4f} s ({size / write_s / 2 ** 30:.3f} GiB/s), read to "
          f"the card {read_s:.4f} s ({size / read_s / 2 ** 30:.3f} GiB/s); a "
          f"second export gives the same bytes: {same_bytes}; "
          f"{aio.MAPPER_FILE}: "
          + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in
                      mapper.items())
          + f"; {pt.MSGDECODER_FILE}: {len(dec_state)} tensors", flush=True)
    emb = mapper.get("bit_embeddings.weight")
    if not (len(header) == CHAIN_LORA_TENSORS and same_bytes
            and data_len == 4 * n_params and emb is not None
            and emb.dtype == torch.float32
            and tuple(emb.shape) == (48, 320)
            and set(dec_state) == set(tr.msgdecoder.state_dict())):
        raise AssertionError("the saved artifacts are not as written")
    trained = {"lora": {k: p.detach().clone() for k, p in
                        pt.split_lora(tr.pipe.unet)[1].items()},
               "mapper": tr.pipe.mapper.bit_embeddings.weight.detach().clone(),
               "decoder": {k: v.detach().clone() for k, v in
                           tr.msgdecoder.state_dict().items()}}
    del res, tr, loaded
    torch.cuda.empty_cache()
    return out_dir, trained


def chain_generate(smi: str, out_dir: str, trained: dict,
                   ddim_s: float | None) -> tuple:
    """Chain steps 4-5: a fresh pipeline loads the saved LoRA, mapper and
    decoder, folds a message and generates B8 at 512^2 with DPM-Solver++(2M)
    25 steps at CFG 7.5 from per-image generators; decode the bits.
    Returns the median call in seconds and the first image (NHWC)."""
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion import pipeline as pl
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import ppft_train as pt

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = PipelineConfig.sd15(lora_rank=320)
    pipe = pl.StableDiffusionPipeline(cfg, dtype=torch.bfloat16,
                                      device="cuda")
    pipe.init_params(seed=0)                 # the trainer's base weights
    pipe.load_watermark_lora(out_dir)
    decoder = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.b1(),
                            device="cuda")
    decoder.load_state_dict(torch.load(Path(out_dir) / pt.MSGDECODER_FILE,
                                       map_location="cuda",
                                       weights_only=True))
    decoder.eval()
    lora = pt.split_lora(pipe.unet)[1]
    same = (set(lora) == set(trained["lora"])
            and all(torch.equal(lora[k], v) for k, v in
                    trained["lora"].items())
            and torch.equal(pipe.mapper.bit_embeddings.weight,
                            trained["mapper"])
            and all(torch.equal(decoder.state_dict()[k], v)
                    for k, v in trained["decoder"].items()))
    print(f"[15] fresh pipeline: {len(lora)} LoRA tensors, the mapper and "
          f"the decoder loaded from {Path(out_dir).name}/; equal to the "
          f"trained ones bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError("the loaded artifacts differ from the trained")
    msg = torch.bernoulli(torch.full((cfg.watermark.msg_bits,), 0.5),
                          generator=torch.Generator().manual_seed(15))
    pipe.fold_message(msg)
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)
    generate = pipe.make_generate(num_steps=STEPS, sampler="dpms_m",
                                  height=RES, width=RES)

    def gens(seed):
        return [torch.Generator(device="cuda").manual_seed(seed + i)
                for i in range(N_IMG)]

    # the call's initial latent, recorded where generate draws it
    drawn = []
    draw = pl.batch_randn
    pl.batch_randn = lambda *a, **k: drawn.append(draw(*a, **k)) or drawn[-1]
    try:
        reset_counts()
        images = generate(ids, neg, guidance_scale=7.5, generator=gens(100))
        torch.cuda.synchronize()
        per_call = counts()
    finally:
        pl.batch_randn = draw
    rows_ok = all(torch.equal(drawn[0][i:i + 1], torch.randn(
        (1, *drawn[0].shape[1:]), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(100 + i)))
        for i in range(N_IMG))
    repeat = generate(ids, neg, guidance_scale=7.5, generator=gens(100))
    identical = torch.equal(images, repeat)
    times = []
    for i in range(3):
        before = fa.launches.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(ids, neg, guidance_scale=7.5, generator=gens(200 + 10 * i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if fa.launches.count - before != LAUNCHES_PER_GENERATE:
            raise AssertionError("launch count changed between calls")
    med = statistics.median(times)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bits, margins = decode_bits(decoder, images)
    acc = (bits.cpu() == msg.long()).float().mean().item()
    beside = (f"; phase 3's DDIM-25 {N_IMG / ddim_s:.4f} imgs/s, dpms_m / "
              f"DDIM time {med / ddim_s:.4f}" if ddim_s else "")
    print(f"[15] generate 8 x 512^2 dpms_m-25 CFG 7.5 bf16, message folded: "
          f"{N_IMG / med:.4f} imgs/s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)} s){beside}; peak memory "
          f"{peak_gib:.2f} GiB above the {base / 2 ** 30:.2f} GiB resident; "
          f"launches a call {per_call}; images {tuple(images.shape)} finite "
          f"{bool(torch.isfinite(images).all())}; repeat call bit-identical "
          f"{identical}; row i of the B8 latent is generator i's B1 draw "
          f"{rows_ok}; decoded bit accuracy {acc:.4f} (random weights: "
          f"printed, not checked) | {smi}", flush=True)
    want = {"fwd": LAUNCHES_PER_GENERATE, "dq": 0, "dkv": 0, "inject": 0}
    if not (per_call == want and identical and rows_ok
            and tuple(images.shape) == (N_IMG, RES, RES, 3)
            and torch.isfinite(images).all()
            and torch.isfinite(margins).all()):
        raise AssertionError("the chain's generate failed a check")
    return med, images[:1].clone()


def chain_tiny_card_vs_cpu() -> None:
    """Chain step 6: the tiny dpms_m slice on the card (kernels) against the
    CPU (plain versions), float32, the same weights and initial latents."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=15)
    pipes["cuda"].load_state_from(pipes["cpu"])
    rng = np.random.default_rng(15)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    out = {}
    fa.launches.reset()
    for dev, pipe in pipes.items():
        pipe.fold_message(msg)
        gen = pipe.make_generate(num_steps=CHAIN_TINY_STEPS, sampler="dpms_m",
                                 height=32, width=32)
        out[dev] = gen(ids, neg, guidance_scale=7.5,
                       z=torch.from_numpy(z).to(dev)).cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    print(f"[15] tiny dpms_m-{CHAIN_TINY_STEPS} slice card vs CPU: max|d "
          f"image| {err:.3e} (tol {TINY_IMAGE_TOL:g}), kernel launches "
          f"{fa.launches.count}", flush=True)
    if not (err <= TINY_IMAGE_TOL and fa.launches.count > 0):
        raise AssertionError("tiny dpms_m slice on the card disagrees with "
                             "the CPU")


def phase15(smi: str, ddim_s: float | None, tmp: str) -> tuple:
    """The publisher's chain at full width: stage 1 -> PPFT from its file ->
    the artifacts saved (under `tmp`, which phase 16 reads) -> a fresh
    pipeline loads them -> dpms_m generate -> decode; then the tiny dpms_m
    slice card vs CPU.  The counts are set to 0 before each stage and read
    after it.  Returns the PPFT output directory, the median dpms_m B8 call
    in seconds, stage 1's file and one generated image (phase 18 reads
    them)."""
    s1_file, s1_encoder = chain_stage1(tmp)
    torch.cuda.empty_cache()
    out_dir, trained = chain_ppft(tmp, s1_file, s1_encoder)
    dpms_s, image = chain_generate(smi, out_dir, trained, ddim_s)
    del trained
    torch.cuda.empty_cache()
    chain_tiny_card_vs_cpu()
    return out_dir, dpms_s, s1_file, image


# phase 16, the auditor's path: run_eval_base at the protocol's settings
# (dpms_m 25, CFG 7.5, 512^2, bf16, batch 4) on phase 15's artifacts, 8
# prompts x 2 seeds; the per-image path at one B4 batch of 4 messages
EVAL_PROMPTS, EVAL_SEEDS = 8, 2
EVAL_MSG_BITS = 48
NO_TRAINING = {"dq": 0, "dkv": 0, "inject": 0}


class RunnerParts:
    """Times the runner's parts by wrapping what `utils_eval` calls (each
    wrapper synchronizes the card before it stops its clock), counts the
    forward launches of each generate call, and keeps the device-quantized
    images.  `install()` / `remove()` put the wrappers in and take them
    out."""

    def __init__(self):
        from aqualora_torch.diffusion import pipeline as pl
        from aqualora_torch.eval import utils_eval as ue
        self.targets = [(ue, "images_to_uint8"), (ue, "save_png"),
                        (ue, "preprocess"), (ue, "decode_bits"),
                        (pl.StableDiffusionPipeline, "make_generate")]
        self.saved = {}
        self.reset()

    def reset(self):
        self.seconds = {"generate": 0.0, "quantize_fetch": 0.0,
                        "png_write": 0.0, "png_read_preprocess": 0.0,
                        "decode": 0.0}
        self.per_call, self.images = [], []

    def _timed(self, part, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds[part] += time.perf_counter() - t0
            return out
        return wrapper

    def install(self):
        self.saved = {(obj, name): getattr(obj, name)
                      for obj, name in self.targets}
        ue, pl_cls = self.targets[0][0], self.targets[-1][0]
        quantize = self._timed("quantize_fetch", self.saved[
            (ue, "images_to_uint8")])

        def keep(images):
            out = quantize(images)
            self.images.extend(out)
            return out

        make_generate = self.saved[(pl_cls, "make_generate")]

        def counted_make_generate(pipe, *a, **k):
            generate = self._timed("generate", make_generate(pipe, *a, **k))

            def counted(*ga, **gk):
                torch.cuda.synchronize()
                before = counts()
                out = generate(*ga, **gk)
                after = counts()
                self.per_call.append({c: after[c] - before[c] for c in after})
                return out
            return counted

        ue.images_to_uint8 = keep
        ue.save_png = self._timed("png_write", self.saved[(ue, "save_png")])
        ue.preprocess = self._timed("png_read_preprocess",
                                    self.saved[(ue, "preprocess")])
        ue.decode_bits = self._timed("decode",
                                     self.saved[(ue, "decode_bits")])
        pl_cls.make_generate = counted_make_generate

    def remove(self):
        for (obj, name), fn in self.saved.items():
            setattr(obj, name, fn)


def run_runner(argv, parts: RunnerParts, n_images: int) -> tuple:
    """One `run_eval_base.main(argv)` with the counts set to 0 before it
    and read after it, and the parts timed; -> (result, wall seconds,
    launches by shape, counts)."""
    from aqualora_torch.eval import run_eval_base
    from aqualora_torch.ops import flash_attention as fa
    parts.reset()
    parts.install()
    try:
        torch.cuda.synchronize()
        reset_counts()                          # counts start here
        t0 = time.perf_counter()
        result = run_eval_base.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_shape = counts(), dict(fa.launches.by_shape)
    finally:
        parts.remove()
    calls = n_images // PROTOCOL_IMAGES
    want_call = {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}
    if (len(parts.per_call) != calls
            or any(c != want_call for c in parts.per_call)
            or got != {"fwd": calls * LAUNCHES_PER_GENERATE, **NO_TRAINING}):
        raise AssertionError(f"runner launches {got}, per call "
                             f"{parts.per_call}; want {calls} calls of "
                             f"{want_call}")
    return result, wall, by_shape, got


def phase16(smi: str, out_dir: str, tmp: str,
            dpms_s: float | None) -> dict:
    """The auditor's path at full width on phase 15's artifacts, through
    the entry points a user calls: run_eval_base with --train_folder
    --hidinfo (the message folded in memory), then create_wm_lora's CLI
    and run_eval_base with --lora --msg_gt (the folded file); then
    simple_sample with one message per image in one B4 batch.  Returns the
    forward launches by serving shape of the first run."""
    import numpy as np

    from aqualora_torch.eval import image_io
    from aqualora_torch.eval import utils_eval as ue
    from aqualora_torch.eval.prompts import load_prompts
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.tools import create_wm_lora as cwl
    from aqualora_torch.train.ppft_train import MSGDECODER_FILE

    dec_path = str(Path(out_dir) / MSGDECODER_FILE)
    rng = np.random.default_rng(16)
    hidinfo = "".join(map(str, rng.integers(0, 2, EVAL_MSG_BITS)))
    n_images = EVAL_PROMPTS * EVAL_SEEDS
    common = ["--msgdecoder_path", dec_path, "--num_prompts",
              str(EVAL_PROMPTS), "--num_seeds", str(EVAL_SEEDS),
              "--batch_size", str(PROTOCOL_IMAGES), "--sampler", "dpms_m",
              "--steps", str(STEPS), "--cfg", "7.5", "--resolution",
              str(RES), "--msg_bits", str(EVAL_MSG_BITS), "--device", "cuda"]
    names = [f"{s}_{i}.png" for s in range(EVAL_SEEDS)
             for i in range(EVAL_PROMPTS)]
    parts = RunnerParts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # flow 1: the message folded in memory
    eval1 = Path(tmp) / "eval_one_step"
    res1, wall, by_shape, got = run_runner(
        ["--train_folder", out_dir, "--hidinfo", hidinfo,
         "--output_dir", str(eval1)] + common, parts, n_images)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    seconds, in_memory = dict(parts.seconds), list(parts.images)
    pngs = sorted(p.name for p in (eval1 / "images").glob("*.png"))
    on_disk = json.loads((eval1 / "eval_base.json").read_text())
    rest = wall - sum(seconds.values())
    print(f"[16] run_eval_base --train_folder --hidinfo: {n_images} images "
          f"({EVAL_PROMPTS} prompts x {EVAL_SEEDS} seeds) at 512^2 dpms_m-"
          f"{STEPS} CFG 7.5 bf16 B{PROTOCOL_IMAGES} in {wall:.4f} s = "
          f"{n_images / wall:.4f} images/s end to end"
          + (f" (phase 15's dpms_m B8 generate {N_IMG / dpms_s:.4f} imgs/s)"
             if dpms_s else "")
          + "; seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       seconds.items())
          + f", the rest (pipeline build, fold, prompts) {rest:.4f}; peak "
          f"memory {peak_gib:.2f} GiB above the {base / 2 ** 30:.2f} GiB "
          f"resident; launches {got}, each generate call "
          f"{parts.per_call[0]}; bit_accuracy {res1['bit_acc']:.4f} TPR "
          f"{res1['tpr']:.4f} at FPR {res1['fpr']:g} (random weights: "
          f"printed, not checked) | {smi}", flush=True)
    if not (pngs == sorted(names) and len(in_memory) == n_images
            and on_disk == res1 and res1["n_images"] == n_images
            and res1["message"] == hidinfo and res1["sampler"] == "dpms_m"
            and 0.0 <= res1["bit_acc"] <= 1.0 and 0.0 <= res1["tpr"] <= 1.0):
        raise AssertionError(f"the runner's outputs are not as written: "
                             f"{pngs}, {res1}, {on_disk}")
    # the PNG round trip is lossless: the files decode to the bits of the
    # same calls' device-quantized images
    png_arrays = [image_io.load_png(str(eval1 / "images" / n)) for n in names]
    same_pixels = all(np.array_equal(a, b)
                      for a, b in zip(png_arrays, in_memory))
    _, _, from_png = ue.simple_decode(EVAL_MSG_BITS, dec_path,
                                      [str(eval1 / "images" / n)
                                       for n in names], resolution=RES, device="cuda")
    _, _, from_memory = ue.simple_decode(EVAL_MSG_BITS, dec_path, in_memory,
                                         resolution=RES, device="cuda")
    print(f"[16] PNGs read back equal the device-quantized images: "
          f"{same_pixels}; bits from the PNGs equal the bits from memory: "
          f"{from_png == from_memory} ({len(set(from_png))} distinct "
          f"bitstrings)", flush=True)
    if not (same_pixels and from_png == from_memory):
        raise AssertionError("the PNG round trip lost information")

    # flow 2: create_wm_lora's CLI, then the folded file with --msg_gt
    t0 = time.perf_counter()
    written = cwl.main(["--train_folder", out_dir, "--msg_bits",
                        str(EVAL_MSG_BITS), "--hidinfo", hidinfo])
    fold_s = time.perf_counter() - t0
    eval2 = Path(tmp) / "eval_two_step"
    res2, wall2, _, _ = run_runner(
        ["--lora", str(Path(out_dir) / hidinfo /
                       "pytorch_lora_weights.safetensors"),
         "--msg_gt", hidinfo, "--output_dir", str(eval2)] + common,
        parts, n_images)
    same_images = all(np.array_equal(
        image_io.load_png(str(eval1 / "images" / n)),
        image_io.load_png(str(eval2 / "images" / n))) for n in names)
    same_result = all(res2[k] == res1[k] for k in
                      ("bit_acc", "tpr", "n_images", "message"))
    rest2 = wall2 - sum(parts.seconds.values())
    print(f"[16] create_wm_lora CLI {fold_s:.4f} s, then run_eval_base "
          f"--lora --msg_gt: {n_images / wall2:.4f} images/s ({wall2:.4f} "
          f"s; seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      parts.seconds.items())
          + f", the rest {rest2:.4f}); the same images as the one-step "
          f"flow: {same_images}; the same eval_base.json fields: "
          f"{same_result} | {smi}", flush=True)
    if not (written == hidinfo and same_images and same_result):
        raise AssertionError("the two flows disagree")

    # one message per image in one B4 batch, against each message folded
    msgs = ["".join(map(str, r)) for r in
            rng.integers(0, 2, (PROTOCOL_IMAGES, EVAL_MSG_BITS))]
    prompts = load_prompts(None, PROTOCOL_IMAGES)
    kw = dict(seeds=[0], batch_size=PROTOCOL_IMAGES, resolution=RES,
              num_inference_steps=STEPS, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    per_image = ue.simple_sample(None, "dpms_m", prompts, messages=msgs,
                                 train_folder=out_dir, **kw)
    torch.cuda.synchronize()
    got = counts()
    if got != {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}:
        raise AssertionError(f"per-image call launches {got}")
    pi_bits = ue.simple_decode(EVAL_MSG_BITS, dec_path, per_image,
                               resolution=RES, device="cuda")[2]
    for i, m in enumerate(msgs):
        _, folded = cwl.create_watermark_lora(out_dir, msg_bits=EVAL_MSG_BITS,
                                              hidinfo=m, save=False)
        f_img = ue.simple_sample(None, "dpms_m", prompts, lora=folded,
                                 **kw)[i]
        f_bits = ue.simple_decode(EVAL_MSG_BITS, dec_path, [f_img],
                                  resolution=RES, device="cuda")[2][0]
        d = np.abs(f_img.astype(np.int16) - per_image[i].astype(np.int16))
        agree = sum(a == b for a, b in zip(f_bits, pi_bits[i]))
        print(f"[16] per-image message {i} (one B4 call, {got['fwd']} "
              f"forward launches) against the same message folded: max|d "
              f"pixel| {int(d.max())}, mean {d.mean():.4f} levels; decoded "
              f"bits agree {agree}/{EVAL_MSG_BITS}; bits match the message "
              f"{sum(a == b for a, b in zip(pi_bits[i], m))}/"
              f"{EVAL_MSG_BITS} (random weights: printed)", flush=True)
        del folded
        torch.cuda.empty_cache()
    return {name: by_shape.get((h, tq, tk, d), 0)
            for name, h, tq, tk, d, _, _ in SHAPES}


# phase 17, the samplers: the tiny slice's steps (enough for each sampler's
# higher-order steps) and the full-width call's
TINY_SAMPLER_STEPS = 5


def phase17(smi: str) -> None:
    """Each of the twelve samplers: the tiny slice on the card (kernels)
    against the CPU (plain versions), float32, the same weights, initial
    latents and draws; then at full width (SD-1.5 512^2, B8, CFG 7.5, 25
    steps, bf16, a folded message), one timed call after a shared warm-up,
    beside DDIM-25's: forward launches = 32 per U-Net evaluation + 1."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion import samplers as smp
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=17)
    pipes["cuda"].load_state_from(pipes["cpu"])
    rng = np.random.default_rng(17)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    for pipe in pipes.values():
        pipe.fold_message(msg)
    draw = smp.batch_randn
    for name in sorted(smp.SAMPLERS):
        out = {}
        fa.launches.reset()
        for dev, pipe in pipes.items():
            # the stochastic samplers' draws: the same numbers on both sides
            cpu_gen = torch.Generator().manual_seed(170)
            smp.batch_randn = (lambda shape, generator, device,
                               dtype=torch.float32, g=cpu_gen:
                               torch.randn(shape, generator=g, dtype=dtype)
                               .to(device))
            try:
                gen = pipe.make_generate(num_steps=TINY_SAMPLER_STEPS,
                                         sampler=name, height=32, width=32)
                out[dev] = gen(ids, neg, guidance_scale=7.5,
                               z=torch.from_numpy(z).to(dev)).cpu()
            finally:
                smp.batch_randn = draw
        err = (out["cuda"] - out["cpu"]).abs().max().item()
        print(f"[17] tiny {name}-{TINY_SAMPLER_STEPS} slice card vs CPU: "
              f"max|d image| {err:.3e} (tol {TINY_IMAGE_TOL:g}), kernel "
              f"launches {fa.launches.count}", flush=True)
        if not (err <= TINY_IMAGE_TOL and fa.launches.count > 0):
            raise AssertionError(f"tiny {name} slice on the card disagrees "
                                 "with the CPU")
    del pipes

    cfg = PipelineConfig.sd15(lora_rank=320)
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device="cuda")
    pipe.init_params(seed=0)
    pipe.fold_message(torch.bernoulli(
        torch.full((cfg.watermark.msg_bits,), 0.5),
        generator=torch.Generator().manual_seed(17)))
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)

    def gens(seed):
        return [torch.Generator(device="cuda").manual_seed(seed + i)
                for i in range(N_IMG)]

    pipe.make_generate(STEPS, "ddim", RES, RES)(ids, neg, 7.5,
                                                generator=gens(0))
    per_unet = LAUNCHES_PER_GENERATE // STEPS            # 32
    ddim_s = None
    for name in ["ddim"] + sorted(set(smp.SAMPLERS) - {"ddim"}):
        generate = pipe.make_generate(STEPS, name, RES, RES)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        images = generate(ids, neg, 7.5, generator=gens(300))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        got = counts()
        evals = smp.unet_evaluations(name, STEPS)
        ddim_s = ddim_s or call_s
        print(f"[17] {name}-{STEPS} 8 x 512^2 CFG 7.5 bf16, message folded: "
              f"{evals} U-Net evaluations, {got['fwd']} forward launches, "
              f"{N_IMG / call_s:.4f} imgs/s (one call, {call_s:.4f} s; "
              f"DDIM-{STEPS} {N_IMG / ddim_s:.4f}); images finite "
              f"{bool(torch.isfinite(images).all())} | {smi}", flush=True)
        if not (got == {"fwd": per_unet * evals + 1, **NO_TRAINING}
                and tuple(images.shape) == (N_IMG, RES, RES, 3)
                and torch.isfinite(images).all()):
            raise AssertionError(f"{name} at full width: launches {got}, "
                                 f"images {tuple(images.shape)}")
    del pipe, images
    torch.cuda.empty_cache()


# phase 18, stage 3 (the decoder's robustness fine-tune): B4 (8 under CFG),
# dpms_m 20 steps a generation, one resolution of RESOLUTIONS a step.  512^2
# at B4 is phase 2's protocol batch; the four others are new to the card.
STAGE3_BATCH = 4
STAGE3_NEW_RES = (576, 640, 704, 768)
STAGE3_GEN_STEPS = 20
STAGE3_PER_STEP = 32 * STAGE3_GEN_STEPS + 1                  # 641
# seed 0 draws the resolutions 768, 704, 640, 576, 576, 512 for steps 1-6
STAGE3_SEED = 0
STAGE3_STEPS, STAGE3_FIRST = 6, 4       # 4 steps, then resumed to 6
STAGE3_TIMED = 4                        # 1 warm-up + 3 timed, per resolution
STAGE3_TINY_RES = 48


def stage3_shapes(res: int) -> list:
    """The forward's shapes of one stage-3 generate at res^2: (key, heads,
    Tq, Tk, d, batch, launches a step): self and cross at each U-Net level
    (the latent res // 8, halved three times; 5 launches a U-Net evaluation
    each, 1 at the lowest) and the VAE's mid-block."""
    n, out = res // 8, []
    for side, d, per in ((n, 40, 5), (n // 2, 80, 5), (n // 4, 160, 5),
                         (n // 8, 160, 1)):
        for kind, tk in (("self", side * side), ("cross", 77)):
            out.append((f"stage3_{res}_unet{side}_{kind}", 8, side * side,
                        tk, d, 2 * STAGE3_BATCH, per * STAGE3_GEN_STEPS))
    out.append((f"stage3_{res}_vae_mid", 1, n * n, n * n, 512, STAGE3_BATCH,
                1))
    return out


def phase18a(smi: str) -> dict:
    """Every forward shape of a stage-3 generate at 576^2-768^2 (ROADMAP
    B.0), bf16 at its batch: two calls bit-identical, against the plain
    version, the tiling, kernel, plain, SDPA and bound times; at 768^2 also
    float32 and bf16 at batch 2 (the CUDA-core instances at d <= 160, the
    3xTF32 one at d = 512).  Rows keyed by the shape's key."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    for res in STAGE3_NEW_RES:
        for key, h, tq, tk, d, b, _ in stage3_shapes(res):
            rows[key] = check_serving_shape(key, h, tq, tk, d, b, gen, smi,
                                            at_b2=res == 768, phase=18,
                                            plain=plain_by_batch)
    return rows


def phase18a_profile(smi: str, rows: dict) -> None:
    """The 768^2 shapes' forward and SDPA's forward as device time (as
    phase 10)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(181)
    for key, h, tq, tk, d, b, _ in stage3_shapes(768):
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for t in (tq, tk, tk))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d)
        print(f"[18] {key} B{b} bf16: forward device time {kernel_dev:.4f} "
              f"ms, sdpa forward {library_dev:.4f} = "
              f"{kernel_dev / library_dev:.2f}x, bound {bound_ms:.4f} "
              f"({bound_by}) (phase 18's kernel_ms {rows[key]['ms']:.4f}) "
              f"| {smi}", flush=True)
        rows[key].update(device_ms=kernel_dev, library_device_ms=library_dev)
        del q, k, v
        torch.cuda.empty_cache()


def phase18b(tmp: str) -> None:
    """The tiny stage-3 step on the card (kernels) against the CPU (plain),
    float32, the same weights and draws: the generated images, the loss
    and every decoder gradient, once for each of the five distortions."""
    import dataclasses

    from aqualora_torch.train import rob_enhance_finetune as s3
    trs = {dev: s3.build_trainer(s3.build_argparser().parse_args([
        "--tiny", "--train_batch_size", "2", "--device", dev, "--seed", "18",
        "--lr_warmup_steps", "0", "--report_to", "none",
        "--output_dir", str(Path(tmp) / "stage3_tiny")]))
        for dev in ("cpu", "cuda")}
    cpu = trs["cpu"]
    trs["cuda"].pipe.load_state_from(cpu.pipe)
    start = {k: v.clone() for k, v in cpu.decoder.state_dict().items()}
    gen = torch.Generator().manual_seed(18)
    res, captions = STAGE3_TINY_RES, ["a photo of a cat", "a red fox"]
    for index, kind in enumerate(cpu.noiser.names):
        probs = [float(i == index) for i in range(len(cpu.noiser.names))]
        d = s3.draw(cpu.pipe, cpu.decoder, cpu.noiser, gen, 2, res)
        d = dataclasses.replace(d, noise=cpu.noiser.draw(
            gen, (2, 3, res, res), probs))
        out = {}
        for dev, tr in trs.items():
            tr.decoder.load_state_dict(start)
            dd = d.to(dev)
            reset_counts()
            images = s3.generate_images(tr, res, captions, dd)
            metrics = tr.decoder_step(images, dd.msg, dd.noise, dd.masks)
            out[dev] = (images.cpu(), float(metrics["loss"]), counts(), {
                n: p.grad.cpu() for n, p in tr.decoder.named_parameters()})
        (i_card, l_card, launched, g_card), (i_cpu, l_cpu, _, g_cpu) = (
            out["cuda"], out["cpu"])
        img_err = (i_card - i_cpu).abs().max().item()
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        top = max(g.abs().max().item() for g in g_cpu.values())
        # phase 13's limit: 1e-3 of each leaf's largest gradient plus 1e-5
        # of the module's
        worst = max((g_card[n] - g).abs().max().item()
                    / (TINY_GRAD_TOL * g.abs().max().item() + 1e-5 * top)
                    for n, g in g_cpu.items())
        print(f"[18] tiny stage-3 step at {res}^2, {kind}: max|d image| "
              f"{img_err:.3e} (tol {TINY_IMAGE_TOL:g}); loss {l_card:.6e} vs "
              f"{l_cpu:.6e} (rel {rel:.2e}, tol {TINY_LOSS_RTOL:g}); "
              f"{len(g_cpu)} gradients, worst {worst:.2f} of the limit; "
              f"kernel launches {launched}", flush=True)
        if not (img_err <= TINY_IMAGE_TOL and rel <= TINY_LOSS_RTOL
                and worst <= 1.0 and l_cpu > 0 and launched["fwd"] > 0
                and launched["dq"] == launched["dkv"] == 0):
            raise AssertionError(f"tiny stage-3 step ({kind}) on the card "
                                 f"disagrees with the CPU")


def stage3_argv(s1_file: str, ppft_dir: str, out: str, steps: int,
                *extra: str) -> list:
    """The stage-3 CLI's arguments at full width.  The learning rate is
    constant (no warm-up, and `--lr_end 1` holds the cosine at its start),
    so that a run of 4 steps resumed to 6 follows the schedule of a 6-step
    run: the cosine's length is the run's step count."""
    return ["--rank", "320", "--msg_bits", "48", "--resolution", "512",
            "--train_batch_size", str(STAGE3_BATCH), "--mixed_precision",
            "bf16", "--lr_warmup_steps", "0", "--lr_end", "1",
            "--checkpointing_steps", "2",
            "--seed", str(STAGE3_SEED), "--start_from_pretrain", s1_file,
            "--resume_from_lora", ppft_dir, "--output_dir", out,
            "--max_train_steps", str(steps), *extra]


def run_stage3(tag: str, argv: list, n_steps: int, smi: str) -> tuple:
    """One `rob_enhance_finetune.run(argv)` with the counts set to 0 before
    it and read after it; -> (result, forward launches by shape).  Every
    step must launch the forward STAGE3_PER_STEP times, at its
    resolution's shapes."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import rob_enhance_finetune as s3
    args = s3.build_argparser().parse_args(argv)
    torch.cuda.synchronize()
    reset_counts()                              # counts start here
    res = s3.run(args)
    torch.cuda.synchronize()
    got, by_shape = counts(), dict(fa.launches.by_shape)
    want_shapes = {}
    for r in res["resolutions"]:
        for _, h, tq, tk, d, _, per in stage3_shapes(r):
            want_shapes[(h, tq, tk, d)] = want_shapes.get((h, tq, tk, d),
                                                          0) + per
    hist = res["history"]
    print(f"[18] stage 3 {tag}: steps {res['start_step'] + 1}-"
          f"{res['start_step'] + len(hist)} at "
          + ", ".join(f"{r}^2 {t:.4f} s" for r, t in
                      zip(res["resolutions"], res["seconds"]))
          + "; loss " + ", ".join(f"{h['loss']:.6e}" for h in hist)
          + f"; launches {got} | {smi}", flush=True)
    if not (got == {"fwd": STAGE3_PER_STEP * n_steps, **NO_TRAINING}
            and len(hist) == n_steps and by_shape == want_shapes
            and all(math.isfinite(h["loss"]) and h["loss"] > 0
                    for h in hist)):
        raise AssertionError(f"stage 3 {tag}: launches {got}, by shape "
                             f"{by_shape} (want {want_shapes}), history "
                             f"{hist}")
    return res, by_shape


def phase18c(smi: str, tmp: str, s1_file: str, ppft_dir: str,
             image: torch.Tensor) -> tuple:
    """Stage 3 at full width through `rob_enhance_finetune.run`, chained
    after phase 15: 4 steps, resumed from the latest checkpoint to 6, and
    an uninterrupted 6-step run to hold the resumed steps against; the
    msgdecoder.pt read back by the auditor's loader; the bits of phase
    15's image.  cuDNN's deterministic algorithms are on for the runs, so
    that equal draws give equal bits.  Returns the forward launches by
    shape of the 4 + 2 steps and the uninterrupted run's trainer."""
    from aqualora_torch.eval.utils_eval import decode_bits, load_msgdecoder
    from aqualora_torch.train.ppft_train import MSGDECODER_FILE

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = str(Path(tmp) / "stage3")
        first, launched = run_stage3(
            f"512^2-768^2 B{STAGE3_BATCH} bf16 rank 320",
            stage3_argv(s1_file, ppft_dir, out, STAGE3_FIRST), STAGE3_FIRST,
            smi)
        del first
        torch.cuda.empty_cache()
        resumed, more = run_stage3(
            "resumed from the latest checkpoint",
            stage3_argv(s1_file, ppft_dir, out, STAGE3_STEPS,
                        "--resume_from_checkpoint", "latest"),
            STAGE3_STEPS - STAGE3_FIRST, smi)
        for key, n in more.items():
            launched[key] = launched.get(key, 0) + n
        dec = {k: v.detach().clone() for k, v in
               resumed["decoder"].state_dict().items()}
        hist = resumed["history"]
        del resumed
        torch.cuda.empty_cache()
        straight, _ = run_stage3(
            "uninterrupted", stage3_argv(s1_file, ppft_dir,
                                         str(Path(tmp) / "stage3_straight"),
                                         STAGE3_STEPS), STAGE3_STEPS, smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    tr = straight["trainer"]
    same_steps = (hist == straight["history"][STAGE3_FIRST:]
                  and all(torch.equal(dec[k], v) for k, v in
                          tr.decoder.state_dict().items()))
    start = torch.load(s1_file, map_location="cuda",
                       weights_only=True)["sec_decoder"]
    moved = {k: not torch.equal(dec[k], start[k].to(dec[k].dtype))
             for k in dec}
    n_params = len(dict(tr.decoder.named_parameters()))
    loaded = load_msgdecoder(str(Path(out) / MSGDECODER_FILE), 48,
                             device="cuda")
    read_back = all(torch.equal(loaded.state_dict()[k], v)
                    for k, v in dec.items())
    bits, margins = decode_bits(loaded, image)
    print(f"[18] resumed steps {STAGE3_FIRST + 1}-{STAGE3_STEPS} equal the "
          f"uninterrupted run's bit for bit (metrics and the decoder): "
          f"{same_steps}; {sum(moved.values())} of {len(moved)} decoder "
          f"tensors moved from stage 1's ({n_params} parameters, the rest "
          f"BatchNorm statistics); {MSGDECODER_FILE} read by "
          f"load_msgdecoder equals the trained decoder bit for bit: "
          f"{read_back}; phase 15's image decodes to "
          f"{''.join(map(str, bits[0].tolist()))} (random weights: "
          f"printed)", flush=True)
    if not (same_steps and all(moved.values()) and read_back
            and torch.isfinite(margins).all()):
        raise AssertionError("stage 3's resume, training or read-back "
                             "failed a check")
    return launched, tr


def time_stage3(tag: str, tr, res: int, n: int, smi: str) -> float:
    """n steps at res^2 through the step functions `run` uses (the first a
    warm-up); prints steps/s, the generation's and the decoder step's
    shares and the peak memory; returns the median step in seconds."""
    from aqualora_torch.train import rob_enhance_finetune as s3
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps, gens, decs = [], [], []
    for i in range(n):
        _, captions = next(tr.batches)
        d = s3.draw(tr.pipe, tr.decoder, tr.noiser, tr.generator,
                    tr.batch_size, res)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = s3.generate_images(tr, res, captions, d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = tr.decoder_step(images, d.msg, d.noise, d.masks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = {k: v - before[k] for k, v in counts().items()}
        if got != {"fwd": STAGE3_PER_STEP, **NO_TRAINING} or not \
                math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"stage-3 step at {res}^2: launches {got}")
        if i:
            steps.append(t2 - t0)
            gens.append(t1 - t0)
            decs.append(t2 - t1)
    med = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated()
    print(f"[18] stage-3 step {tag} {res}^2 B{tr.batch_size}: "
          f"{1 / med:.4f} steps/s, {tr.batch_size / med:.4f} samples/s "
          f"(median of {len(steps)}: {', '.join(f'{x:.4f}' for x in steps)} "
          f"s); generation {statistics.median(gens):.4f} s "
          f"({100 * sum(gens) / sum(steps):.1f}%), decoder step "
          f"{statistics.median(decs):.4f} s "
          f"({100 * sum(decs) / sum(steps):.1f}%); {STAGE3_PER_STEP} forward "
          f"launches a step; peak memory {peak / 2 ** 30:.2f} GiB "
          f"({(peak - base) / 2 ** 30:.2f} above the "
          f"{base / 2 ** 30:.2f} resident) | {smi}", flush=True)
    return med


def phase18d(smi: str, tr, s1_file: str, ppft_dir: str, tmp: str) -> list:
    """Timed stage-3 steps at fixed resolutions: bf16 at 512^2 and 768^2,
    then float32 (the JAX CLI's default precision) at 512^2, warm-up and
    one timed.  Returns what the profiled steps need."""
    from aqualora_torch.train import rob_enhance_finetune as s3
    kept = [("bf16", tr, res, time_stage3("bf16", tr, res, STAGE3_TIMED,
                                           smi)) for res in (512, 768)]
    f32 = s3.build_trainer(s3.build_argparser().parse_args(
        stage3_argv(s1_file, ppft_dir, str(Path(tmp) / "stage3_f32"), 1,
                    "--mixed_precision", "no")))
    kept.append(("f32", f32, 512, time_stage3("f32", f32, 512, 2, smi)))
    return kept


def phase18_profile(smi: str, kept: list) -> None:
    """One more stage-3 step of each timed kind under torch.profiler: the
    busy share (`kernel_union_ms`) of its own wall time, the forward
    kernel's share of the summed kernel time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import rob_enhance_finetune as s3
    for tag, tr, res, med in kept:
        _, captions = next(tr.batches)
        d = s3.draw(tr.pipe, tr.decoder, tr.noiser, tr.generator,
                    tr.batch_size, res)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s3.train_step(tr, res, captions, d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if is_kernel(e)
                  and e.self_device_time_total > 0]
        if not events:
            print(f"[18] {tag} {res}^2 device time by kernel: not measured "
                  f"(the profiler saw no CUDA kernel)", flush=True)
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        fwd_ms = sum(e.self_device_time_total for e in events
                     if "flash_fwd" in e.key) / 1e3
        union_ms = kernel_union_ms(prof)
        print(f"[18] profiled stage-3 step {tag} {res}^2 "
              f"({tr.noiser.names[d.noise.index]}): device busy "
              f"{union_ms:.1f} ms = {100 * union_ms / wall_ms:.1f}% of its "
              f"own {wall_ms:.1f} ms wall time (the timed median "
              f"{med * 1e3:.1f} ms); kernel time summed {busy_ms:.1f} ms, "
              f"the forward kernel {fwd_ms:.1f} ms "
              f"({100 * fwd_ms / busy_ms:.1f}%) | {smi}", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[18]   {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<5d} {e.key[:100]}", flush=True)


# phase 19, the robustness benchmark: run_eval_distortion at the protocol's
# settings (dpms_m 25, CFG 7.5, 512^2, bf16, batch 4) on phase 15's
# artifacts, 8 prompts, the seven distortions and both SDEdit attacks
DIST_PROMPTS = 8
DIST_KINDS = ("color_jitter", "crop", "blur", "noise", "jpeg_compress",
              "rotation", "sharpness", "SDEdit", "SDEdit2")
# forward launches of one img2img call of 10 steps: the VAE encoder's and
# the decoder's mid-block, and 32 a U-Net evaluation for each of its
# max(1, int(10 * strength)) steps (strength 0.1 for SDEdit, 0.2 for
# SDEdit2, whose SD-2.1 U-Net has SD-1.5's 16 transformer blocks)
SDEDIT_LAUNCHES = {0.1: 1 + 32 + 1, 0.2: 1 + 2 * 32 + 1}
JPEG_QUALITY = 50
TINY_IMG2IMG = ((10, 0.1), (10, 0.2), (4, 0.5))


def sdedit2_shapes():
    """SD-2.1's d = 64 shapes at the batch of an SDEdit2 call (4 images:
    2 x 4 under CFG): (key, name, heads, Tq, Tk, d, batch)."""
    b = 2 * PROTOCOL_IMAGES
    return [(f"sdedit2_b{b}/{name}", name, h, tq, tk, d, b)
            for name, h, tq, tk, d, _ in SD21_SHAPES]


def phase19a(smi: str) -> dict:
    """SD-2.1's d = 64 shapes at B8, the batch the SDEdit2 calls launch
    (phase 2 holds them at B16 and batch 2; the tiling depends on the
    batch), as phase 2 holds the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    return {key: check_serving_shape(key, h, tq, tk, d, b, gen, smi,
                                     at_b2=False, phase=19)
            for key, _, h, tq, tk, d, b in sdedit2_shapes()}


def phase19b() -> None:
    """The tiny img2img slice on the card (kernels) against the CPU (plain
    versions), float32, the same weights and draws: epsilon and
    v-prediction, strength 0.1 and 0.2 of 10 steps and 0.5 of 4."""
    import dataclasses

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(19)
    images = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    draws = {k: torch.randn(2, 16, 16, 4, generator=gen)
             for k in ("posterior_noise", "noise")}
    for pred in ("epsilon", "v_prediction"):
        cfg = PipelineConfig.tiny()
        cfg = dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, prediction_type=pred),
            schedule=dataclasses.replace(cfg.schedule, prediction_type=pred))
        pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                              device=dev)
                 for dev in ("cpu", "cuda")}
        pipes["cpu"].init_params(seed=19)
        pipes["cuda"].load_state_from(pipes["cpu"])
        tok = load_tokenizer(None, vocab_size=cfg.clip.vocab_size)
        ids, neg = tok(["masterpiece"] * 2), tok([""] * 2)
        for steps, strength in TINY_IMG2IMG:
            fa.launches.reset()
            out = {dev: pipe.make_img2img(steps, strength, 32, 32)(
                images, ids, neg, 7.5, **draws).cpu()
                for dev, pipe in pipes.items()}
            err = (out["cuda"] - out["cpu"]).abs().max().item()
            moved = (out["cpu"] - images).abs().max().item()
            print(f"[19] tiny img2img {pred} strength {strength} of {steps} "
                  f"steps, card vs CPU: max|d image| {err:.3e} (tol "
                  f"{TINY_IMAGE_TOL:g}), the attack moved the image by "
                  f"{moved:.3f}, kernel launches {fa.launches.count}",
                  flush=True)
            if not (err <= TINY_IMAGE_TOL and fa.launches.count > 0
                    and moved > 0.05):
                raise AssertionError("tiny img2img on the card disagrees "
                                     "with the CPU")


def jpeg_batch(n: int = N_IMG, res: int = RES) -> torch.Tensor:
    """[n, res, res, 3] uint8 on the CPU: half uniform noise, half smooth
    gradients with a little noise (the two ends of what the coder meets)."""
    gen = torch.Generator().manual_seed(19)
    noise = torch.randint(0, 256, (n // 2, res, res, 3), generator=gen,
                          dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(float(res)), torch.arange(float(res)),
                            indexing="ij")
    smooth = torch.stack([(torch.sin(yy / 37 + c) * 0.5 + 0.5) * xx * 0.4
                          for c in range(3)], -1)
    smooth = smooth + torch.rand((n - n // 2, res, res, 3), generator=gen) * 8
    return torch.cat([noise, smooth.clamp(0, 255).to(torch.uint8)])


def phase19c(smi: str) -> dict:
    """The JPEG round trip (eval/jpeg.py, integer torch ops) at B8 512^2 on
    the card against the same round trip on the CPU, bit for bit, then
    against Pillow's where this machine has Pillow (printed only: the port
    never calls it); its time on the card and on the CPU."""
    from aqualora_torch.eval.jpeg import jpeg_roundtrip
    images = jpeg_batch()
    card = jpeg_roundtrip(images.cuda(), JPEG_QUALITY)
    t0 = time.perf_counter()
    cpu = jpeg_roundtrip(images, JPEG_QUALITY)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(card.cpu(), cpu)
    dev = images.cuda()
    card_ms = time_ms(lambda: jpeg_roundtrip(dev, JPEG_QUALITY), iters=5)
    try:
        import io

        import numpy as np
        from PIL import Image
    except ImportError:
        pil = "no Pillow on this machine"
    else:
        ref = []
        for img in images.numpy():
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=JPEG_QUALITY)
            buf.seek(0)
            with Image.open(buf) as im:
                ref.append(np.asarray(im.convert("RGB")))
        pil = ("equal to Pillow's bit for bit"
               if np.array_equal(np.stack(ref), cpu.numpy())
               else "differs from Pillow's")
    lossy = (card.cpu().int() - images.int()).abs().float().mean().item()
    print(f"[19] JPEG quality {JPEG_QUALITY} round trip B{N_IMG} {RES}^2: "
          f"card equals CPU bit for bit: {same}; {pil}; mean |d| "
          f"{lossy:.3f} levels from the input; {card_ms:.4f} ms on the card "
          f"(mean of 5), {cpu_ms:.1f} ms on the CPU | {smi}", flush=True)
    if not same:
        raise AssertionError("the JPEG round trip differs between the card "
                             "and the CPU")
    return {"ms": card_ms, "cpu_ms": cpu_ms}


class DistParts:
    """Times the robustness runner's parts by wrapping what it calls (each
    wrapper synchronizes the card before it stops its clock), counts the
    forward launches of each generate and img2img call, and checks every
    distorted batch is finite.  `install()` / `remove()`."""

    def __init__(self):
        from aqualora_torch.diffusion import pipeline as pl
        from aqualora_torch.eval import distortions as dist
        from aqualora_torch.eval import utils_eval as ue
        self.targets = [(ue, "simple_sample"), (ue, "simple_decode"),
                        (dist, "distortion_unit"),
                        (pl.StableDiffusionPipeline, "make_generate"),
                        (pl.StableDiffusionPipeline, "make_img2img")]
        self.saved = {}
        self.sample_s, self.generate, self.img2img = 0.0, [], []
        self.distort, self.decode = {}, []

    def _calls(self, record, make):
        """Wrap a pipeline's make_* so each call of what it returns is
        timed and its launches counted into `record`."""
        def wrapped_make(pipe, *a, **k):
            fn = make(pipe, *a, **k)
            tag = k.get("strength")

            def counted(*ca, **ck):
                torch.cuda.synchronize()
                before, t0 = counts(), time.perf_counter()
                out = fn(*ca, **ck)
                torch.cuda.synchronize()
                after = counts()
                record.append((tag, time.perf_counter() - t0,
                               {c: after[c] - before[c] for c in after}))
                return out
            return counted
        return wrapped_make

    def install(self):
        self.saved = {(o, n): getattr(o, n) for o, n in self.targets}
        (ue, _), _, (dist, _), (pl_cls, _), _ = self.targets
        sample = self.saved[(ue, "simple_sample")]
        decode = self.saved[(ue, "simple_decode")]
        unit = self.saved[(dist, "distortion_unit")]

        def timed_sample(*a, **k):
            t0 = time.perf_counter()
            out = sample(*a, **k)
            torch.cuda.synchronize()
            self.sample_s += time.perf_counter() - t0
            return out

        def timed_unit(x01, kind, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = unit(x01, kind, *a, **k)
            torch.cuda.synchronize()
            self.distort[kind] = (time.perf_counter() - t0,
                                  bool(torch.isfinite(out).all()),
                                  tuple(out.shape))
            return out

        def timed_decode(*a, **k):
            t0 = time.perf_counter()
            out = decode(*a, **k)
            torch.cuda.synchronize()
            self.decode.append(time.perf_counter() - t0)
            return out

        ue.simple_sample, ue.simple_decode = timed_sample, timed_decode
        dist.distortion_unit = timed_unit
        pl_cls.make_generate = self._calls(
            self.generate, self.saved[(pl_cls, "make_generate")])
        pl_cls.make_img2img = self._calls(
            self.img2img, self.saved[(pl_cls, "make_img2img")])

    def remove(self):
        for (obj, name), fn in self.saved.items():
            setattr(obj, name, fn)


def phase19d(smi: str, out_dir: str, tmp: str) -> dict:
    """The robustness benchmark at full width on phase 15's artifacts,
    through `run_eval_distortion.main`: the clean set (8 prompts, 512^2,
    dpms_m 25, CFG 7.5, bf16, B4), the seven distortions, SDEdit (SD-1.5,
    strength 0.1) and SDEdit2 (SD-2.1, strength 0.2), PNGs, decode.  The
    counts are set to 0 before it and read after it.  Returns the forward
    launches by shape."""
    from aqualora_torch.eval import run_eval_distortion
    from aqualora_torch.eval.image_io import load_png
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train.ppft_train import MSGDECODER_FILE

    out = Path(tmp) / "eval_distortion"
    argv = ["--train_folder", out_dir, "--msgdecoder_path",
            str(Path(out_dir) / MSGDECODER_FILE), "--num_prompts",
            str(DIST_PROMPTS), "--batch_size", str(PROTOCOL_IMAGES),
            "--sampler", "dpms_m", "--steps", str(STEPS), "--cfg", "7.5",
            "--resolution", str(RES), "--msg_bits", str(EVAL_MSG_BITS),
            "--with_sdedit", "--with_sdedit2", "--device", "cuda",
            "--output_dir", str(out)]
    parts = DistParts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    parts.install()
    try:
        torch.cuda.synchronize()
        reset_counts()                          # counts start here
        t0 = time.perf_counter()
        results = run_eval_distortion.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_shape = counts(), dict(fa.launches.by_shape)
    finally:
        parts.remove()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    n_gen = DIST_PROMPTS // PROTOCOL_IMAGES
    want_gen = {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}
    want_total = {"fwd": n_gen * LAUNCHES_PER_GENERATE + n_gen * sum(
        SDEDIT_LAUNCHES.values()), **NO_TRAINING}
    gen_s = [s for _, s, _ in parts.generate]
    print(f"[19] run_eval_distortion: {DIST_PROMPTS} clean images at 512^2 "
          f"dpms_m-{STEPS} CFG 7.5 bf16 B{PROTOCOL_IMAGES}, "
          f"{len(DIST_KINDS)} kinds, {DIST_PROMPTS * len(DIST_KINDS)} "
          f"distorted images written and decoded in {wall:.4f} s = "
          f"{DIST_PROMPTS * len(DIST_KINDS) / wall:.4f} images/s end to end; "
          f"clean set {parts.sample_s:.4f} s (generate calls "
          + ", ".join(f"{s:.4f}" for s in gen_s)
          + f" s); peak memory {peak_gib:.2f} GiB above the "
          f"{base / 2 ** 30:.2f} GiB resident; launches {got} | {smi}",
          flush=True)
    for (kind, (sec, finite, shape)), dec_s in zip(parts.distort.items(),
                                                   parts.decode):
        acc, tpr = results[kind]
        calls = [f"{s:.4f} s, {c['fwd']} launches" for tag, s, c in
                 parts.img2img if (tag == 0.1) == (kind == "SDEdit")]
        print(f"[19] {kind}: distortion {sec:.4f} s"
              + (f" (img2img calls: {'; '.join(calls)})"
                 if kind.startswith("SDEdit") else "")
              + f", decode {dec_s:.4f} s; output {shape}, finite {finite}; "
              f"bit_accuracy {acc:.4f} TPR {tpr:.4f} (random weights: "
              f"printed, not checked) | {smi}", flush=True)
    pngs = {k: sorted(p.name for p in (out / k).glob("*.png"))
            for k in ("clean",) + DIST_KINDS}
    sides = {k: {load_png(str(out / k / n)).shape[:2] for n in names}
             for k, names in pngs.items()}
    want_sides = {k: {(460, 460) if k == "crop" else (RES, RES)}
                  for k in pngs}
    want_img2img = sorted(SDEDIT_LAUNCHES[t] for t in SDEDIT_LAUNCHES
                          for _ in range(n_gen))
    ok = (got == want_total and len(gen_s) == n_gen
          and all(c == want_gen for _, _, c in parts.generate)
          and sorted(c["fwd"] for _, _, c in parts.img2img) == want_img2img
          and all(SDEDIT_LAUNCHES[t] == c["fwd"] for t, _, c in
                  parts.img2img)
          and list(results) == list(DIST_KINDS)
          and tuple(parts.distort) == DIST_KINDS
          and all(f for _, f, _ in parts.distort.values())
          and all(len(v) == DIST_PROMPTS for v in pngs.values())
          and len({tuple(v) for v in pngs.values()}) == 1
          and sides == want_sides
          and all(0.0 <= a <= 1.0 and 0.0 <= t <= 1.0
                  for a, t in results.values()))
    print(f"[19] launches per generate call "
          f"{[c for _, _, c in parts.generate]}, per img2img call "
          f"{[(t, c['fwd']) for t, _, c in parts.img2img]}"
          f" (want {want_gen['fwd']}, SDEdit {SDEDIT_LAUNCHES[0.1]}, SDEdit2 "
          f"{SDEDIT_LAUNCHES[0.2]}); {DIST_PROMPTS} PNGs in each of "
          f"{len(pngs)} directories: "
          f"{all(len(v) == DIST_PROMPTS for v in pngs.values())}", flush=True)
    if not ok:
        raise AssertionError(f"the robustness benchmark failed a check: "
                             f"launches {got} (want {want_total}), "
                             f"generate {parts.generate}, img2img "
                             f"{parts.img2img}, distortions {parts.distort}, "
                             f"PNGs {pngs}, results {results}")
    return by_shape


# float32 stage 3 at 512^2 (phase 18d's float32 step): the CUDA-core forward
# at d <= 160, B8 under CFG, 20 steps a generation
def f32_stage3_shapes():
    return [s for s in stage3_shapes(512) if s[4] <= 160]


def phase19e(smi: str) -> dict:
    """The float32 forward at d <= 160 (the CUDA-core instances) at stage
    3's 512^2 shapes, B8: against the plain version, kernel_ms and the
    plain version's (host-timed), SDPA's float32 time, the bound at the
    CUDA cores' float32 rate and HBM3's bandwidth."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(190)
    rows = {}
    for key, h, tq, tk, d, b, per in f32_stage3_shapes():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for t in (tq, tk, tk))
        err = check_fwd(f"[19] {key} float32", q, k, v, scale,
                        plain=plain_by_batch)
        kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        plain_ms = time_ms(lambda: plain_by_batch(q, k, v, scale), iters=3,
                           warmup=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d, elem_bytes=4,
                                             peak=PEAK_F32_FLOPS)
        print(f"[19] {key} B{b} float32 (CUDA cores), {per} launches a "
              f"stage-3 step: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms(sdpa float32) {library_ms:.4f} = "
              f"{kernel_ms / library_ms:.2f}x, bound_ms {bound_ms:.4f} "
              f"({bound_by}, float32 at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s) "
              f"| {smi}", flush=True)
        rows[key] = {"max_abs_err": err, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase19e_profile(smi: str, rows: dict) -> None:
    """The float32 d <= 160 forward and SDPA's float32 forward as device
    time (as phase 10), with the step's launches."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(191)
    step_kernel = step_sdpa = 0.0
    for key, h, tq, tk, d, b, per in f32_stage3_shapes():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for t in (tq, tk, tk))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        step_kernel += per * kernel_dev
        step_sdpa += per * library_dev
        print(f"[19] {key} B{b} float32: forward device time "
              f"{kernel_dev:.4f} ms, sdpa float32 forward {library_dev:.4f} "
              f"= {kernel_dev / library_dev:.2f}x, bound "
              f"{rows[key]['bound_ms']:.4f} ({rows[key]['bound_by']}), "
              f"{per} launches a step (kernel_ms {rows[key]['ms']:.4f}) "
              f"| {smi}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(f"[19] float32 stage-3 512^2 step, the d <= 160 forward launches: "
          f"{step_kernel:.1f} ms of device time, SDPA's float32 at the same "
          f"launches {step_sdpa:.1f} ms | {smi}", flush=True)


# ---------------------------------------------------------------------------
# phase 20, training on real images: the image-folder data path, the JPEG
# decoder written by hand, prefetch and --cache_latents
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_port_images"
FOLDER_FILES = 64
FOLDER_RES = 512
S3_FOLDER_BATCH = 4
P20_STEPS = 6                  # 1 warm-up + 5 timed, per PPFT run


def p20_decoder(smi: str, folder: str) -> None:
    """(a) The decoders on the host against the committed pixels, the plain
    version on the card, the refusals, and decode_batch's rate."""
    import numpy as np

    from aqualora_torch.eval import image_io
    from aqualora_torch.eval.jpeg import decode_from_coefficients
    from aqualora_torch.train import image_decode

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    pixels = np.load(FIXTURES / "pixels.npz")
    small = FIXTURES / "small"
    checked = {"pixels": 0, "plain": 0, "truncated": 0, "refused": 0}
    for name, meta in sorted(manifest["small"].items()):
        path = str(small / name)
        if meta["refused"]:
            try:
                image_decode.decode_file(path)
            except ValueError as e:
                if meta["refused"] not in str(e) or path not in str(e):
                    raise AssertionError(f"{name}: refused as {e}") from None
                checked["refused"] += 1
                continue
            raise AssertionError(f"{name}: decoded, want refused")
        got = image_decode.decode_file(path)
        if not np.array_equal(got, pixels[name.split(".")[0]]):
            raise AssertionError(f"{name}: pixels differ from the committed "
                                 "reference")
        checked["pixels"] += 1
        data = Path(path).read_bytes()
        if name.endswith(".jpg"):
            head, quant, blocks = image_decode.jpeg_coefficients(data, path)
            plain = decode_from_coefficients(
                [torch.from_numpy(b).cuda() for b in blocks],
                torch.from_numpy(quant).cuda(),
                [c[:2] for c in head.components], (head.width, head.height),
                head.color)
            if not (plain.is_cuda and np.array_equal(plain.cpu().numpy(),
                                                     got)):
                raise AssertionError(f"{name}: the plain version on the card "
                                     "differs from the decoder")
            checked["plain"] += 1
        cut = Path(folder) / ("cut_" + name)
        cut.write_bytes(data[:len(data) // 2])
        try:
            image_decode.decode_file(str(cut))
        except ValueError:
            checked["truncated"] += 1
        else:
            raise AssertionError(f"{name}: a truncated copy decoded")
        cut.unlink()
    for row in manifest["realistic"]:
        img = image_decode.decode_file(str(FIXTURES / "realistic" /
                                           row["file"]))
        if (img.shape != (row["height"], row["width"], 3) or
                hashlib.sha256(img.tobytes()).hexdigest()
                != row["pixels_sha256"]):
            raise AssertionError(f"{row['file']}: pixels differ from "
                                 "Pillow's")
        checked["pixels"] += 1
    print(f"[20] decoder on the host: {checked['pixels']} files equal their "
          f"committed pixels (Pillow's JPEG, libpng's PNG; 8 realistic ones "
          f"by SHA-256), {checked['plain']} JPEG files equal "
          f"decode_from_coefficients on the card fed the decoder's "
          f"coefficients, {checked['truncated']} truncated copies raised, "
          f"{checked['refused']} refused kinds named their feature",
          flush=True)

    paths = sorted(str(p) for p in Path(folder).glob("img*.jpg"))
    cpus = os.cpu_count()
    usable = len(os.sched_getaffinity(0))
    rates = {}
    image_decode.decode_batch(paths[:8], FOLDER_RES)          # warm
    for threads in (0, 1):
        ts = []
        for _ in range(3 if threads == 0 else 2):
            t0 = time.perf_counter()
            out = image_decode.decode_batch(paths, FOLDER_RES, threads)
            ts.append(time.perf_counter() - t0)
        if not (out.shape == (len(paths), FOLDER_RES, FOLDER_RES, 3)
                and np.isfinite(out).all() and out.min() >= -1
                and out.max() <= 1):
            raise AssertionError("decode_batch output out of range")
        rates[threads] = len(paths) / statistics.median(ts)
    kpx = statistics.mean(r["height"] * r["width"] for r in
                          manifest["realistic"]) / 1e3
    print(f"[20] decode_batch JPEG -> {FOLDER_RES}^2 float32, {len(paths)} "
          f"files of 512x512-1024x768 (mean {kpx:.0f} kpx, "
          f"{sum(os.path.getsize(p) for p in paths) / len(paths) / 1e3:.1f} "
          f"kB): {rates[0]:.1f} images/s with the host's threads, "
          f"{rates[1]:.1f} with one; host: {cpus} CPUs, {usable} usable",
          flush=True)
    # PNG: the same images written by the port's writer (filter None on
    # every row, the vectorised path), then rows of Paeth (byte by byte)
    pngs = []
    for i, row in enumerate(manifest["realistic"]):
        img = image_decode.decode_file(str(FIXTURES / "realistic" /
                                           row["file"]))
        pngs.append(str(Path(folder) / f"p{i}.png"))
        image_io.save_png(pngs[-1], img)
    t0 = time.perf_counter()
    image_decode.decode_batch(pngs, FOLDER_RES)
    png_rate = len(pngs) / (time.perf_counter() - t0)
    h, w = 768, 1024
    rows = np.random.default_rng(0).integers(0, 256, (h, 3 * w),
                                             dtype=np.uint8)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), rows], 1).tobytes()
    image_io._unfilter(raw[:3 * w + 1], 1, 3 * w, 3)    # built, bound
    paeth = {}
    for kind, fn in (("C++", image_io._unfilter),
                     ("Python", image_io._unfilter_plain)):
        t0 = time.perf_counter()
        paeth[kind] = (fn(raw, h, 3 * w, 3), time.perf_counter() - t0)
    same = np.array_equal(paeth["C++"][0], paeth["Python"][0])
    print(f"[20] decode_batch PNG -> {FOLDER_RES}^2 (zlib, the row filters "
          f"in C++, one thread): {png_rate:.2f} images/s for rows of "
          f"filter None; a {w}x{h} RGB image whose rows are all Paeth "
          f"spends {paeth['C++'][1]:.4f} s unfiltering in C++ "
          f"(png_unfilter.cpp), {paeth['Python'][1]:.4f} s in the Python "
          f"rows (its plain version); the same bytes: {same} | {smi}",
          flush=True)
    if not same:
        raise AssertionError("png_unfilter disagrees with the Python rows")


def p20_folder(tmp: str) -> tuple:
    """The realistic set under 64 names with metadata.jsonl captions."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    folder = Path(tmp) / "images"
    folder.mkdir()
    captions = []
    with open(folder / "metadata.jsonl", "w") as f:
        for i in range(FOLDER_FILES):
            row = manifest["realistic"][i % len(manifest["realistic"])]
            name = f"img{i:02d}.jpg"
            shutil.copy(FIXTURES / "realistic" / row["file"], folder / name)
            captions.append(f"{row['caption']}, take {i}")
            f.write(json.dumps({"file_name": name,
                                "text": captions[-1]}) + "\n")
    return str(folder), captions


def p20_ppft(tag: str, argv: list, per_step: dict, smi: str) -> tuple:
    """`ppft_train.run(argv)` with the counts set to 0 before it; every
    train step's launches read around it (the step function `run` builds,
    wrapped), and the cache's build time, bytes and launches.  -> (samples
    per second of the timed steps' median wall time, that median)."""
    from aqualora_torch.train import ppft_train as pt
    steps, cache = [], {}
    make_step, build_cache = pt.make_train_step, pt.build_latent_cache

    def counted_step(*a, **k):
        step = make_step(*a, **k)

        def run_step(*sa):
            before = counts()
            out = step(*sa)
            steps.append({n: v - before[n] for n, v in counts().items()})
            return out
        return run_step

    def timed_cache(*a):
        before = counts()
        t0 = time.perf_counter()
        ds = build_cache(*a)
        torch.cuda.synchronize()
        cache.update(seconds=time.perf_counter() - t0,
                     bytes=ds.moments.nbytes, samples=len(ds),
                     shape=ds.moments.shape,
                     launches={n: v - before[n] for n, v in counts().items()})
        return ds

    pt.make_train_step, pt.build_latent_cache = counted_step, timed_cache
    try:
        args = pt.build_argparser().parse_args(argv)
        torch.cuda.synchronize()
        reset_counts()                              # counts start here
        res = pt.run(args)
        torch.cuda.synchronize()
    finally:
        pt.make_train_step, pt.build_latent_cache = make_step, build_cache
    losses = [h["ppft_loss"] for h in res["history"]]
    med = statistics.median(res["seconds"][1:])
    rate = TRAIN_BATCH / med
    print(f"[20] PPFT {tag}: {rate:.4f} samples/s (median of "
          f"{len(res['seconds']) - 1} steps after a warm-up, wall time "
          f"{', '.join(f'{x:.4f}' for x in res['seconds'])} s, the batch's "
          f"wait included), ppft_loss {', '.join(f'{x:.4e}' for x in losses)}"
          f", launches a step {steps[-1]} | {smi}", flush=True)
    if cache:
        print(f"[20] latent cache: {cache['samples']} samples "
              f"{tuple(cache['shape'])} float16, {cache['bytes']} bytes "
              f"({cache['bytes'] / cache['samples'] / 1024:.1f} KiB a sample)"
              f" on the host, built in {cache['seconds']:.3f} s, launches "
              f"{cache['launches']}", flush=True)
        want_cache = {"fwd": FOLDER_FILES // TRAIN_BATCH, "dq": 0, "dkv": 0,
                      "inject": 0}
        if cache["launches"] != want_cache or cache["samples"] != FOLDER_FILES:
            raise AssertionError(f"cache build: {cache}")
    if len(steps) != P20_STEPS or any(s != per_step for s in steps):
        raise AssertionError(f"PPFT {tag}: launches {steps}, want "
                             f"{per_step} each of {P20_STEPS} steps")
    if not all(math.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"PPFT {tag}: loss not finite positive: "
                             f"{losses}")
    return rate, med


def ppft_folder_argv(folder: str | None, s1_file: str, *extra: str) -> list:
    """PPFT at full width from stage 1's file (a trained SecretEncoder, so
    the loss is not 0), from the folder or on synthetic images."""
    return (["--rank", "320", "--msg_bits", "48", "--resolution",
             str(FOLDER_RES), "--train_batch_size", str(TRAIN_BATCH),
             "--mixed_precision", "bf16", "--learning_rate", "1e-4",
             "--lr_warmup_steps", "0", "--max_train_steps", str(P20_STEPS),
             "--seed", "0", "--report_to", "none",
             "--start_from_pretrain", s1_file]
            + (["--train_data_dir", folder] if folder else []) + list(extra))


def phase20(smi: str, tmp: str, step_rate: float | None) -> tuple:
    """Training from a folder of JPEG files (see the docstring); returns
    what the profiled steps need: the folder, stage 1's file and the
    unprofiled median steps."""
    from aqualora_torch.train import latent_wm_pretrain as s1
    from aqualora_torch.train import rob_enhance_finetune as s3
    t_phase = time.perf_counter()
    folder, captions = p20_folder(tmp)
    p20_decoder(smi, folder)

    out = Path(tmp) / "s1"
    reset_counts()
    r1 = s1.run(s1.build_argparser().parse_args([
        "--batch_size", str(S1_BATCH), "--mixed_precision", "bf16",
        "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
        "--dataset", folder, "--output_dir", str(out)]))
    torch.cuda.synchronize()
    got1 = counts()
    want1 = {"fwd": 3 * CHAIN_STEPS + 4, "dq": CHAIN_STEPS,
             "dkv": CHAIN_STEPS, "inject": 0}
    losses1 = [h["loss"] for h in r1["history"]]
    print(f"[20] stage 1 from the folder (--dataset, B{S1_BATCH} 512^2 "
          f"bf16): step wall times "
          f"{', '.join(f'{x:.4f}' for x in r1['seconds'])} s, loss "
          f"{', '.join(f'{x:.6e}' for x in losses1)}, launches {got1}",
          flush=True)
    if got1 != want1 or not all(math.isfinite(x) for x in losses1):
        raise AssertionError(f"stage 1 from the folder: launches {got1} "
                             f"(want {want1}), losses {losses1}")
    del r1
    s1_file = str(out / "pretrained_latentwm.pt")

    per_step = {"fwd": FWD_PER_STEP, "dq": BWD_PER_STEP, "dkv": BWD_PER_STEP,
                "inject": 1}
    rates, meds = {"folder": [], "synthetic": []}, {}
    # in turns, so that neither kind gets the process's first or last run
    for kind in ("folder", "synthetic", "synthetic", "folder"):
        rate, med = p20_ppft(
            f"{kind} (B8 512^2 bf16 rank 320, from stage 1's file)",
            ppft_folder_argv(folder if kind == "folder" else None, s1_file),
            per_step, smi)
        rates[kind].append(rate)
        meds.setdefault(kind, med)
    two, _ = p20_ppft("folder, 2 decoder threads (--dataloader_num_workers "
                      "2)", ppft_folder_argv(folder, s1_file,
                                             "--dataloader_num_workers", "2"),
                      per_step, smi)
    cached = dict(per_step, fwd=FWD_PER_STEP - 1)
    cache_rate, _ = p20_ppft("folder with --cache_latents",
                             ppft_folder_argv(folder, s1_file,
                                              "--cache_latents"),
                             cached, smi)
    torch.cuda.empty_cache()
    f_rate = statistics.mean(rates["folder"])
    s_rate = statistics.mean(rates["synthetic"])
    print(f"[20] PPFT samples/s (each run the median of 5 steps, the "
          f"batch's wait included): folder "
          f"{', '.join(f'{x:.4f}' for x in rates['folder'])} (mean "
          f"{f_rate:.4f}), synthetic "
          f"{', '.join(f'{x:.4f}' for x in rates['synthetic'])} (mean "
          f"{s_rate:.4f}); folder / synthetic {f_rate / s_rate:.4f}; folder "
          f"on 2 decoder threads {two:.4f}; cached latents {cache_rate:.4f} "
          f"({cache_rate / TRAIN_BATCH:.4f} steps/s, "
          f"{cache_rate / f_rate:.4f}x the folder's); phase 8's train step "
          f"alone on synthetic images "
          + (f"{step_rate:.4f}" if step_rate else "not run")
          + f" | {smi}", flush=True)

    prompts = []
    generate = s3.generate_images

    def recorded(tr, res, caps, d):
        prompts.append(list(caps))
        return generate(tr, res, caps, d)

    s3.generate_images = recorded
    try:
        reset_counts()
        r3 = s3.run(s3.build_argparser().parse_args([
            "--rank", "320", "--msg_bits", "48", "--resolution", "512",
            "--train_batch_size", str(S3_FOLDER_BATCH), "--mixed_precision",
            "bf16", "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
            "--train_data_dir", folder, "--output_dir", str(Path(tmp) / "s3"),
            "--report_to", "none"]))
        torch.cuda.synchronize()
    finally:
        s3.generate_images = generate
    got3 = counts()
    losses3 = [h["loss"] for h in r3["history"]]
    print(f"[20] stage 3 from the folder (--train_data_dir, "
          f"B{S3_FOLDER_BATCH} bf16): "
          + ", ".join(f"{r}^2 {t:.4f} s" for r, t in
                      zip(r3["resolutions"], r3["seconds"]))
          + f", loss {', '.join(f'{x:.6e}' for x in losses3)}, launches "
          f"{got3}, prompts {prompts[0][:2]}...", flush=True)
    if not (got3 == {"fwd": STAGE3_PER_STEP * CHAIN_STEPS, **NO_TRAINING}
            and all(math.isfinite(x) for x in losses3)
            and len(prompts) == CHAIN_STEPS
            and all(len(p) == S3_FOLDER_BATCH and set(p) <= set(captions)
                    for p in prompts)):
        raise AssertionError(f"stage 3 from the folder: launches {got3}, "
                             f"losses {losses3}, prompts {prompts}")
    del r3
    torch.cuda.empty_cache()
    print(f"[20] phase 20 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return folder, s1_file, meds


def phase20_profile(smi: str, kept: tuple) -> None:
    """One profiled PPFT step from the folder and one on synthetic images,
    each after a warm-up step, each step as `run` takes it (the next
    batch from the prefetch thread, the tokenizer, the draws, the train
    step): the device's busy share of the step's own wall time and of the
    unprofiled median step of its kind."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import ppft_train as pt
    folder, s1_file, meds = kept
    shares = {}
    for tag, data in (("folder", folder), ("synthetic", None)):
        tr = pt.build_trainer(pt.build_argparser().parse_args(
            ppft_folder_argv(data, s1_file)))

        def step():
            pixels, caps = next(tr.batches)
            ids = tr.tokenizer(caps or [""] * len(pixels))
            tr.train_step(pixels, ids, pt.draw(tr.pipe, tr.generator,
                                               pixels, tr.cached))
            torch.cuda.synchronize()

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = kernel_union_ms(prof)
        shares[tag] = (busy / wall_ms, busy / (meds[tag] * 1e3))
        print(f"[20] profiled PPFT step ({tag}): device busy {busy:.1f} ms "
              f"= {100 * shares[tag][0]:.1f}% of its own {wall_ms:.1f} ms "
              f"wall time, {100 * shares[tag][1]:.1f}% of the unprofiled "
              f"median step ({meds[tag] * 1e3:.1f} ms) | {smi}", flush=True)
        tr.batches.close()
        del tr
        torch.cuda.empty_cache()
    print(f"[20] busy share, own wall / unprofiled median step: folder "
          f"{100 * shares['folder'][0]:.1f}% / "
          f"{100 * shares['folder'][1]:.1f}%, synthetic "
          f"{100 * shares['synthetic'][0]:.1f}% / "
          f"{100 * shares['synthetic'][1]:.1f}%", flush=True)



# ---------------------------------------------------------------------------
# phase 21: the trainers' remaining options at full width
# ---------------------------------------------------------------------------

P21_STEPS = 4                  # 1 warm-up + 3 timed
P21_DROPOUTS = ("--lora_dropout", "0.1", "--module_dropout", "0.1",
                "--rank_dropout", "0.1")
P21_S1_FILES = 5               # stage 1's resume folder: one B5 step an epoch
# 2 x B4 accumulated against one B8 step, in float32 (TF32 off): the same
# samples through other batch shapes sum in other orders, so the mean
# gradient is held to 1e-3 of its norm, and Adam's first step (lr * sign(g)
# where |g| >> eps) to 0.05 lr on 99.9% of the elements it moves (a
# gradient within rounding of 0 may take the other sign).  In bf16 the
# same comparison gave 3.1e-2 and 94.4% (NVIDIA H100 80GB HBM3, 700 W);
# `p21c_bf16` splits that gap into the accumulation's share (its mean
# against the mean of the two B4 gradients, held to the same 1e-3) and the
# batch shape's (the B4 mean against the B8 gradient, printed).
P21_ACC_GRAD_TOL = 1e-3
P21_ACC_AGREE = 0.999
# remat recomputes the student's 32 attention forwards in the backward
FWD_PER_STEP_REMAT = FWD_PER_STEP + BWD_PER_STEP                # 97


def p21_pretrain(tmp: str) -> str:
    """A stage-1 file of seeded random SecretEncoder and SecretDecoder
    weights at full width, so that the PPFT loss is not 0."""
    from aqualora_torch.core.config import EfficientNetConfig
    from aqualora_torch.diffusion.pipeline import init_module_weights
    from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
    gen = torch.Generator().manual_seed(21)
    enc = SecretEncoder(48, 32, 64, 4)
    dec = SecretDecoder(48, EfficientNetConfig.b1(), device="cpu")
    init_module_weights(enc, gen)
    init_module_weights(dec, gen)
    path = str(Path(tmp) / "s1_random.pt")
    torch.save({"sec_encoder": enc.state_dict(),
                "sec_decoder": dec.state_dict()}, path)
    return path


def p21_argv(s1_file: str, *extra: str, batch: int = TRAIN_BATCH) -> list:
    """PPFT at full width (SD-1.5, rank 320, 48 bits, 512^2, bf16, a
    constant learning rate, no validation unless asked)."""
    return ["--rank", "320", "--msg_bits", "48", "--resolution", "512",
            "--train_batch_size", str(batch), "--mixed_precision", "bf16",
            "--learning_rate", "1e-4", "--lr_warmup_steps", "0", "--seed",
            "0", "--report_to", "none", "--validation_epochs", "0",
            "--start_from_pretrain", s1_file, *extra]


def p21_trainer(s1_file: str, *extra: str, batch: int = TRAIN_BATCH):
    from aqualora_torch.train import ppft_train as pt
    return pt.build_trainer(pt.build_argparser().parse_args(
        p21_argv(s1_file, *extra, batch=batch)))


def p21_inputs(tr, pixels=None, captions=None, rank_dropout: float = 0.0):
    from aqualora_torch.train import ppft_train as pt
    if pixels is None:
        pixels, captions = next(tr.batches)
    return (pixels, tr.tokenizer(captions),
            pt.draw(tr.pipe, tr.generator, pixels, rank_dropout=rank_dropout))


def p21_steps(tr, n: int = P21_STEPS, inputs=None) -> tuple:
    """n train steps of `tr`, synchronised, counted -> (wall seconds of the
    steps after the first, each step's launches, the last metrics)."""
    times, launches, metrics = [], [], None
    for i in range(n):
        args = inputs() if inputs else p21_inputs(tr)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = tr.train_step(*args)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        launches.append({k: v - before[k] for k, v in counts().items()})
    loss = float(metrics["ppft_loss"])
    if not (math.isfinite(loss) and loss > 0):
        raise AssertionError(f"loss {loss} not finite positive")
    return times, launches, metrics


def p21_trainables(tr) -> dict:
    return {n: p for part in (tr.pipe.unet, tr.pipe.clip, tr.pipe.mapper)
            for n, p in part.named_parameters() if p.requires_grad}


def p21a(smi: str, s1_file: str, step_rate: float | None):
    """8-bit AdamW: state bytes, the optimizer's host time, samples/s; one
    update on the card and on the CPU from the same state and gradients
    gives the same codes and scales.  Returns the optimizer, with its last
    gradients, for `phase21_profile`."""
    from aqualora_torch.train.adamw8bit import AdamW8bit
    tr = p21_trainer(s1_file, "--use_8bit_adam")
    opt = tr.scheduler.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    f32_bytes = 2 * 4 * sum(p.numel() for p in params)
    times, launches, _ = p21_steps(tr)
    want = {"fwd": FWD_PER_STEP, "dq": BWD_PER_STEP, "dkv": BWD_PER_STEP,
            "inject": 1}
    if launches[-1] != want:
        raise AssertionError(f"8-bit AdamW step launches {launches[-1]}")
    med = statistics.median(times)
    # the update alone on the last step's gradients (the parameters move:
    # this trainer is dropped after)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    print(f"[21a] 8-bit AdamW over {sum(p.numel() for p in params)} "
          f"parameters ({len(params)} tensors, "
          f"{sum(len(opt.chunks(g)) for g in opt.param_groups)} chunks): "
          f"state {opt.state_bytes() / 2 ** 30:.4f} GiB (float32 moments "
          f"{f32_bytes / 2 ** 30:.4f} GiB); one update {1e3 * min(host):.2f} "
          f"ms host (min of 3); PPFT step with it {TRAIN_BATCH / med:.4f} samples/s (median "
          f"of {len(times)}: {', '.join(f'{x:.4f}' for x in times)} s), "
          f"phase 8's float32 AdamW "
          + (f"{step_rate:.4f}" if step_rate else "not run")
          + f" | {smi}", flush=True)
    # card against CPU: the same state and gradients, one update each
    cpu_params = [torch.nn.Parameter(p.detach().cpu()) for p in params]
    for p, c in zip(params, cpu_params):
        c.grad = p.grad.detach().cpu()
    groups, i = [], 0
    for g in opt.param_groups:
        n = len(g["params"])
        groups.append({**{k: v for k, v in g.items() if k != "params"},
                       "params": cpu_params[i:i + n]})
        i += n
    cpu_opt = AdamW8bit(groups)
    cpu_opt.load_state_dict(opt.state_dict())
    t0 = time.perf_counter()
    cpu_opt.step()
    cpu_s = time.perf_counter() - t0
    opt.step()
    torch.cuda.synchronize()
    states = list(zip(opt.state.values(), cpu_opt.state.values()))
    codes_equal = all(torch.equal(a[k].cpu(), b[k]) for a, b in states
                      for k in ("m_code", "m_scale", "v_code", "v_scale"))
    p_diff = max(float((p.detach().cpu() - c.detach()).abs().max())
                 for p, c in zip(params, cpu_params))
    print(f"[21a] one 8-bit update on the card and on the CPU ({cpu_s:.2f} "
          f"s there) from the same state and gradients: codes and scales of "
          f"{len(states)} chunks bit for bit {codes_equal}, parameters max "
          f"|d| {p_diff:.3e}", flush=True)
    if not codes_equal:
        raise AssertionError("8-bit codes or scales differ card vs CPU")
    tr.batches.close()
    return opt


def phase21_profile(smi: str, opt) -> None:
    """One 8-bit update under torch.profiler (with the whole-step
    profiles): its device time and kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if is_kernel(e) and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"[21a] one 8-bit update under torch.profiler: device "
          + (f"{dev_ms:.2f} ms in {sum(e.count for e in kern)} kernels"
             if kern else "not measured (no CUDA events)")
          + f" | {smi}", flush=True)


def p21_grads(tr, inputs, **loss_kw) -> tuple:
    """The loss and every trainable's gradient for fixed inputs."""
    from aqualora_torch.train import ppft_train as pt
    ps = list(p21_trainables(tr).items())
    for _, p in ps:
        p.grad = None
    loss, _ = pt.make_loss_fn(tr.pipe, tr.sec_encoder, **loss_kw)(*inputs)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in ps}


def p21_peak(tr, inputs) -> tuple:
    """The peak memory above the resident of one train step, and its wall
    seconds."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train_step(*inputs)
    torch.cuda.synchronize()
    return ((torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            time.perf_counter() - t0)


def p21b(smi: str, s1_file: str) -> None:
    """--gradient_checkpointing with the three dropouts: the same draws
    give the loss and gradients of the trainer without remat, 97 forward
    launches a step; peak memory and samples/s at B8 and B16."""
    plain = p21_trainer(s1_file, *P21_DROPOUTS)
    remat = p21_trainer(s1_file, *P21_DROPOUTS, "--gradient_checkpointing")
    pixels, captions = next(plain.batches)
    inputs = p21_inputs(plain, pixels, captions, rank_dropout=0.1)
    d = inputs[2]
    kw = {"rank_dropout": 0.1}
    la, ga = p21_grads(plain, inputs, **kw)
    lb, gb = p21_grads(remat, inputs, **kw)
    rel = abs(float(lb) - float(la)) / abs(float(la))
    worst, bitwise = 0.0, torch.equal(la, lb)
    for n, g in ga.items():
        m = float(g.float().abs().max())
        diff = float((gb[n].float() - g.float()).abs().max())
        bitwise = bitwise and diff == 0.0
        worst = max(worst, diff / (1e-4 * m + 1e-5 + 2.0 ** -7 * m))
    print(f"[21b] remat against no remat, one B8 step's draws with lora, "
          f"module and rank dropout 0.1 ({int((~d.unet_sites.keep).sum())} "
          f"of {d.unet_sites.keep.numel()} sites dropped): loss "
          f"{float(la):.6e} vs {float(lb):.6e} (rel {rel:.2e}, tol "
          f"{TINY_LOSS_RTOL:g}), gradients of {len(ga)} tensors within "
          f"{worst:.3f} of the bf16 tolerance (1e-4 max|g| + 1e-5 + 2^-7 "
          f"max|g|); bit for bit {bitwise}", flush=True)
    if not (rel <= TINY_LOSS_RTOL and worst <= 1.0):
        raise AssertionError("remat changed the loss or a gradient")
    del ga, gb
    import numpy as np
    rows = {}
    for tag, tr in (("no remat", plain), ("remat", remat)):
        times, launches, _ = p21_steps(
            tr, inputs=lambda tr=tr: p21_inputs(tr, rank_dropout=0.1))
        want = {"fwd": FWD_PER_STEP_REMAT if tr is remat else FWD_PER_STEP,
                "dq": BWD_PER_STEP, "dkv": BWD_PER_STEP, "inject": 1}
        if any(x != want for x in launches):
            raise AssertionError(f"{tag}: launches {launches}, want {want}")
        b8, _ = p21_peak(tr, p21_inputs(tr, rank_dropout=0.1))
        p1, c1 = next(tr.batches)
        p2, c2 = next(tr.batches)
        pix16, cap16 = np.concatenate([p1, p2]), list(c1) + list(c2)
        b16, s16 = p21_peak(tr, p21_inputs(tr, pix16, cap16, 0.1))
        rows[tag] = (b8, b16)
        med = statistics.median(times)
        print(f"[21b] {tag}: {TRAIN_BATCH / med:.4f} samples/s at B8 (median "
              f"of {len(times)}: {', '.join(f'{x:.4f}' for x in times)} s), "
              f"{16 / s16:.4f} at B16 (one step, {s16:.4f} s); launches a "
              f"step {launches[-1]}; peak memory above the resident "
              f"{b8:.2f} GiB at B8, {b16:.2f} GiB at B16 | {smi}",
              flush=True)
    if not all(rows["remat"][i] < rows["no remat"][i] for i in (0, 1)):
        raise AssertionError(f"remat did not lower the peak: {rows}")
    plain.batches.close()
    remat.batches.close()
    del plain, remat
    torch.cuda.empty_cache()


def p21c(smi: str, s1_file: str) -> None:
    """--gradient_accumulation_steps 2 at B4 against one B8 step over the
    same 8 samples and draws: the updated parameters agree."""
    from aqualora_torch.train import ppft_train as pt
    f32 = ("--mixed_precision", "no")
    acc = p21_trainer(s1_file, *f32, "--gradient_accumulation_steps", "2",
                      batch=TRAIN_BATCH // 2)
    one = p21_trainer(s1_file, *f32)
    pixels, captions = next(one.batches)
    ids = one.tokenizer(captions)
    d = pt.draw(one.pipe, one.generator, pixels)
    h = TRAIN_BATCH // 2
    halves = [(pixels[s], ids[s], pt.Draws(d.msg[s], d.vae_noise[s],
                                           d.noise[s], d.t[s]))
              for s in (slice(0, h), slice(h, None))]
    # warm both batch shapes up (cuDNN's first calls) outside the update
    for tr, inp in ((acc, halves[0]), (one, (pixels, ids, d))):
        p21_grads(tr, inp)
    before = {n: p.detach().clone() for n, p in p21_trainables(one).items()}
    secs = []
    for inp in halves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc.train_step(*inp)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one.train_step(pixels, ids, d)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    # the (clipped) mean gradient the update used, against the B8 step's
    # (the same samples through other batch shapes: bf16 roundings differ)
    lr, worst, agree, total, num, den = 1e-4, 0.0, 0, 0, 0.0, 0.0
    a_params = p21_trainables(acc)
    for n, p in p21_trainables(one).items():
        ga, gb = a_params[n].grad.float(), p.grad.float()
        num += float(((ga - gb) ** 2).sum())
        den += float((gb ** 2).sum())
        step_one = p.detach() - before[n]
        step_acc = a_params[n].detach() - before[n]
        diff = (step_one - step_acc).abs()
        worst = max(worst, float(diff.max()))
        moved = step_one.abs() > 0.5 * lr
        agree += int((diff[moved] <= 0.05 * lr).sum())
        total += int(moved.sum())
    share, rel = agree / max(total, 1), (num / den) ** 0.5
    print(f"[21c] accumulation 2 x B4 against one B8 step, float32, the same "
          f"samples and draws: micro-steps {secs[0]:.4f} s (held) and {secs[1]:.4f} "
          f"s (update), the B8 step {one_s:.4f} s; mean gradient against "
          f"the B8 gradient |d| / |g| {rel:.3e} (tol {P21_ACC_GRAD_TOL:g}); "
          f"updates max |d| {worst:.3e} (bound 2 lr (1 + wd) = "
          f"{2 * lr * 1.01:.3e}), {agree} of {total} moved elements "
          f"({100 * share:.3f}%) within 0.05 lr (tol "
          f"{100 * P21_ACC_AGREE:g}%) | {smi}", flush=True)
    if acc.accumulator.mini_step != 0 or not (
            rel <= P21_ACC_GRAD_TOL and worst <= 2 * lr * 1.01
            and share >= P21_ACC_AGREE):
        raise AssertionError("accumulated update differs from the B8 step")
    acc.batches.close()
    one.batches.close()
    del acc, one
    torch.cuda.empty_cache()
    p21c_bf16(smi, s1_file, pixels, captions)


def _rel_gap(a: dict, b: dict) -> float:
    """|a - b| / |b| over every tensor of two gradient dicts."""
    num = sum(float(((a[n].float() - g.float()) ** 2).sum())
              for n, g in b.items())
    den = sum(float((g.float() ** 2).sum()) for g in b.values())
    return (num / den) ** 0.5


def p21c_bf16(smi: str, s1_file: str, pixels, captions) -> None:
    """bf16, accumulation 2 at B4: the mean the accumulator hands the
    update against the clipped mean of the two B4 gradients computed
    directly (the accumulation's share), and that direct mean against the
    B8 gradient on the same draws (the batch shape's share)."""
    from aqualora_torch.train import ppft_train as pt
    tr = p21_trainer(s1_file, "--gradient_accumulation_steps", "2",
                     batch=TRAIN_BATCH // 2)
    ids = tr.tokenizer(captions)
    d = pt.draw(tr.pipe, tr.generator, pixels)
    h = TRAIN_BATCH // 2
    halves = [(pixels[s], ids[s], pt.Draws(d.msg[s], d.vae_noise[s],
                                           d.noise[s], d.t[s]))
              for s in (slice(0, h), slice(h, None))]
    _, g8 = p21_grads(tr, (pixels, ids, d))
    g1, g2 = (p21_grads(tr, inp)[1] for inp in halves)
    mean = {n: (g1[n] + g2[n]) / 2 for n in g1}
    del g1, g2
    params = p21_trainables(tr)
    lora_ids = {id(p) for g in tr.scheduler.optimizer.param_groups
                if g["name"] != "mapper" for p in g["params"]}
    clipped = {n for n, p in params.items() if id(p) in lora_ids}
    norm = float(sum((mean[n] ** 2).sum() for n in clipped)) ** 0.5
    factor = min(1.0, 1.0 / norm)          # --max_grad_norm 1.0
    want = {n: g * factor if n in clipped else g for n, g in mean.items()}
    for inp in halves:
        tr.train_step(*inp)
    torch.cuda.synchronize()
    got = {n: p.grad for n, p in params.items()}
    acc_gap, shape_gap = _rel_gap(got, want), _rel_gap(mean, g8)
    print(f"[21c] bf16, accumulation 2 x B4: the accumulator's mean against "
          f"the clipped mean of the two B4 gradients computed directly |d| / "
          f"|g| {acc_gap:.3e} (tol {P21_ACC_GRAD_TOL:g}); that direct B4 mean "
          f"against the B8 gradient on the same draws {shape_gap:.3e} "
          f"(the batch shape in bf16, printed) | {smi}", flush=True)
    if not acc_gap <= P21_ACC_GRAD_TOL:
        raise AssertionError("bf16 accumulated mean differs from the direct")
    tr.batches.close()
    del tr, g8, mean, want, got
    torch.cuda.empty_cache()


def p21d(smi: str, s1_file: str, tmp: str) -> None:
    """--train_text_encoder through `run`: two steps, save, the sanity
    inference through the saved text-encoder LoRA; then a fresh pipeline
    loads the file and generates through it."""
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core import io as aio
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion import pipeline as pl
    from aqualora_torch.train import ppft_train as pt
    out = str(Path(tmp) / "te")
    reset_counts()
    res = pt.run(pt.build_argparser().parse_args(p21_argv(
        s1_file, "--train_text_encoder", "--max_train_steps", "3",
        "--output_dir", out, "--validation_prompt", "a photo")))
    torch.cuda.synchronize()
    got = counts()
    tr = res["trainer"]
    te = {n: p.detach().clone() for n, p in
          pt.split_lora(tr.pipe.clip)[1].items()}
    state = aio.load_safetensors(str(Path(out) / aio.LORA_FILE))
    n_te = sum(k.startswith("text_encoder.") for k in state)
    rate = TRAIN_BATCH / statistics.median(res["seconds"][1:])
    print(f"[21d] --train_text_encoder (rank 320 on CLIP's 72 sites, "
          f"{sum(p.numel() for p in te.values())} parameters): "
          f"{rate:.4f} samples/s (median of {len(res['seconds']) - 1} steps "
          f"after a warm-up: {', '.join(f'{x:.4f}' for x in res['seconds'])}"
          f" s); the file holds {len(state)} tensors, {n_te} of the text "
          f"encoder; sanity inference bit accuracy "
          f"{res['sanity_bit_accuracy']:.4f} (random weights: printed); "
          f"launches {got} | {smi}", flush=True)
    if n_te != 144 or len(state) != CHAIN_LORA_TENSORS + 144:
        raise AssertionError(f"text-encoder LoRA file: {len(state)} tensors")
    tr.batches.close()
    del res, tr
    torch.cuda.empty_cache()
    cfg = PipelineConfig.sd15(lora_rank=320)
    import dataclasses
    cfg = dataclasses.replace(cfg, clip=cfg.clip.with_lora(320))
    pipe = pl.StableDiffusionPipeline(cfg, dtype=torch.bfloat16,
                                      device="cuda")
    pipe.init_params(seed=0)
    pipe.load_watermark_lora(out)
    loaded = pt.split_lora(pipe.clip)[1]
    same = set(loaded) == set(te) and all(torch.equal(loaded[k], v)
                                          for k, v in te.items())
    tok = load_tokenizer(None, vocab_size=cfg.clip.vocab_size)
    msg = torch.bernoulli(torch.full((2, 48), 0.5, device="cuda"),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(3))
    gen = pipe.make_generate(num_steps=25, sampler="dpms_m")
    reset_counts()
    with_te = gen(tok(["a photo"] * 2), tok([""] * 2), 7.5,
                  pipe.message_scale(msg, 1.0),
                  generator=torch.Generator(device="cuda").manual_seed(4))
    launches = counts()
    for p in loaded.values():
        p.data.zero_()
    without = gen(tok(["a photo"] * 2), tok([""] * 2), 7.5,
                  pipe.message_scale(msg, 1.0),
                  generator=torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    moved = float((with_te.float() - without.float()).abs().max())
    print(f"[21d] a fresh pipeline with CLIP LoRA loads the file: text-"
          f"encoder LoRA equal to the trained bit for bit {same}; 2 images "
          f"512^2 dpms_m-25 through it: finite "
          f"{bool(torch.isfinite(with_te).all())}, max |d| against the "
          f"text-encoder LoRA zeroed {moved:.4f}, launches {launches}",
          flush=True)
    if not (same and torch.isfinite(with_te).all() and moved > 0
            and launches["fwd"] == LAUNCHES_PER_GENERATE):
        raise AssertionError("text-encoder LoRA did not load or act")
    del pipe, gen
    torch.cuda.empty_cache()


def p21e(smi: str, s1_file: str) -> None:
    """--teacher_skip_lora 0: the loss equals the skipping teacher's
    (torch.equal); the step time of both."""
    from aqualora_torch.train import ppft_train as pt
    tr = p21_trainer(s1_file)
    inputs = p21_inputs(tr)
    with torch.no_grad():
        skip, _ = pt.make_loss_fn(tr.pipe, tr.sec_encoder)(*inputs)
        zero, _ = pt.make_loss_fn(tr.pipe, tr.sec_encoder,
                                  teacher_skip_lora=False)(*inputs)
    rates = {}
    for tag, flag in (("skip", True), ("zero", False)):
        tr.train_step = pt.make_train_step(
            tr.pipe, tr.sec_encoder, tr.scheduler.optimizer, tr.scheduler,
            teacher_skip_lora=flag)
        times, _, _ = p21_steps(tr)
        rates[tag] = statistics.median(times)
    print(f"[21e] --teacher_skip_lora 0: loss {float(zero):.8e}, the "
          f"skipping teacher's {float(skip):.8e}, torch.equal "
          f"{torch.equal(zero, skip)}; step {rates['zero']:.4f} s against "
          f"{rates['skip']:.4f} s (median of {P21_STEPS - 1} each) | {smi}",
          flush=True)
    if not torch.equal(zero, skip):
        raise AssertionError("the scale-0 teacher's loss differs")
    tr.batches.close()
    del tr
    torch.cuda.empty_cache()


def p21f(smi: str, s1_file: str) -> None:
    """--validation_steps 2 in a 4-step run: validations at steps 2 and 4."""
    from aqualora_torch.train import ppft_train as pt
    reset_counts()
    res = pt.run(pt.build_argparser().parse_args(p21_argv(
        s1_file, "--max_train_steps", "4", "--validation_steps", "2",
        "--validation_prompt", "a photo")))
    torch.cuda.synchronize()
    got = counts()
    v = res["validation"]
    print(f"[21f] periodic validation (1 image, 512^2 dpms_m-25): at steps "
          f"{[x['step'] for x in v]}, seconds "
          + ", ".join(f"{x['seconds']:.4f}" for x in v) + ", bit accuracy "
          + ", ".join(f"{x['accuracy']:.4f}" for x in v) + f" (random "
          f"weights: printed); launches of the run {got} | {smi}",
          flush=True)
    want = {"fwd": 4 * FWD_PER_STEP + 2 * LAUNCHES_PER_GENERATE,
            "dq": 4 * BWD_PER_STEP, "dkv": 4 * BWD_PER_STEP, "inject": 4}
    if [x["step"] for x in v] != [2, 4] or got != want:
        raise AssertionError(f"validation steps {v}, launches {got} (want "
                             f"{want})")
    res["trainer"].batches.close()
    del res
    torch.cuda.empty_cache()


def p21g(smi: str, s1_file: str, tmp: str) -> None:
    """Resume bit for bit: PPFT with 8-bit AdamW and accumulation 2
    interrupted after micro-step 3 (mid-window); stage 1 resumed from an
    epoch's checkpoint (cuDNN's deterministic algorithms on)."""
    from aqualora_torch.eval.image_io import save_png
    from aqualora_torch.train import latent_wm_pretrain as s1
    from aqualora_torch.train import ppft_train as pt
    # deterministic cuDNN, and the sort-based scatter_add of gather's
    # backward (stage 1's crop and cornerfy) in place of atomics
    deterministic = torch.backends.cudnn.deterministic
    algorithms = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = str(Path(tmp) / "resume")
        argv = p21_argv(s1_file, "--use_8bit_adam",
                        "--gradient_accumulation_steps", "2",
                        "--max_train_steps", "4", "--checkpointing_steps",
                        "3", "--output_dir", out)
        full = pt.run(pt.build_argparser().parse_args(argv))
        want = {n: p.detach().clone()
                for n, p in p21_trainables(full["trainer"]).items()}
        full["trainer"].batches.close()
        del full
        t0 = time.perf_counter()
        res = pt.run(pt.build_argparser().parse_args(
            argv + ["--resume_from_checkpoint", "3"]))
        resume_s = time.perf_counter() - t0
        got = p21_trainables(res["trainer"])
        same = all(torch.equal(got[n].detach(), v) for n, v in want.items())
        ck = Path(out) / "checkpoints" / "3.pt"
        print(f"[21g] PPFT 8-bit AdamW, accumulation 2, 4 micro-steps "
              f"against a run resumed from micro-step 3 (mid-window; the "
              f"checkpoint {ck.stat().st_size / 2 ** 30:.3f} GiB): "
              f"{len(want)} trainables bit for bit {same}; the resumed run "
              f"{resume_s:.2f} s | {smi}", flush=True)
        res["trainer"].batches.close()
        del res, got, want
        torch.cuda.empty_cache()
        if not same:
            raise AssertionError("PPFT resume mid-window differs")
        # stage 1: A trains epoch 0; B resumes it for epochs 1-2; C resumes
        # epoch 1's checkpoint for epoch 2: C's epoch-2 state is B's
        import numpy as np
        folder = Path(tmp) / "s1_images"
        folder.mkdir()
        rng = np.random.default_rng(21)
        for i in range(P21_S1_FILES):
            save_png(str(folder / f"{i}.png"), rng.integers(
                0, 256, (S1_RES, S1_RES, 3), dtype=np.uint8))

        def stage1(out_dir, *extra):
            return s1.run(s1.build_argparser().parse_args([
                "--batch_size", str(S1_BATCH), "--mixed_precision", "bf16",
                "--seed", "0", "--dataset", str(folder), "--output_dir",
                out_dir, *extra]))
        a, c = str(Path(tmp) / "s1a"), str(Path(tmp) / "s1c")
        stage1(a, "--epochs", "1")
        rb = stage1(a, "--epochs", "2", "--resume_from_ckpt", "latest")
        os.makedirs(Path(c) / "checkpoints")
        shutil.copy(Path(a) / "checkpoints" / "1.pt",
                    Path(c) / "checkpoints" / "1.pt")
        rc = stage1(c, "--epochs", "1", "--resume_from_ckpt", "1")
        wa = torch.load(Path(a) / "checkpoints" / "2.pt", weights_only=True)
        wc = torch.load(Path(c) / "checkpoints" / "2.pt", weights_only=True)
        same = all(torch.equal(wa[part][k], wc[part][k])
                   for part in ("sec_encoder", "sec_decoder")
                   for k in wa[part]) and torch.equal(wa["generator"],
                                                      wc["generator"])
        print(f"[21g] stage 1 --resume_from_ckpt (512^2 B{S1_BATCH} bf16, "
              f"one step an epoch): epoch 2 resumed from epoch 1's "
              f"checkpoint against epochs 1-2 resumed from epoch 0's: "
              f"encoder, decoder, BatchNorm statistics and generator bit "
              f"for bit {same}; losses {rb['history'][-1]['loss']:.6e} and "
              f"{rc['history'][-1]['loss']:.6e}", flush=True)
        if not same or rb["history"][-1] != rc["history"][-1]:
            raise AssertionError("stage-1 resume differs")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(algorithms[0],
                                           warn_only=algorithms[1])


def p21h(smi: str) -> None:
    """Stage 1's remat flags at B5, bf16 and float32: peak memory of the
    loss and backward with and without each, the d = 512 forward's
    launches (4 with --remat_vae_decode) and the loss unchanged."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import latent_wm_pretrain as s1
    configs = (("none", {}), ("--remat_vae_decode",
                              {"remat_vae_decode": True}),
               ("--remat_lpips", {"remat_lpips": True}),
               ("both", {"remat_vae_decode": True, "remat_lpips": True}))
    for mp, dtype in (("bf16", torch.bfloat16), ("no", torch.float32)):
        tag = DTYPE_NAMES[dtype]
        tr = s1.build_trainer(s1.build_argparser().parse_args([
            "--batch_size", str(S1_BATCH), "--mixed_precision", mp,
            "--seed", "0"]))
        m = tr.models
        with torch.no_grad():
            w = m.sec_encoder.conv_out.weight
            w.copy_(0.1 * torch.randn(w.shape, device="cuda", generator=torch
                                      .Generator(device="cuda").manual_seed(
                                          21)))
        ctl = s1.Control()
        pixels, _ = next(tr.dataset.batches(S1_BATCH, seed=0))
        x = torch.as_tensor(pixels, device="cuda").permute(0, 3, 1, 2)
        d = s1.draw(m, tr.generator, tuple(x.shape), ctl.distort_probs)
        stats = {k: v.clone() for k, v in m.sec_decoder.state_dict().items()}
        rows, loss0 = {}, None
        for name, kw in configs:
            m.sec_decoder.load_state_dict(stats)
            for part in (m.sec_encoder, m.sec_decoder):
                part.zero_grad(set_to_none=True)
            fn = s1.make_loss_fn(m, **kw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = fa.launches.by_shape[S1_KEY]
            t0 = time.perf_counter()
            loss, _ = fn(x, d, ctl)
            loss.backward()
            torch.cuda.synchronize()
            rows[name] = ((torch.cuda.max_memory_allocated() - base)
                          / 2 ** 30, time.perf_counter() - t0,
                          fa.launches.by_shape[S1_KEY] - before,
                          float(loss.detach()))
            loss0 = loss.detach() if loss0 is None else loss0
            if not torch.equal(loss.detach(), loss0):
                raise AssertionError(f"{tag} {name}: loss {float(loss)} "
                                     f"against {float(loss0)}")
        print(f"[21h] stage-1 loss and backward 512^2 B{S1_BATCH} {tag}, "
              f"peak memory above the resident / seconds / d = 512 forward "
              f"launches: "
              + "; ".join(f"{n} {r[0]:.2f} GiB {r[1]:.4f} s {r[2]}"
                          for n, r in rows.items())
              + f"; loss {rows['none'][3]:.6e} equal in all | {smi}",
              flush=True)
        want = {"none": 3, "--remat_vae_decode": 4, "--remat_lpips": 3,
                "both": 4}
        if {n: r[2] for n, r in rows.items()} != want:
            raise AssertionError(f"{tag}: d = 512 launches {rows}")
        if not (rows["--remat_vae_decode"][0] < rows["none"][0]
                and rows["both"][0] < rows["none"][0]):
            raise AssertionError(f"{tag}: remat did not lower the peak")
        del tr, m
        torch.cuda.empty_cache()


def phase21(smi: str, tmp: str, step_rate: float | None):
    """The trainers' remaining options at full width (see the docstring);
    returns 21a's optimizer for `phase21_profile`."""
    t_phase = time.perf_counter()
    s1_file = p21_pretrain(tmp)
    opt = p21a(smi, s1_file, step_rate)
    p21b(smi, s1_file)
    p21c(smi, s1_file)
    p21d(smi, s1_file, tmp)
    p21e(smi, s1_file)
    p21f(smi, s1_file)
    p21g(smi, s1_file, tmp)
    p21h(smi)
    print(f"[21] phase 21 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return opt


# ---------------------------------------------------------------------------
# phase 22, the fidelity benchmarks: FID (InceptionV3) and DreamSim (the ViT
# ensemble) through run_fid and run_dreamsim
# ---------------------------------------------------------------------------

# the ViTs' float32 attention, the CUDA-core forward at d <= 80 (d = 64
# with 16 of the instance's 80 columns masked; every length ragged): name,
# heads, T, head dim
VIT_SHAPES = [("vitb16", 12, 197, 64),    # the ensemble's three, mae_vitb16
              ("vitb32", 12, 50, 64),     # clip_vitb32, open_clip_vitb32
              ("mae_vitl16", 16, 197, 64),
              ("mae_vith14", 16, 257, 80)]
VIT_BATCHES = (4, 8)
ENSEMBLE_BLOCKS = 3 * 12           # forward launches of one embed call
VITH_BLOCKS = 32
FID_IMAGES, FID_STEPS = 16, 50     # run_fid: the protocol's step count
DS_PROMPTS = 8
LAUNCHES_PER_GENERATE_50 = 32 * FID_STEPS + 1                # 1601
RATE_IMAGES, RATE_BATCH = 512, 32  # the extractor's images/s at 299^2
CHECK_IMAGES, CHECK_PAIRS = 16, 8
DIST_TOL = 1e-5                    # DreamSim distances, card vs CPU


def feature_tol(ref) -> float:
    """float32 features through about 95 convolutions (or 12 blocks)
    summed in other orders on the card and the CPU: 1e-4 of the largest
    plus 1e-5, the CPU tests' limit against JAX."""
    return 1e-4 * float(abs(ref).max()) + 1e-5


class tf32_on:
    """TF32 allowed for cuDNN and matrix products, as PyTorch's default
    leaves cuDNN: the metrics' extractors must turn it off themselves
    (`utils/precision.full_float32`) and give the flags back."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        self.after = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
        if exc[0] is None and self.after != (True, True):
            raise AssertionError(f"an extractor left the TF32 flags at "
                                 f"{self.after}")


def vit_shapes():
    """(key, heads, T, d, batch) of 22a."""
    return [(f"dreamsim_{name}_b{b}", h, t, d, b)
            for name, h, t, d in VIT_SHAPES for b in VIT_BATCHES]


def phase22a(smi: str) -> dict:
    """The float32 forward at the ViTs' shapes, B4 and B8, against its
    plain version (O and lse), two calls bit-identical; kernel_ms, plain_ms,
    SDPA's float32 time (a yardstick only) and the bound at the CUDA cores'
    float32 rate."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(220)
    rows = {}
    for key, h, t, d, b in vit_shapes():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for _ in range(3))
        first, again = (fa.flash_attention_fwd(q, k, v, scale)
                        for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"{key}: two forward calls differ")
        err = check_fwd(f"[22] {key} float32", q, k, v, scale, out=first)
        kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale),
                           iters=3, warmup=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(b, h, t, t, d, elem_bytes=4,
                                             peak=PEAK_F32_FLOPS)
        print(f"[22] {key} (B{b} H{h} T{t} d{d}) float32, two calls "
              f"bit-identical: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms(sdpa float32) {library_ms:.4f} = "
              f"{kernel_ms / library_ms:.2f}x, bound_ms {bound_ms:.4f} "
              f"({bound_by}, float32 at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s) "
              f"| {smi}", flush=True)
        rows[key] = {"max_abs_err": err, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v, first, again
    torch.cuda.empty_cache()
    return rows


def phase22a_profile(smi: str, rows: dict) -> None:
    """22a's forward and SDPA's float32 forward as device time."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(221)
    for key, h, t, d, b in vit_shapes():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for _ in range(3))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        print(f"[22] {key} float32: forward device time {kernel_dev:.4f} ms, "
              f"sdpa float32 forward {library_dev:.4f} = "
              f"{kernel_dev / library_dev:.2f}x, bound "
              f"{rows[key]['bound_ms']:.4f} ({rows[key]['bound_by']}), "
              f"kernel_ms {rows[key]['ms']:.4f} | {smi}", flush=True)
        del q, k, v
    torch.cuda.empty_cache()


def phase22b(smi: str, tmp: str) -> None:
    """InceptionV3 on the card: seeded random weights, full width; 16
    images card vs CPU with TF32 allowed around the call; the 8 realistic
    JPEGs (mixed sizes) through `fid.py --save-stats` card vs CPU; the
    extractor's images/s at 299^2, B32."""
    import numpy as np

    from aqualora_torch.eval import fid
    from aqualora_torch.utils.precision import full_float32
    rng = np.random.default_rng(22)
    card = fid.InceptionExtractor(device="cuda")
    host = fid.InceptionExtractor(device="cpu")
    imgs = rng.random((CHECK_IMAGES, 256, 256, 3), dtype=np.float32)
    with tf32_on() as flags:
        f_card = card(imgs, batch_size=CHECK_IMAGES)
    f_host = host(imgs, batch_size=CHECK_IMAGES)
    err, tol = float(abs(f_card - f_host).max()), feature_tol(f_host)
    print(f"[22] InceptionV3 (seeded random weights) on {CHECK_IMAGES} "
          f"images 256^2 -> 299^2, card vs CPU: max|df| {err:.3e} (tol "
          f"{tol:.3e}, max|f| {float(abs(f_host).max()):.3e}); TF32 flags "
          f"after the call {flags.after}", flush=True)
    if not (np.isfinite(f_card).all() and err <= tol):
        raise AssertionError(f"Inception card vs CPU: {err} > {tol}")

    folder = str(FIXTURES / "realistic")
    sizes = sorted({im.shape[:2] for im in fid._load_images(folder)})
    npz = str(Path(tmp) / "realistic_stats.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tf32_on():
        mu, sigma = fid.main([folder, npz, "--save-stats",
                              "--allow-random-weights", "--batch-size", "8",
                              "--device", "cuda"])
    stats_s = time.perf_counter() - t0
    f_ref = host(fid._load_images(folder), 8)
    ref_mu, ref_sigma = fid.activation_statistics(f_ref)
    tol_f = feature_tol(f_ref)
    # a covariance term moves by at most about 2 max|f| df
    tol_s = 2 * float(abs(f_ref).max()) * tol_f + tol_f ** 2
    err_mu = float(abs(mu - ref_mu).max())
    err_s = float(abs(sigma - ref_sigma).max())
    with np.load(npz) as f:
        saved_ok = (np.array_equal(f["mu"], mu)
                    and np.array_equal(f["sigma"], sigma))
    print(f"[22] fid.py --save-stats on the 8 realistic JPEGs ({len(sizes)} "
          f"sizes, {sizes[0]} to {sizes[-1]}) on the card in {stats_s:.4f} "
          f"s: mu vs CPU max|d| {err_mu:.3e} (tol {tol_f:.3e}), sigma "
          f"max|d| {err_s:.3e} (tol {tol_s:.3e}); the .npz as returned: "
          f"{saved_ok}", flush=True)
    if not (err_mu <= tol_f and err_s <= tol_s and saved_ok
            and len(sizes) > 1):
        raise AssertionError("fid --save-stats: card vs CPU disagree")

    many = rng.random((RATE_IMAGES, 299, 299, 3), dtype=np.float32)
    card(many[:RATE_BATCH], batch_size=RATE_BATCH)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = card(many, batch_size=RATE_BATCH)
    end_s = time.perf_counter() - t0
    x = torch.from_numpy(many[:RATE_BATCH]).to("cuda").permute(0, 3, 1, 2)
    with full_float32(), torch.no_grad():
        model_ms = time_ms(lambda: card.model(x * 2 - 1), iters=5)
    print(f"[22] InceptionExtractor at 299^2 B{RATE_BATCH}, float32, "
          f"{RATE_IMAGES} seeded images from host memory: "
          f"{RATE_IMAGES / end_s:.2f} images/s end to end ({end_s:.4f} s); "
          f"the network alone {model_ms:.4f} ms a batch = "
          f"{RATE_BATCH / model_ms * 1e3:.2f} images/s | {smi}", flush=True)
    if feats.shape != (RATE_IMAGES, 2048) or not np.isfinite(feats).all():
        raise AssertionError("the extractor's features at B32")
    del many, x
    torch.cuda.empty_cache()


def phase22c(smi: str) -> None:
    """DreamSim on the card: the ensemble (seeded random weights) vs the
    CPU on 8 pairs at 512^2, TF32 allowed around the call, 72 forward
    launches a call; pairs/s at B4; mae_vith14 once (T = 257, d = 80)."""
    import numpy as np

    from aqualora_torch.eval.dreamsim import DreamSim
    from aqualora_torch.ops import flash_attention as fa
    rng = np.random.default_rng(222)
    a = rng.random((CHECK_PAIRS, RES, RES, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    card = DreamSim(device="cuda")
    host = DreamSim(device="cpu")
    torch.cuda.synchronize()
    reset_counts()
    with tf32_on():
        d_card = card(a, b)
    torch.cuda.synchronize()
    got, by_shape = counts(), dict(fa.launches.by_shape)
    d_host = host(a, b)
    err = float(abs(d_card - d_host).max())
    want = {"fwd": 2 * ENSEMBLE_BLOCKS, **NO_TRAINING}
    print(f"[22] DreamSim ensemble (seeded random weights) on {CHECK_PAIRS} "
          f"pairs 512^2 -> 224^2, card vs CPU: max|d dist| {err:.3e} (tol "
          f"{DIST_TOL:g}), distances "
          f"{[round(float(x), 5) for x in d_card]}; "
          f"launches {got} by shape {by_shape}", flush=True)
    if not (err <= DIST_TOL and got == want and np.isfinite(d_card).all()
            and by_shape == {(12, 197, 197, 64): 2 * ENSEMBLE_BLOCKS}):
        raise AssertionError(f"DreamSim card vs CPU: {err}, launches {got}")
    ms = time_ms(lambda: card(a[:PROTOCOL_IMAGES], b[:PROTOCOL_IMAGES]),
                 iters=5, warmup=1)
    print(f"[22] DreamSim ensemble at B{PROTOCOL_IMAGES} from host memory: "
          f"{ms:.4f} ms a call = {PROTOCOL_IMAGES / ms * 1e3:.2f} pairs/s "
          f"| {smi}", flush=True)
    del host, card
    vith = DreamSim(dreamsim_type="mae_vith14", device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    d = vith(a[:PROTOCOL_IMAGES], b[:PROTOCOL_IMAGES])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got, by_shape = counts(), dict(fa.launches.by_shape)
    same = vith(a[:2], a[:2])
    print(f"[22] mae_vith14 (32 blocks, 1280 wide) at B{PROTOCOL_IMAGES}: "
          f"{sec:.4f} s (first call), distances "
          f"{[round(float(x), 5) for x in d]}, "
          f"self {float(abs(same).max()):.2e}; launches {by_shape} "
          f"| {smi}", flush=True)
    if not (np.isfinite(d).all() and abs(same).max() < 1e-5
            and by_shape == {(16, 257, 257, 80): 2 * VITH_BLOCKS}):
        raise AssertionError(f"mae_vith14: {d}, launches {by_shape}")
    del vith
    torch.cuda.empty_cache()


class FidelityParts:
    """Times the parts of run_fid and run_dreamsim by wrapping what they
    call (each wrapper synchronizes the card before it stops its clock) and
    counts the forward launches of each generate call and each DreamSim
    call.  `install()` / `remove()`."""

    def __init__(self):
        from aqualora_torch.diffusion import pipeline as pl
        from aqualora_torch.eval import dreamsim, fid
        from aqualora_torch.eval import utils_eval as ue
        from aqualora_torch.train import image_decode
        self.targets = [(pl.StableDiffusionPipeline, "make_generate"),
                        (ue, "save_png"), (image_decode, "decode_file"),
                        (fid.InceptionExtractor, "__call__"),
                        (fid, "frechet_distance"),
                        (dreamsim.DreamSim, "__call__")]
        self.saved = {}
        self.seconds = {"generate": 0.0, "png_write": 0.0, "png_read": 0.0,
                        "features": 0.0, "frechet": 0.0, "dreamsim": 0.0}
        self.generate, self.dreamsim = [], []

    def _timed(self, part, fn, record=None):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds[part] += time.perf_counter() - t0
            if record is not None:
                after = counts()
                record.append({c: after[c] - before[c] for c in after})
            return out
        return wrapper

    def install(self):
        self.saved = {(o, n): getattr(o, n) for o, n in self.targets}
        (pl_cls, _), (ue, _), (dec, _), (ex_cls, _), (fid, _), \
            (ds_cls, _) = self.targets
        make = self.saved[(pl_cls, "make_generate")]

        def counted_make(pipe, *a, **k):
            return self._timed("generate", make(pipe, *a, **k),
                               self.generate)
        pl_cls.make_generate = counted_make
        ue.save_png = self._timed("png_write", self.saved[(ue, "save_png")])
        dec.decode_file = self._timed("png_read",
                                      self.saved[(dec, "decode_file")])
        ex_cls.__call__ = self._timed("features",
                                      self.saved[(ex_cls, "__call__")])
        fid.frechet_distance = self._timed(
            "frechet", self.saved[(fid, "frechet_distance")])
        ds_cls.__call__ = self._timed("dreamsim",
                                      self.saved[(ds_cls, "__call__")],
                                      self.dreamsim)

    def remove(self):
        for (obj, name), fn in self.saved.items():
            setattr(obj, name, fn)


def run_counted(main, argv) -> tuple:
    """One runner `main(argv)` with its parts timed and the counts set to
    0 before it and read after it -> (result, wall seconds, parts, counts,
    launches by shape)."""
    from aqualora_torch.ops import flash_attention as fa
    parts = FidelityParts()
    parts.install()
    try:
        torch.cuda.synchronize()
        reset_counts()                          # counts start here
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_shape = counts(), dict(fa.launches.by_shape)
    finally:
        parts.remove()
    return result, wall, parts, got, by_shape


def phase22d(smi: str, out_dir: str, tmp: str) -> dict:
    """run_fid at full width on phase 15's artifacts: 16 captions, 512^2,
    dpms_m 50 steps, CFG 7.5, bf16, B4, seeded random Inception, the FID of
    the folder against itself.  Returns the forward launches by shape."""
    from aqualora_torch.eval import run_fid
    meta = Path(tmp) / "fid_captions.json"
    meta.write_text(json.dumps({"annotations": [
        {"caption": f"{p}, view {i}"} for i in range(2) for p in PROMPTS]}))
    out = Path(tmp) / "run_fid"
    gen = out / "images"
    argv = ["--meta_data", str(meta), "--gt_dir", str(gen), "--train_folder",
            out_dir, "--output_dir", str(out), "--num_images",
            str(FID_IMAGES), "--batch_size", str(PROTOCOL_IMAGES),
            "--num_inference_steps", str(FID_STEPS), "--resolution",
            str(RES), "--sampler", "dpms_m", "--msg_bits",
            str(EVAL_MSG_BITS), "--allow_random_inception", "--device",
            "cuda"]
    result, wall, parts, got, by_shape = run_counted(run_fid.main, argv)
    pngs = sorted(p.name for p in gen.glob("*.png"))
    calls = FID_IMAGES // PROTOCOL_IMAGES
    want_call = {"fwd": LAUNCHES_PER_GENERATE_50, **NO_TRAINING}
    s = parts.seconds
    features = s["features"] - s["png_read"]
    rest = wall - s["generate"] - s["png_write"] - s["features"] \
        - s["frechet"]
    print(f"[22] run_fid: {FID_IMAGES} images at 512^2 dpms_m-{FID_STEPS} "
          f"CFG 7.5 bf16 B{PROTOCOL_IMAGES}, FID against themselves "
          f"{result['fid']:.3e} in {wall:.4f} s = "
          f"{wall / FID_IMAGES:.4f} s an image end to end; seconds: "
          f"generate {s['generate']:.4f} ({s['generate'] / FID_IMAGES:.4f} "
          f"an image), PNG write {s['png_write']:.4f}, PNG read "
          f"{s['png_read']:.4f}, features {features:.4f} (both folders), "
          f"Frechet (host sqrtm) {s['frechet']:.4f}, the rest {rest:.4f}; "
          f"launches {got}, per generate call {parts.generate} | {smi}",
          flush=True)
    if not (abs(result["fid"]) < 1e-3 and result["n_images"] == FID_IMAGES
            and result["random_inception"] is True
            and json.loads((out / "fid.json").read_text()) == result
            and len(pngs) == FID_IMAGES and len(parts.generate) == calls
            and all(c == want_call for c in parts.generate)
            and got == {"fwd": calls * LAUNCHES_PER_GENERATE_50,
                        **NO_TRAINING}):
        raise AssertionError(f"run_fid failed a check: {result}, {pngs}, "
                             f"launches {got}, calls {parts.generate}")
    return by_shape


def phase22e(smi: str, out_dir: str) -> dict:
    """run_dreamsim at full width on phase 15's artifacts: 8 prompts,
    512^2, dpms_m 25, CFG 7.5, bf16, B4, with and without the LoRA, the
    seeded random ensemble.  Returns the forward launches by shape."""
    import numpy as np

    from aqualora_torch.eval import run_dreamsim
    argv = ["--train_folder", out_dir, "--num_prompts", str(DS_PROMPTS),
            "--batch_size", str(PROTOCOL_IMAGES), "--steps", str(STEPS),
            "--resolution", str(RES), "--msg_bits", str(EVAL_MSG_BITS),
            "--allow_random_weights", "--device", "cuda"]
    dists, wall, parts, got, by_shape = run_counted(run_dreamsim.main, argv)
    n_gen = 2 * DS_PROMPTS // PROTOCOL_IMAGES
    n_ds = DS_PROMPTS // PROTOCOL_IMAGES
    want_gen = {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}
    want_ds = {"fwd": 2 * ENSEMBLE_BLOCKS, **NO_TRAINING}
    s = parts.seconds
    print(f"[22] run_dreamsim: {DS_PROMPTS} pairs at 512^2 dpms_m-{STEPS} "
          f"CFG 7.5 bf16 B{PROTOCOL_IMAGES} in {wall:.4f} s = "
          f"{DS_PROMPTS / wall:.4f} pairs/s end to end; mean DreamSim "
          f"distance {float(np.mean(dists)):.6f} (random weights: printed); "
          f"seconds: generate {s['generate']:.4f}, DreamSim "
          f"{s['dreamsim']:.4f}, the rest "
          f"{wall - s['generate'] - s['dreamsim']:.4f}; launches {got}, per "
          f"generate call {parts.generate}, per DreamSim call "
          f"{parts.dreamsim} | {smi}", flush=True)
    if not (len(dists) == DS_PROMPTS and np.isfinite(dists).all()
            and len(parts.generate) == n_gen and len(parts.dreamsim) == n_ds
            and all(c == want_gen for c in parts.generate)
            and all(c == want_ds for c in parts.dreamsim)
            and got == {"fwd": n_gen * LAUNCHES_PER_GENERATE
                        + n_ds * 2 * ENSEMBLE_BLOCKS, **NO_TRAINING}):
        raise AssertionError(f"run_dreamsim failed a check: {dists}, "
                             f"launches {got}, generate {parts.generate}, "
                             f"DreamSim {parts.dreamsim}")
    return by_shape


# SD-2.1 at its native 768^2 under CFG at B2 (the golden gate's batch): the
# forward's shapes, d = 64 at every U-Net level (the DP = 80 instance with
# 16 columns masked) and the VAE's mid-block at d = 512.  name, heads, Tq,
# Tk, head dim, batch, launches a 25-step generate call
SD21_768_SHAPES = [
    ("unet96_self", 5, 9216, 9216, 64, 4, 125),
    ("unet96_cross", 5, 9216, 77, 64, 4, 125),
    ("unet48_self", 10, 2304, 2304, 64, 4, 125),
    ("unet48_cross", 10, 2304, 77, 64, 4, 125),
    ("unet24_self", 20, 576, 576, 64, 4, 125),
    ("unet24_cross", 20, 576, 77, 64, 4, 125),
    ("unet12_self", 20, 144, 144, 64, 4, 25),
    ("unet12_cross", 20, 144, 77, 64, 4, 25),
    ("vae_mid", 1, 9216, 9216, 512, 2, 1),
]
GATE_LORA_TENSORS = 384
GATE_PROMPTS = {"sd15": 4, "sd21": 2}
GATE_BATCH = 2
GATE_MERGE_TOL = 4.0                 # mean |d| of the uint8 images, /255
LDM_FILE = "watermark_SDmodel.safetensors"
DECODER_LOGIT_RTOL = 1e-4


def sd21_768_shapes():
    """(key, heads, Tq, Tk, d, batch, launches a call)."""
    return [(f"sd21_768/{name}", *rest) for name, *rest in SD21_768_SHAPES]


def phase23a(smi: str) -> dict:
    """Every forward shape of an SD-2.1 generate at 768^2 B2, bf16 at its
    batch: two calls bit-identical, against the plain version, the tiling,
    kernel, plain, SDPA and bound times (as phase 2)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    return {key: check_serving_shape(key, h, tq, tk, d, b, gen, smi,
                                     at_b2=False, phase=23,
                                     plain=plain_by_batch)
            for key, h, tq, tk, d, b, _ in sd21_768_shapes()}


def phase23a_profile(smi: str, rows: dict) -> None:
    """23a's forward and SDPA's forward as device time (as phase 10)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(231)
    for key, h, tq, tk, d, b, _ in sd21_768_shapes():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for t in (tq, tk, tk))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        row = rows[key]
        print(f"[23] {key} B{b} bf16: forward device time {kernel_dev:.4f} "
              f"ms, sdpa forward {library_dev:.4f} = "
              f"{kernel_dev / library_dev:.2f}x, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}), kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.4f}, max|dO| {row['max_abs_err']:.3e} | "
              f"{smi}", flush=True)
        row.update(device_ms=kernel_dev, library_device_ms=library_dev)
        del q, k, v
        torch.cuda.empty_cache()


class GateParts:
    """Times the parts of the golden gate and the parity runbook by
    wrapping what they call (each wrapper synchronizes the card before it
    stops its clock), counts the forward launches of each generate call,
    and keeps what the checks read: the bits of each `simple_decode` call
    and whether each single file read back was found to be v2.
    `install()` / `remove()`."""

    def __init__(self):
        from aqualora_torch.diffusion import pipeline as pl
        from aqualora_torch.eval import fid, run_eval_base
        from aqualora_torch.eval import utils_eval as ue
        from aqualora_torch.tools import (create_wm_lora, golden_gate,
                                          ldm_convert, merge_lora,
                                          port_reference_artifacts,
                                          synthetic_artifacts)
        self.ldm = ldm_convert
        self.targets = [
            (synthetic_artifacts, "synthesize_reference_artifacts",
             "synthesis"),
            (port_reference_artifacts, "port", "port"),
            (create_wm_lora, "create_watermark_lora", "fold"),
            (golden_gate, "base_params", "base weights"),
            (ue, "simple_sample", "sample (pipeline build + generate)"),
            (ue, "simple_decode", "decode"),
            (merge_lora, "merge_lora_into_states", "merge"),
            (ldm_convert, "diffusers_to_ldm", "to LDM keys"),
            (golden_gate, "save_safetensors", "write"),
            (golden_gate, "load_safetensors", "read"),
            (ldm_convert, "ldm_to_diffusers", "reload (LDM -> diffusers)"),
            (fid.InceptionExtractor, "__call__", "FID smoke features"),
            (fid, "frechet_distance", "FID smoke Frechet (host sqrtm)"),
            (run_eval_base, "main", "eval_base"),
            (pl.StableDiffusionPipeline, "make_generate", None)]
        self.saved = {}
        self.calls = []            # (part, label, seconds)
        self.generate = []         # (seconds, launches) of each call
        self.decoded, self.v2 = [], []

    def _timed(self, part, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            label = ""
            if part in ("write", "read"):
                label = os.path.basename(a[1] if part == "write" else a[0])
            self.calls.append((part, label, time.perf_counter() - t0))
            if part == "decode":
                self.decoded.append(out[2])
            return out
        return wrapper

    def install(self):
        self.saved = {(o, n): getattr(o, n) for o, n, _ in self.targets}
        for obj, name, part in self.targets[:-1]:
            setattr(obj, name, self._timed(part, self.saved[(obj, name)]))
        reload = getattr(self.ldm, "ldm_to_diffusers")
        detect = self.ldm.detect_v2

        def reload_detected(state, *a, **k):
            self.v2.append(detect(state))
            return reload(state, *a, **k)
        self.ldm.ldm_to_diffusers = reload_detected
        pl_cls = self.targets[-1][0]
        make = self.saved[(pl_cls, "make_generate")]

        def counted_make(pipe, *a, **k):
            generate = make(pipe, *a, **k)

            def counted(*ga, **gk):
                torch.cuda.synchronize()
                before, t0 = counts(), time.perf_counter()
                out = generate(*ga, **gk)
                torch.cuda.synchronize()
                after = counts()
                self.generate.append((time.perf_counter() - t0, {
                    c: after[c] - before[c] for c in after}))
                return out
            return counted
        pl_cls.make_generate = counted_make

    def remove(self):
        for (obj, name), fn in self.saved.items():
            setattr(obj, name, fn)

    def seconds(self) -> str:
        return ", ".join(f"{part}{f' {label}' if label else ''} {s:.4f}"
                         for part, label, s in self.calls)

    def run(self, fn, *a):
        """fn(*a) with the parts timed and the counts set to 0 before it
        and read after it -> (result, wall seconds, counts, launches by
        shape)."""
        from aqualora_torch.ops import flash_attention as fa
        self.install()
        try:
            torch.cuda.synchronize()
            reset_counts()                      # counts start here
            t0 = time.perf_counter()
            result = fn(*a)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, by_shape = counts(), dict(fa.launches.by_shape)
        finally:
            self.remove()
        return result, wall, got, by_shape


def check_gate_calls(tag: str, parts: GateParts, n_calls: int,
                     got: dict) -> None:
    """Every generate call launched the forward 801 times (and no training
    kernel), and the run's counts are the sum of its calls."""
    want = {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}
    if (len(parts.generate) != n_calls
            or any(c != want for _, c in parts.generate)
            or got != {"fwd": n_calls * LAUNCHES_PER_GENERATE,
                       **NO_TRAINING}):
        raise AssertionError(f"{tag}: launches {got}, per generate call "
                             f"{[c for _, c in parts.generate]}; want "
                             f"{n_calls} calls of {want}")


def check_ported_files(out: Path, smi: str) -> None:
    """The ported release files at full width load strictly into the
    port's modules; the ported msgdecoder.pt gives the same logits on the
    card as on the CPU, float32, to 1e-4 of the largest."""
    from aqualora_torch.core.config import EfficientNetConfig
    from aqualora_torch.core.io import assign_state, load_safetensors
    from aqualora_torch.eval.utils_eval import load_msgdecoder
    from aqualora_torch.models.watermark import (MapperNet, SecretDecoder,
                                                 SecretEncoder)
    from aqualora_torch.train.ppft_train import load_pretrain
    backbone = EfficientNetConfig.b1(num_classes=2 * EVAL_MSG_BITS)
    with torch.device("cuda"):
        encoder = SecretEncoder(EVAL_MSG_BITS)
        mapper = MapperNet(EVAL_MSG_BITS, 320)
    load_pretrain(str(out / "pretrained_latentwm.pt"), encoder,
                  SecretDecoder(EVAL_MSG_BITS, backbone, device="cuda"))
    assign_state(mapper, load_safetensors(str(out / "mapper.safetensors")))
    gen = torch.Generator().manual_seed(232)
    x = torch.rand(PROTOCOL_IMAGES, 3, RES, RES, generator=gen) * 2 - 1
    logits = {}
    for device in ("cpu", "cuda"):
        dec = load_msgdecoder(str(out / "msgdecoder.pt"), EVAL_MSG_BITS,
                              backbone, device=device)
        with torch.no_grad():
            logits[device] = dec(x.to(device)).float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    tol = DECODER_LOGIT_RTOL * logits["cpu"].abs().max().item()
    print(f"[23] ported files load strictly (stage-1 file, mapper, "
          f"decoder); the ported msgdecoder.pt at B{PROTOCOL_IMAGES} {RES}^2 "
          f"float32, card vs CPU: max|d logit| {err:.3e} (tol {tol:.3e}) | "
          f"{smi}", flush=True)
    if not err <= tol:
        raise AssertionError(f"ported decoder: card vs CPU {err} > {tol}")


def gate_summary(tag: str, parts: GateParts, res: int, n_images: int,
                 wall: float, ldm_bytes: int, smi: str) -> None:
    """Print the gate's seconds, images/s and the fold and merge paths'
    decoded-bit agreement."""
    fold_s = sum(s for s, _ in parts.generate[: n_images // GATE_BATCH])
    fold, merged = parts.decoded[:2]
    agree = sum(a == b for x, y in zip(fold, merged)
                for a, b in zip(x, y)) / sum(len(x) for x in fold)
    print(f"[23] {tag}: {wall:.4f} s end to end; {n_images} images at "
          f"{res}^2 dpms_m-{STEPS} CFG 7.5 bf16 B{GATE_BATCH} in "
          f"{fold_s:.4f} s of generate calls = {n_images / fold_s:.4f} "
          f"images/s (fold path); generate calls (s) "
          f"{[round(s, 4) for s, _ in parts.generate]}; the LDM file "
          f"{ldm_bytes / 1e9:.4f} GB; the fold and merge paths' decoded "
          f"bits agree on {agree:.4f} of {sum(len(x) for x in fold)}; "
          f"seconds: {parts.seconds()} | {smi}", flush=True)


def phase23b(smi: str) -> None:
    """`run_parity.run` at SD-1.5 512^2 on synthetic release files: the
    gate (synthesis, port, fold, generate, decode, the merge workflow, the
    FID smoke) and run_eval_base on its ported files, B2."""
    from aqualora_torch.core.io import read_safetensors_header
    from aqualora_torch.tools import run_parity
    n = GATE_PROMPTS["sd15"]
    with tempfile.TemporaryDirectory(prefix="aqualora_gate15_") as tmp:
        out = Path(tmp)
        args = run_parity.build_argparser().parse_args(
            ["--out", tmp, "--synthetic", "--skip_int8",
             "--gate_num_prompts", str(n), "--batch_size", str(GATE_BATCH),
             "--eval_num_prompts", str(n), "--eval_num_seeds", "1",
             "--device", "cuda"])
        parts = GateParts()
        parity, wall, got, _ = parts.run(run_parity.run, args)
        ldm = out / "gate" / LDM_FILE
        ldm_bytes = ldm.stat().st_size
        ldm.unlink()
        check_gate_calls("[23] run_parity", parts, 3 * n // GATE_BATCH, got)
        lora = (out / "gate" / "reference_release" / "ppft_trained"
                / "pytorch_lora_weights.safetensors")
        n_lora = len(read_safetensors_header(str(lora))[0])
        gate, ev = parity["gate"], parity["eval_base"]
        print(f"[23] run_parity SD-1.5: message {gate['message']}, gate bit "
              f"accuracy {gate['bit_acc']:.4f} (random weights: printed), "
              f"merge_img_diff {gate['merge_img_diff']:.4f}/255, eval_base "
              f"{ev['n_images']} images bit accuracy {ev['bit_acc']:.4f}; "
              f"the LoRA file holds {n_lora} tensors; launches {got} | "
              f"{smi}", flush=True)
        gate_summary("run_parity SD-1.5 512^2", parts, RES, n, wall,
                     ldm_bytes, smi)
        written = json.loads((out / "PARITY.json").read_text())
        if not (n_lora == GATE_LORA_TENSORS
                and gate["merge_img_diff"] < GATE_MERGE_TOL
                and written == parity and written["gate"] == gate
                and ev["n_images"] == n and len(parts.decoded) == 3
                and parts.v2 == [False]):
            raise AssertionError(f"run_parity failed a check: {parity}, "
                                 f"LoRA tensors {n_lora}, v2 {parts.v2}")
        check_ported_files(out / "gate" / "ported", smi)


def phase23c(smi: str) -> dict:
    """`golden_gate.run` at SD-2.1 768^2 on synthetic release files, with
    the merge workflow's v2 single file.  Returns the forward launches by
    shape."""
    from aqualora_torch.tools import golden_gate
    n = GATE_PROMPTS["sd21"]
    with tempfile.TemporaryDirectory(prefix="aqualora_gate21_") as tmp:
        args = golden_gate.build_argparser().parse_args(
            ["--out", tmp, "--synthetic", "--model", "sd21", "--resolution",
             "768", "--via_merge", "--num_prompts", str(n), "--batch_size",
             str(GATE_BATCH), "--device", "cuda"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        parts = GateParts()
        result, wall, got, by_shape = parts.run(golden_gate.run, args)
        peak = torch.cuda.max_memory_allocated()
        ldm = Path(tmp) / LDM_FILE
        ldm_bytes = ldm.stat().st_size
        ldm.unlink()
        check_gate_calls("[23] golden_gate sd21", parts, 2 * n // GATE_BATCH,
                         got)
        print(f"[23] golden_gate SD-2.1 768^2: message {result['message']}, "
              f"bit accuracy {result['bit_acc']:.4f} (random weights: "
              f"printed), merge_img_diff {result['merge_img_diff']:.4f}/255, "
              f"the single file read back as v2: {parts.v2}; peak device "
              f"memory {peak / 2 ** 30:.4f} GiB; launches {got} | {smi}",
              flush=True)
        gate_summary("golden_gate SD-2.1 768^2", parts, 768, n, wall,
                     ldm_bytes, smi)
        if not (result["merge_img_diff"] < GATE_MERGE_TOL
                and parts.v2 == [True] and result["model"] == "sd21"):
            raise AssertionError(f"golden_gate sd21 failed a check: "
                                 f"{result}, v2 {parts.v2}")
    return by_shape


def kernels_line(rows, launches, bwd_rows, train_launches, inject_row,
                 inject_launches, s1_rows, s1_launches, proto_launches,
                 s3_rows, s3_launches, dist_launches, s21_rows, fid_launches,
                 vit_rows, ds_launches, sd21_768_rows,
                 sd21_768_launches) -> dict:
    kernels = []
    for name, *_ in SHAPES:
        kernels.append({
            "name": f"flash_attention_fwd/{name}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": launches[name], **rows[name]})
    # the auditor's path (phase 16's first run_eval_base) at the protocol's
    # batch
    for key, name, *_ in protocol_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/{key}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": proto_launches[name], **rows[key]})
    # stage 3 at 768^2 (phase 18): the launches of phase 18c's 4 + 2 steps
    for key, h, tq, tk, d, *_ in stage3_shapes(768):
        kernels.append({
            "name": f"flash_attention_fwd/{key}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": s3_launches.get((h, tq, tk, d), 0), **s3_rows[key]})
    # the robustness benchmark (phase 19): the clean set and SDEdit at
    # SD-1.5's protocol shapes (phase 2's rows), SDEdit2 at SD-2.1's B8 ones
    for key, name, h, tq, tk, d, _ in protocol_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/eval_distortion/{name}",
            "route": "cuda", "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": dist_launches.get((h, tq, tk, d), 0), **rows[key]})
    for key, name, h, tq, tk, d, _ in sdedit2_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/{key}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": dist_launches.get((h, tq, tk, d), 0),
            **s21_rows[key]})
    # the fidelity benchmarks (phase 22): run_fid's 50-step generate calls
    # at the protocol's shapes (phase 2's rows), run_dreamsim's ViT shapes
    # (22a's rows) that its DreamSim calls launched
    for key, name, h, tq, tk, d, _ in protocol_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/run_fid/{name}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": fid_launches.get((h, tq, tk, d), 0), **rows[key]})
    for key, h, t, d, _ in vit_shapes():
        if ds_launches.get((h, t, t, d), 0) and key.endswith(
                f"_b{PROTOCOL_IMAGES}"):
            kernels.append({
                "name": f"flash_attention_fwd/{key}", "route": "cuda",
                "source": "aqualora_torch/csrc/flash_fwd.cu",
                "replaces": "aqualora_tpu/ops/flash_attention.py:147",
                "launches": ds_launches[(h, t, t, d)], **vit_rows[key]})
    # SD-2.1 at 768^2 (phase 23): 23a's numbers, 23c's launches
    for key, h, tq, tk, d, *_ in sd21_768_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/{key}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": sd21_768_launches.get((h, tq, tk, d), 0),
            **sd21_768_rows[key]})
    for kern, line in (("dq", 239), ("dkv", 269)):
        for name, *_ in TRAIN_SHAPES:
            kernels.append({
                "name": f"flash_attention_bwd_{kern}/{name}", "route": "cuda",
                "source": "aqualora_torch/csrc/flash_bwd.cu",
                "replaces": f"aqualora_tpu/ops/flash_attention.py:{line}",
                "launches": train_launches[name], **bwd_rows[(kern, name)]})
    kernels.append({
        "name": "secret_inject/train_latent", "route": "cuda",
        "source": "aqualora_torch/csrc/secret_inject.cu",
        "replaces": "aqualora_tpu/ops/secret_inject.py:47",
        "launches": inject_launches, **inject_row})
    # stage 1: the d = 512 instances of each type at the stage-1 batch
    for kern, src, line in (("fwd", "flash_fwd", 147), ("dq", "flash_bwd", 239),
                            ("dkv", "flash_bwd", 269)):
        for tag in ("f32", "bf16"):
            name = ("flash_attention_fwd" if kern == "fwd"
                    else f"flash_attention_bwd_{kern}")
            kernels.append({
                "name": f"{name}/stage1_vae_mid_d512_{tag}", "route": "cuda",
                "source": f"aqualora_torch/csrc/{src}.cu",
                "replaces": f"aqualora_tpu/ops/flash_attention.py:{line}",
                "launches": s1_launches[tag][kern], **s1_rows[(kern, tag)]})
    # a device time the profiler did not measure is null, not NaN
    return {"kernels": [{k: None if isinstance(x, float) and math.isnan(x)
                         else x for k, x in kern.items()}
                        for kern in kernels]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers (default: all; "
                         "phase 0 always runs, and the kernels line needs "
                         "all of them)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    every = set(range(24))
    run_ = every if args.phases is None else \
        {0} | {int(x) for x in args.phases.split(",")}
    if 11 in run_:
        run_.add(3)          # phase 11 profiles phase 3's generate call
    if run_ & {16, 18, 19, 22}:
        run_.add(15)         # phases 16, 18, 19, 22 read phase 15's artifacts
    smi = phase0()
    rows, launches, med_s, serve = {}, {}, 0.0, None
    bwd_rows, inject_row, train_launches, inject_launches = {}, {}, {}, 0
    if 1 in run_:
        phase1()
    if 2 in run_:
        rows = phase2(smi)
    if 3 in run_:
        launches, med_s, serve = phase3(smi)
    if rows and launches:
        per_call = {key: sum(rows[n][key] * launches[n] for n in launches)
                    for key in ("ms", "library_ms", "bound_ms")}
        print(f"[3] flash kernel time per generate call (phase-2 kernel_ms x "
              f"launches): {per_call['ms']:.1f} ms = "
              f"{100 * per_call['ms'] / (med_s * 1e3):.1f}% of the "
              f"{med_s * 1e3:.1f} ms call; sdpa at the same launches "
              f"{per_call['library_ms']:.1f} ms; bound "
              f"{per_call['bound_ms']:.1f} ms | {smi}", flush=True)
    if 4 in run_:
        phase4()
    if 5 in run_:
        bwd_rows = phase5(smi)
    if 6 in run_:
        inject_row = phase6(smi)
    if 7 in run_:
        phase7()
    s1_rows, s1_launches, s1_kept = {}, {}, {}
    if 12 in run_:
        s1_rows = phase12(smi)
    if 13 in run_:
        phase13()
    if 14 in run_:
        s1_launches, s1_kept = phase14(smi)
    step_rate = None
    if 8 in run_:
        train_launches, inject_launches, ppft_kept = phase8(smi)
        step_rate = TRAIN_BATCH / ppft_kept[1]
    proto_launches, s3_rows, s3_launches, s3_kept = {}, {}, {}, []
    dist_launches, s21_rows, f32_rows = {}, {}, {}
    fid_launches, ds_launches, vit_rows = {}, {}, {}
    if 15 in run_:
        with tempfile.TemporaryDirectory(prefix="aqualora_chain_") as tmp:
            out_dir, dpms_s, s1_file, image = phase15(
                smi, med_s if 3 in run_ else None, tmp)
            if 16 in run_:
                proto_launches = phase16(smi, out_dir, tmp, dpms_s)
            if 18 in run_:
                phase18b(tmp)
                s3_launches, s3_tr = phase18c(smi, tmp, s1_file, out_dir,
                                              image)
                s3_kept = phase18d(smi, s3_tr, s1_file, out_dir, tmp)
                del s3_tr
            if 19 in run_:
                torch.cuda.empty_cache()
                dist_launches = phase19d(smi, out_dir, tmp)
            if 22 in run_:
                torch.cuda.empty_cache()
                fid_launches = phase22d(smi, out_dir, tmp)
                ds_launches = phase22e(smi, out_dir)
    if 17 in run_:
        phase17(smi)
    if 18 in run_:
        s3_rows = phase18a(smi)
    if 19 in run_:
        s21_rows = phase19a(smi)
        phase19b()
        phase19c(smi)
        f32_rows = phase19e(smi)
    if 20 in run_:
        p20_tmp = tempfile.TemporaryDirectory(prefix="aqualora_data_")
        p20_kept = phase20(smi, p20_tmp.name, step_rate)
    if 21 in run_:
        with tempfile.TemporaryDirectory(prefix="aqualora_flags_") as tmp:
            p21_opt = phase21(smi, tmp, step_rate)
    if 22 in run_:
        vit_rows = phase22a(smi)
        with tempfile.TemporaryDirectory(prefix="aqualora_fid_") as tmp:
            phase22b(smi, tmp)
        phase22c(smi)
    sd21_768_rows, sd21_768_launches = {}, {}
    if 23 in run_:
        torch.cuda.empty_cache()
        sd21_768_rows = phase23a(smi)
        phase23b(smi)
        sd21_768_launches = phase23c(smi)
        torch.cuda.empty_cache()
    # the profiled phases: the short sessions first, then the profiles of
    # whole steps and of the generate call (see the docstring)
    if 6 in run_:
        phase6_profile(smi)
    if 9 in run_:
        phase9(smi, bwd_rows)
    if 10 in run_:
        phase10(smi, rows)
    if 12 in run_:
        phase12_profile(smi)
    if 18 in run_:
        phase18a_profile(smi, s3_rows)
    if 19 in run_:
        phase19e_profile(smi, f32_rows)
    if 22 in run_:
        phase22a_profile(smi, vit_rows)
    if 23 in run_:
        phase23a_profile(smi, sd21_768_rows)
    if 8 in run_:
        profile_step(*ppft_kept, smi)
        del ppft_kept
        torch.cuda.empty_cache()
    if 14 in run_:
        phase14_profile(smi, s1_kept)
    if 18 in run_:
        phase18_profile(smi, s3_kept)
        del s3_kept
        torch.cuda.empty_cache()
    if 20 in run_:
        phase20_profile(smi, p20_kept)
        p20_tmp.cleanup()
    if 21 in run_:
        phase21_profile(smi, p21_opt)
        del p21_opt
        torch.cuda.empty_cache()
    if 11 in run_:
        phase11(smi, serve, med_s)
    print(f"[end] phases {sorted(run_)} took "
          f"{time.perf_counter() - t_start:.1f} s of the script's run | "
          f"{smi}", flush=True)
    if run_ == every:
        print(json.dumps(kernels_line(rows, launches, bwd_rows,
                                      train_launches, inject_row,
                                      inject_launches, s1_rows, s1_launches,
                                      proto_launches, s3_rows, s3_launches,
                                      dist_launches, s21_rows, fid_launches,
                                      vit_rows, ds_launches, sd21_768_rows,
                                      sd21_768_launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
