"""The port's dryrun entry points, the counterpart of `__graft_entry__.py`.

entry(device)         -> (fn, args): the SD-1.5 U-Net forward with the
                         rank-320 watermark LoRA in bf16 at a CFG batch of
                         2 on 64^2 latents, on the card (`tiny=True`: the
                         tiny configuration, for the CPU).
dryrun_multichip(n)   -> spawns n processes (one torch thread each, gloo on
                         the CPU, a file rendezvous in a temporary
                         directory) and runs the four legs of the JAX
                         dryrun (`__graft_entry__.py:94-302`) on the tiny
                         configuration:
  1. one PPFT step on a data x model mesh (model = 2 when n is even and at
     least 4), the batch over `data`, the U-Net's attention and
     feed-forward sites Megatron-sharded over `model`
     (`parallel/partition.py`), the LoRA-up and SecretEncoder-conv weights
     perturbed from their zero init (`perturb_zero_init`) so that the loss
     and every gradient through the all-reduce are real: it asserts a
     finite positive loss and gradient norm;
  2. the same step with `--fsdp`'s layout (the frozen towers sharded with
     FSDP2 over `data`, the moments ZeRO-1), whose loss must equal leg 1's
     within 1e-5 relative;
  3. one stage-1 step (encoder and decoder through the VAE and noiser,
     BatchNorm over the global batch), asserting a positive loss and
     message loss;
  4. one stage-3 decoder step, asserting a positive loss.

Run:  python -m aqualora_torch.parallel.dryrun [n] [--entry] [--device D]

On the card by default (`--entry`: the full-width forward; the dryrun:
NCCL, a card a rank, refused when fewer cards are visible); `--device
cpu` runs the dryrun over gloo and `--entry` at the tiny configuration.

The workers live here, not in a test module: a spawned child imports its
target's module, and the tests import JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

RES = 32
# --lora_dropout and --module_dropout of the 2-rank dropout check
DROPOUTS = (0.25, 0.25)


def entry(device: str | torch.device = "cuda", tiny: bool = False
          ) -> Tuple:
    """-> (fn, args) with fn(*args) the U-Net forward (eps prediction,
    float32 NCHW): SD-1.5 at rank 320 in bf16 on `device` (the tiny
    configuration with `tiny`), latents [2, 4, 64, 64] (8 x 8 for the
    tiny one), timesteps, a CLIP-width context and an all-ones diagonal.
    Seeded random weights."""
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline

    cfg = PipelineConfig.tiny() if tiny else PipelineConfig.sd15(
        lora_rank=320)
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device=device)
    pipe.init_params(0)
    b, lat = 2, (8 if tiny else 64)
    dev = pipe.device
    latents = torch.zeros((b, cfg.unet.in_channels, lat, lat),
                          dtype=torch.bfloat16, device=dev)
    t = torch.zeros((b,), dtype=torch.float32, device=dev)
    ctx = torch.zeros((b, 77, cfg.unet.cross_attention_dim),
                      dtype=torch.bfloat16, device=dev)
    diag = torch.ones((b, cfg.unet.lora.rank), dtype=torch.float32,
                      device=dev)

    @torch.no_grad()
    def fn(latents, t, ctx, diag):
        return pipe.unet(latents, t, ctx, diag)

    return fn, (latents, t, ctx, diag)


# ---------------------------------------------------------------------------
# the steps (run in every rank)
# ---------------------------------------------------------------------------

def _tiny_ppft(device, inputs: dict | None = None,
               dropouts: Tuple[float, float] = (0.0, 0.0)):
    """The tiny pipeline and SecretEncoder at 32 px: on JAX's weights
    (`inputs` "params" and "sec", JAX trees of numpy leaves), or seeded
    with the zero-init leaves perturbed (`perturb_zero_init`: with the
    zero LoRA ups and encoder conv the loss and every gradient are 0);
    `dropouts` the U-Net LoRA's kohya (elementwise, module) dropouts ->
    (pipe, sec, trainable groups)."""
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core.convert import jax_params_to_torch
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretEncoder
    from aqualora_torch.tools.synthetic_artifacts import perturb_zero_init
    from aqualora_torch.train import ppft_train as pt

    cfg = PipelineConfig.tiny()
    if any(dropouts):
        rep_ = dataclasses.replace
        cfg = rep_(cfg, unet=rep_(cfg.unet, lora=rep_(
            cfg.unet.lora, dropout=dropouts[0],
            module_dropout=dropouts[1])))
    pipe = StableDiffusionPipeline(cfg, device=device)
    wm = cfg.watermark
    with torch.device(device):
        sec = SecretEncoder(wm.msg_bits, wm.secret_grid,
                            RES // cfg.vae.downscale, cfg.vae.latent_channels)
    if inputs is not None:
        pipe.load_jax_params(inputs["params"])
        sec.load_state_dict(jax_params_to_torch(inputs["sec"]), strict=True)
    else:
        pipe.init_params(0)
        lora = pt.split_lora(pipe.unet)[1]
        with torch.no_grad():
            for k, v in perturb_zero_init(
                    {k: p.detach() for k, p in lora.items()}).items():
                lora[k].copy_(v)
        init_module_weights(sec.secret_dense,
                            torch.Generator(device=device).manual_seed(1))
        sec.load_state_dict(perturb_zero_init(sec.state_dict(), seed=1))
    sec.requires_grad_(False)
    return pipe, sec, pt.trainable_groups(pipe)


def _seeded_batch(pipe, b: int, seed: int = 0):
    """A global batch of `b` seeded images, ids and the step's draws."""
    from aqualora_torch.train import ppft_train as pt

    pixels = np.random.default_rng(seed).uniform(
        -1, 1, (b, RES, RES, 3)).astype(np.float32)
    gen = torch.Generator(device=pipe.device).manual_seed(seed + 1)
    return pixels, np.ones((b, 77), np.int64), pt.draw(pipe, gen, pixels)


def _trainables(pipe) -> Dict[str, torch.Tensor]:
    from aqualora_torch.train import ppft_train as pt

    out = {k: p.detach().clone()
           for k, p in pt.split_lora(pipe.unet)[1].items()}
    out["bit_embeddings.weight"] = \
        pipe.mapper.bit_embeddings.weight.detach().clone()
    return out


def ppft_update(models, mesh, mode: str, batches, lr: float = 1e-4) -> dict:
    """PPFT updates of `models` ((pipe, sec, groups), `_tiny_ppft`) on
    `mesh`, one a global batch of `batches` ([(pixels NHWC, ids, Draws)]),
    this data rank's rows: `mode` "unwrapped" (no group), "dp" (data
    parallel), "fsdp" (`--fsdp`'s layout) or "tp" (the U-Net sharded over
    `model`); AdamW at `lr`, warm-up 0, the cosine over 10 updates.  -> the
    losses, gradient norms, the updated LoRA and mapper, and under "fsdp"
    the share of the frozen bytes and of the optimizer moments this rank
    holds."""
    from aqualora_torch.core import sharding as sh
    from aqualora_torch.parallel.partition import (shard_params,
                                                   unet_partition_specs)
    from aqualora_torch.train import ppft_train as pt

    pipe, sec, groups = models
    data, _ = sh.mesh_shape(mesh)
    group = None if mode == "unwrapped" else sh.data_group(mesh)
    if mode == "fsdp":
        pt.shard_towers(pipe, sec, None, mesh)
    elif mode == "tp":
        shard_params(mesh, pipe.unet, unet_partition_specs(pipe.unet))
    optimizer, scheduler = pt.make_optimizer(
        groups, lr, 0, 10, zero_group=group if mode == "fsdp" else None)
    step = pt.make_train_step(pipe, sec, optimizer, scheduler, 1.0,
                              group=group)
    rank = sh.group_rank(group)
    out = {"loss": [], "grad_norm": []}
    for pixels, ids, draws in batches:
        m = step(sh.shard_batch(pixels, rank, data),
                 sh.shard_batch(ids, rank, data), draws.shard(rank, data))
        out["loss"].append(float(m["ppft_loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _trainables(pipe)
    if mode == "fsdp":
        frozen = [p for m in (pipe.unet, pipe.vae, pipe.clip, sec)
                  for p in m.parameters() if not p.requires_grad]
        full = sum(p.numel() * p.element_size() for p in frozen)
        out["frozen_share"] = sh.local_bytes(frozen) / full
        moments = [t for st in optimizer.optim.state.values()
                   for t in st.values() if torch.is_tensor(t) and t.dim()]
        mine = torch.tensor(float(sum(t.numel() * t.element_size()
                                      for t in moments)), device=pipe.device)
        total = mine.clone()
        dist.all_reduce(total)
        out["moment_share"] = float(mine / total)
    return out


def stage_updates(group, device="cpu", b: int = 4) -> dict:
    """One stage-1 and one stage-3 update of the tiny models (seeded
    weights, a global batch of `b` at 64 px, the draws of the global
    batch, this data rank's rows of `group`; None: one process), under SGD
    as JAX's equivalence test (an MBConv's projection bias has an
    analytically zero gradient whose rounding noise Adam's first step
    would blow up to the learning rate) -> {"stage1", "stage3"}: each the
    metrics and the updated state dict, BatchNorm statistics included."""
    from aqualora_torch.core import sharding as sh
    from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                            WatermarkConfig)
    from aqualora_torch.diffusion.pipeline import init_module_weights
    from aqualora_torch.distort.noiser import Stage3Noiser
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.train import latent_wm_pretrain as s1
    from aqualora_torch.train import rob_enhance_finetune as s3

    n, rank = sh.group_size(group), sh.group_rank(group)
    res = 64

    def sgd(params):
        opt = torch.optim.SGD(params, lr=1e-3)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)

    models = s1.build_models(VAEConfig.tiny(), WatermarkConfig.tiny(),
                             EfficientNetConfig.tiny(), device)
    s1.init_models(models, 0)
    with torch.no_grad():       # a live encoder conv: a watermark to see
        models.sec_encoder.conv_out.weight.normal_(
            0.0, 0.05, generator=torch.Generator(device).manual_seed(3))
    opt, sched = sgd([p for ps in s1.trainables(models).values()
                      for p in ps])
    step = s1.make_train_step(models, opt, sched, group=group)
    pixels = np.random.default_rng(1).uniform(
        -1, 1, (b, res, res, 3)).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(5)
    ctl = s1.Control()
    d = s1.draw(models, gen, (b, 3, res, res), ctl.distort_probs)
    m1 = step(sh.shard_batch(pixels, rank, n), d.shard(rank, n), ctl)
    state1 = {f"sec_encoder.{k}": v.detach().clone() for k, v in
              models.sec_encoder.state_dict().items()}
    state1.update({f"sec_decoder.{k}": v.detach().clone() for k, v in
                   models.sec_decoder.state_dict().items()})

    wm = WatermarkConfig.tiny()
    dec = SecretDecoder(wm.msg_bits, EfficientNetConfig.tiny(), device=device)
    init_module_weights(dec, torch.Generator(device=device).manual_seed(0))
    dec.requires_grad_(True)
    opt, sched = sgd(list(dec.parameters()))
    dstep = s3.make_decoder_step(dec, opt, sched, group)
    rng = np.random.default_rng(4)
    images01 = torch.from_numpy(rng.uniform(0, 1, (b, 3, res, res)).astype(
        np.float32)).to(device)
    msg = torch.from_numpy((rng.uniform(size=(b, wm.msg_bits)) > 0.5)
                           .astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(11)
    noise = Stage3Noiser().draw(gen, (b, 3, res, res), (0, 0, 1.0, 0, 0))
    masks = dec.model.draw_masks(b, gen)
    m3 = dstep(sh.shard_batch(images01, rank, n),
               sh.shard_batch(msg, rank, n), noise.shard(b, rank, n),
               masks.shard(rank, n))
    return {"stage1": {"metrics": {k: float(v) for k, v in m1.items()},
                       "state": state1},
            "stage3": {"metrics": {k: float(v) for k, v in m3.items()},
                       "state": {k: v.detach().clone() for k, v in
                                 dec.state_dict().items()}}}


def run_legs(device="cpu") -> Dict[str, float]:
    """The four legs in this rank of an initialised world; raises
    AssertionError on a degenerate or diverging leg."""
    from aqualora_torch.core import sharding as sh

    n = dist.get_world_size()
    model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = sh.make_mesh(model=model)
    data = n // model
    models = _tiny_ppft(device)
    batches = [_seeded_batch(models[0], 2 * n)]
    dp = ppft_update(models, mesh, "tp" if model > 1 else "dp", batches)
    loss, grad_norm = dp["loss"][0], dp["grad_norm"][0]
    assert np.isfinite(loss) and loss > 0, f"degenerate dryrun: loss {loss}"
    assert np.isfinite(grad_norm) and grad_norm > 0, \
        f"degenerate dryrun: grad_norm {grad_norm}"
    fs = ppft_update(_tiny_ppft(device), mesh, "fsdp", batches)["loss"][0]
    assert np.isfinite(fs) and abs(fs - loss) <= 1e-5 * max(1.0, loss), \
        f"FSDP leg diverges: {fs} vs {loss}"
    st = stage_updates(sh.data_group(mesh), device, b=2 * data)
    s1_loss, s1_msg = (st["stage1"]["metrics"][k] for k in ("loss",
                                                            "msgloss"))
    s3_loss = st["stage3"]["metrics"]["loss"]
    assert np.isfinite(s1_loss) and s1_loss > 0, f"stage 1 loss {s1_loss}"
    assert np.isfinite(s1_msg) and s1_msg > 0, f"stage 1 msgloss {s1_msg}"
    assert np.isfinite(s3_loss) and s3_loss > 0, f"stage 3 loss {s3_loss}"
    return {"ppft_loss": loss, "grad_norm": grad_norm, "fsdp_loss": fs,
            "stage1_loss": s1_loss, "stage1_msgloss": s1_msg,
            "stage3_loss": s3_loss, "data": data, "model": model}


# ---------------------------------------------------------------------------
# the cross-checks: updates of several ranks, for comparison with one
# process (the port's) or one JAX mesh
# ---------------------------------------------------------------------------

def resume_check(tmp: str, device="cpu") -> dict:
    """Two `--fsdp` PPFT runs through `ppft_train.run` from a perturbed
    LoRA: two steps straight, and one step with a checkpoint then a
    resumed second step -> both runs' LoRA and mapper and second-step
    metrics.  A constant learning rate (the cosine's length is each run's
    step count)."""
    from aqualora_torch.core import sharding as sh
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.tools.synthetic_artifacts import perturb_zero_init
    from aqualora_torch.train import ppft_train as pt

    lora_dir = os.path.join(tmp, "lora")
    if sh.is_main_process():
        cfg = PipelineConfig.tiny()
        pipe = StableDiffusionPipeline(cfg, device=device)
        pipe.init_params(0)
        lora = pt.split_lora(pipe.unet)[1]
        with torch.no_grad():
            for k, v in perturb_zero_init(
                    {k: p.detach() for k, p in lora.items()}).items():
                lora[k].copy_(v)
        pt.save_artifacts(lora_dir, pipe, SecretDecoder(
            cfg.watermark.msg_bits, device=device))
    sh.barrier()
    base = ["--tiny", "--train_batch_size", "4", "--device", str(device),
            "--fsdp", "--report_to", "none", "--lr_warmup_steps", "0",
            "--lr_end", "1", "--resume_from_lora", lora_dir,
            "--checkpointing_steps", "1"]
    parse = pt.build_argparser().parse_args
    straight = pt.run(parse(base + ["--max_train_steps", "2", "--output_dir",
                                    os.path.join(tmp, "straight")]))
    part = os.path.join(tmp, "part")
    pt.run(parse(base + ["--max_train_steps", "1", "--output_dir", part]))
    resumed = pt.run(parse(base + ["--max_train_steps", "2", "--output_dir",
                                   part, "--resume_from_checkpoint",
                                   "latest"]))
    return {"straight": _trainables(straight["trainer"].pipe),
            "resumed": _trainables(resumed["trainer"].pipe),
            "straight_metrics": straight["history"][-1],
            "resumed_metrics": resumed["history"][-1],
            "resumed_start": resumed["start_step"]}


def parity_worker(rank: int, n: int, rendezvous: str, inputs_path: str,
                  out_path: str) -> None:
    """A rank of the 2-rank cross-checks: the PPFT update data parallel,
    under `--fsdp` and tensor parallel (1 x 2), the data-parallel update
    with the kohya dropouts on beside the one-process update on the same
    draws, the stage-1 and stage-3 updates, the `--fsdp` resume, and the
    refusal of a batch the world does not divide.  Rank 0 saves the
    results to `out_path`."""
    from aqualora_torch.core import sharding as sh
    from aqualora_torch.train import ppft_train as pt

    dev = init_worker(rank, n, rendezvous)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        batches = [(inputs["pixels"], inputs["ids"],
                    pt.Draws(**inputs["draws"]))]
        out = {mode: ppft_update(_tiny_ppft(dev, inputs), mesh, mode,
                                 batches, inputs["lr"])
               for mode, mesh in (("dp", sh.make_mesh()),
                                  ("fsdp", sh.make_mesh()),
                                  ("tp", sh.make_mesh(1, n)))}
        models = _tiny_ppft(dev, dropouts=DROPOUTS)
        batches = [_seeded_batch(models[0], 4, seed=3)]
        sites = batches[0][2].unet_sites
        out["dropout"] = {
            "dp": ppft_update(models, sh.make_mesh(), "dp", batches),
            "one": ppft_update(_tiny_ppft(dev, dropouts=DROPOUTS), None,
                               "unwrapped", batches),
            "sites": len(sites.seeds), "kept": int(sites.keep.sum())}
        out.update(stage_updates(sh.data_group(), dev))
        try:
            pt.build_trainer(pt.build_argparser().parse_args(
                ["--tiny", "--train_batch_size", "3", "--device", "cpu"]))
        except ValueError as e:
            out["refusal"] = str(e)
        with tempfile.TemporaryDirectory() as tmp:
            # every rank's directory must be the same one: rank 0's
            names = [tmp]
            dist.broadcast_object_list(names, src=0)
            out["resume"] = resume_check(names[0], dev)
            sh.barrier()
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def card_step_worker(rank: int, n: int, rendezvous: str, out_path: str
                     ) -> None:
    """A one-rank NCCL group on the card (file rendezvous): two steps of
    the tiny PPFT trainer in float32 (TF32 off) unwrapped (no group, twice:
    the card's backward is not bit-reproducible), data parallel (the
    gradients through NCCL) and with `--fsdp`'s layout (FSDP2 and ZeRO-1
    on one rank), each from the same perturbed weights and inputs; saves
    the losses and the LoRA and mapper of each."""
    from aqualora_torch.core import sharding as sh

    dev = init_worker(rank, n, rendezvous, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {"backend": dist.get_backend()}
        for mode in ("unwrapped", "again", "dp", "fsdp"):
            models = _tiny_ppft(dev)
            batches = [_seeded_batch(models[0], 4, seed) for seed in (0, 2)]
            out[mode] = ppft_update(
                models, sh.make_mesh(), "unwrapped" if mode == "again"
                else mode, batches)
            out[mode]["params"] = {k: v.cpu() for k, v in
                                   out[mode]["params"].items()}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def init_worker(rank: int, n: int, rendezvous: str, device: str = "cpu"
                ) -> torch.device:
    """A spawned rank: one torch thread, the default group through the
    file `rendezvous` (gloo on the CPU, NCCL on `cuda:rank`)."""
    torch.set_num_threads(1)
    dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=n)
    return dev


def _dryrun_worker(rank: int, n: int, rendezvous: str, device: str,
                   out: str) -> None:
    dev = init_worker(rank, n, rendezvous, device)
    try:
        result = run_legs(dev)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


class Spawned:
    """fn(rank, n, rendezvous, *args) running in n spawned processes (one
    a rank); `join` waits for them and raises when one failed or they
    outlive the timeout (then they are killed).  The rendezvous is a file
    in a new temporary directory, so concurrent runs on one host do not
    meet."""

    def __init__(self, fn, n: int, *args):
        import torch.multiprocessing as mp

        self.name, self.n = fn.__name__, n
        self._tmp = tempfile.TemporaryDirectory()
        self._ctx = mp.start_processes(
            fn, args=(n, os.path.join(self._tmp.name, "rdzv"), *args),
            nprocs=n, join=False, start_method="spawn")

    def join(self, timeout: float = 900.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        try:
            while not self._ctx.join(
                    timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    for p in self._ctx.processes:
                        p.kill()
                    raise TimeoutError(f"{self.name}: {self.n} ranks still "
                                       f"running after {timeout} s")
        finally:
            self._tmp.cleanup()


def spawn(fn, n: int, *args, timeout: float = 900.0) -> None:
    """Run fn(rank, n, rendezvous, *args) in n spawned processes and wait
    (`Spawned`)."""
    Spawned(fn, n, *args).join(timeout)


def dryrun_multichip(n: int = 2, device: str = "cpu") -> Dict[str, float]:
    """The four legs in `n` spawned ranks (see the module docstring);
    -> rank 0's numbers.  On the card each rank takes a card of its own
    (NCCL), so `n` may not exceed the visible cards."""
    if device != "cpu" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards under NCCL, "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pt")
        spawn(_dryrun_worker, n, device, out)
        result = torch.load(out)
    print(f"dryrun_multichip({n}): " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()) + " OK", flush=True)
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="ranks of the dryrun (default 2)")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, a card a rank; the default) or cpu "
                        "(gloo)")
    p.add_argument("--entry", action="store_true",
                   help="run entry() once on --device instead")
    args = p.parse_args(argv)
    if args.entry:
        fn, fargs = entry(args.device, tiny=args.device == "cpu")
        out = fn(*fargs)
        print(f"entry OK: {tuple(out.shape)} {out.dtype}", flush=True)
        return
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
