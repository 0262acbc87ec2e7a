"""Text -> watermarked image pipeline in PyTorch.

The port of `aqualora_tpu/diffusion/pipeline.py`: the serving path,
img2img (`make_img2img`, the SDEdit attack) and regional generation
(`make_regional_generate`, one message or LoRA per image region): CLIP
encode, the CFG denoise loop of the U-Net under DPM-Solver++(2M)
(`dpms_m`, the default, as in the JAX package) or DDIM, VAE decode.  The
PPFT trainer (`train/ppft_train.py`) drives the same modules, the VAE
encoder included.  The watermark enters through the MapperNet diagonal:
`fold_message(msg)` folds `mapper(msg) * 1.03` into the U-Net's LoRA sites
once (from their float32 base weights, in any compute type), and generation
then runs the plain U-Net.  `load_watermark_lora` reads the LoRA and
MapperNet that the PPFT trainer saves.

Unlike the JAX pipeline, whose parameters travel separately, the weights
live in the modules (`pipe.clip`, `pipe.unet`, `pipe.vae`, `pipe.mapper`) on
`device`, which is "cuda" unless the caller asks for the CPU.  Public
functions keep the JAX package's layouts: latents and images are NHWC, and
images come back in [-1, 1].
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from aqualora_torch.core.config import PipelineConfig
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.core.io import (LORA_FILE, MAPPER_FILE, assign_state,
                                    import_lora_safetensors,
                                    import_te_lora_safetensors,
                                    load_safetensors)
from aqualora_torch.diffusion.samplers import Generators, batch_randn, sample
from aqualora_torch.diffusion.schedule import NoiseSchedule
from aqualora_torch.models.clip import CLIPTextModel
from aqualora_torch.models.lora import (fold_lora_tree, folded_weight,
                                        lora_sites)
from aqualora_torch.models.unet import UNet2DConditionModel
from aqualora_torch.models.vae import AutoencoderKL
from aqualora_torch.models.watermark import MapperNet
from aqualora_torch.ops import quant

_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)


@torch.no_grad()
def init_module_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, the rule of the JAX pipeline's
    `fast_init_params`: ones for norm scales, zeros for biases, N(0, 1/fan_in)
    for everything else, with fan_in the input width (a weight's input
    channels; an embedding table's row count).  BatchNorm statistics start
    at mean 0, variance 1."""
    norm_weights = set()
    for m in module.modules():
        if isinstance(m, _NORMS):
            if m.weight is not None:
                norm_weights.add(id(m.weight))
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    embeddings = {id(m.weight) for m in module.modules()
                  if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        if id(p) in norm_weights:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p.shape[0] if id(p) in embeddings else p.shape[1]
            noise = torch.randn(p.shape, generator=generator,
                                device=generator.device, dtype=torch.float32)
            p.copy_(noise * fan_in ** -0.5)


class StableDiffusionPipeline:
    """CLIP + U-Net + VAE + MapperNet on one device."""

    def __init__(self, config: PipelineConfig, dtype=torch.float32,
                 device: str | torch.device = "cuda", int8=None):
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        # the int8 mode's tokens (`quant.parse_mode`; empty: no int8)
        self.int8 = quant.parse_mode(int8)
        with self.device:
            self.clip = CLIPTextModel(config.clip)
            self.unet = UNet2DConditionModel(config.unet)
            self.vae = AutoencoderKL(config.vae)
            wm = config.watermark
            self.mapper = MapperNet(wm.msg_bits, wm.lora_rank, wm.mapper_std)
        for m in self.modules():
            m.eval().requires_grad_(False)
        # What the JAX package computes from float32 weights under any
        # compute type stays float32 here (every JAX parameter is float32,
        # and flax casts a kernel to the compute type at use): the LoRA and
        # the MapperNet, whose weights take the activation's type at each
        # call; the two conv_out layers flax runs in float32; and the base
        # weights of the U-Net's LoRA sites, cast at each call until a
        # message is folded into them (`fold_diag`), so that the fold rounds
        # once, as JAX's float32 fold cast at use.  Everything else is
        # stored in `dtype`, which is JAX's cast at use done once.  With an
        # int8 mode, the weights of the layers it quantizes stay float32
        # until `quantize_int8` (or `int8_twin`), as JAX quantizes its
        # float32 parameters.
        keep = {id(p) for p in self._float32_parameters()}
        with torch.no_grad():
            for m in self.modules():
                for t in (*m.parameters(), *m.buffers()):
                    if id(t) not in keep and t.is_floating_point():
                        t.data = t.data.to(dtype)
        self.schedule = NoiseSchedule.create(config.schedule, self.device)

    def modules(self):
        return (self.clip, self.unet, self.vae, self.mapper)

    def _float32_parameters(self):
        yield from self.mapper.parameters()
        for m in (*lora_sites(self.clip), *lora_sites(self.unet)):
            yield from m.lora.parameters()
        for m in lora_sites(self.unet):
            yield m.weight
        yield from self.unet.conv_out.parameters()
        yield from self.vae.decoder.conv_out.parameters()
        for m in self._int8_layers():
            yield m.weight

    def _int8_layers(self) -> List[nn.Module]:
        """The layers the int8 mode quantizes (none without one)."""
        return [m for _, m in quant.mode_layers(self.int8, self.unet,
                                                 self.vae)]

    def quantize_int8(self) -> List[str]:
        """Quantize the int8 mode's layers in place, from their float32
        weights (after any fold): `simple_sample`'s int8 modes
        (`aqualora_tpu/eval/utils_eval.py:260-278`) and stage 3's
        `--int8_gen`.  Returns the weight keys quantized."""
        return quant.apply_mode(self.int8, self.unet, self.vae)

    def int8_twin(self) -> nn.Module:
        """The PPFT teacher of `--teacher_int8`: a twin of the U-Net whose
        int8-mode layers hold the codes of their float32 weights and which
        shares every other tensor with it; the U-Net's own weights are then
        cast to the compute type, as the other frozen weights are."""
        t = self.int8
        twin = quant.quantized_copy(
            self.unet, include_convs=bool(t & {"conv", "all"}),
            include_dense=bool(t & {"dense", "all"}))
        lora_ids = {id(m) for m in lora_sites(self.unet)}
        with torch.no_grad():
            for m in self._int8_layers():
                if id(m) not in lora_ids:
                    m.weight.data = m.weight.data.to(self.dtype)
        return twin

    # -- weights -------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights on the device (see init_module_weights)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.modules():
            init_module_weights(m, gen)

    def load_jax_params(self, params: dict) -> None:
        """Load a JAX pipeline's parameter tree ({"text_encoder", "unet",
        "vae", "mapper"}, numpy leaves) strictly, the whole VAE included."""
        for name, module in (("text_encoder", self.clip), ("unet", self.unet),
                             ("vae", self.vae), ("mapper", self.mapper)):
            module.load_state_dict(jax_params_to_torch(params[name]),
                                   strict=True)

    def load_watermark_lora(self, directory: str) -> None:
        """Load the U-Net LoRA and the MapperNet that the PPFT trainer
        saved in `directory` (`pytorch_lora_weights.safetensors` and
        `mapper.safetensors`), strictly, each tensor in its module's type;
        and the text-encoder LoRA when the file has its `text_encoder.`
        keys and the CLIP carries LoRA (a pipeline built without it leaves
        them, as the JAX pipeline does)."""
        state = load_safetensors(os.path.join(directory, LORA_FILE),
                                 self.device)
        import_lora_safetensors(self.unet, self.config.unet, state)
        if lora_sites(self.clip) and any(k.startswith("text_encoder.")
                                         for k in state):
            import_te_lora_safetensors(self.clip, self.config.clip, state)
        assign_state(self.mapper,
                     load_safetensors(os.path.join(directory, MAPPER_FILE),
                                      self.device), what="mapper")

    def load_state_from(self, other: "StableDiffusionPipeline") -> None:
        """Copy another pipeline's weights (any device, same config)."""
        for mine, theirs in zip(self.modules(), other.modules()):
            mine.load_state_dict(theirs.state_dict())

    # -- pieces ----------------------------------------------------------------
    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def encode_prompt(self, input_ids) -> torch.Tensor:
        """token ids [B, 77] -> text embeddings [B, 77, C].  A text tower
        with LoRA applies it at float scale 1.0, as the JAX pipeline does."""
        c = self.config.clip
        te_scale = 1.0 if (c.lora and c.lora.enabled) else None
        return self.clip(self._ids(input_ids), te_scale)

    @torch.no_grad()
    def _decode(self, latents_nchw: torch.Tensor) -> torch.Tensor:
        z = latents_nchw / self.config.vae.scaling_factor
        return self.vae.decode(z).clamp(-1.0, 1.0)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents NHWC -> images NHWC in [-1, 1] (float32)."""
        img = self._decode(latents.to(self.device).permute(0, 3, 1, 2))
        return img.permute(0, 2, 3, 1)

    @torch.no_grad()
    def message_scale(self, msg: torch.Tensor,
                      multiplier: float | None = None) -> torch.Tensor:
        """msg bits [B, N] -> diagonal LoRA scale [B, rank] (x 1.03)."""
        diag = self.mapper(torch.as_tensor(msg, device=self.device))
        if multiplier is None:
            multiplier = self.config.watermark.inference_scale
        return diag * multiplier

    def fold_message(self, msg: torch.Tensor,
                     multiplier: float | None = None) -> None:
        """Fold one message into the U-Net weights, in place (call it once
        per set of weights).  msg: [bits] or [1, bits]."""
        self.fold_diag(self.message_scale(
            torch.as_tensor(msg).reshape(1, -1), multiplier)[0])

    @torch.no_grad()
    def fold_diag(self, diag: torch.Tensor) -> None:
        """Fold a [rank] diagonal into the U-Net's LoRA sites, in place:
        W + alpha * down . diag . up in float32 from the float32 base
        weights, then cast to the compute type, one rounding (JAX's float32
        fold, `aqualora_tpu/models/lora.py:206-232`, cast at use).  The
        float32 base weights go with it, so call it once per set of
        weights."""
        fold_lora_tree(self.unet, diag,
                       alpha_scale=self.config.unet.lora.alpha_scale)
        int8 = {id(m) for m in self._int8_layers()}
        for m in lora_sites(self.unet):
            if id(m) not in int8:       # quantized from float32 instead
                m.weight.data = m.weight.data.to(self.dtype)

    @torch.no_grad()
    def fold_region_weights(self, msg: torch.Tensor,
                            multiplier: float | None = None
                            ) -> Dict[str, torch.Tensor]:
        """One region's U-Net weights for `make_regional_generate`: the
        weights of the U-Net's LoRA sites (192 in SD-1.5) with `msg` folded
        in, keyed by their state-dict names; the only tensors a fold
        changes.  Computed as `fold_diag` computes them (float32 from the
        float32 base weights, the delta summed in float64, one cast to the
        compute type), without touching the pipeline: its U-Net stays
        unfolded, so any number of regions fold from it.  msg: [bits] or
        [1, bits]."""
        if self.int8:
            raise ValueError("regional weights fold float weights; build "
                             "the pipeline without an int8 mode")
        diag = self.message_scale(torch.as_tensor(msg).reshape(1, -1),
                                  multiplier)[0]
        alpha = self.config.unet.lora.alpha_scale
        sites = {id(m) for m in lora_sites(self.unet)}
        return {f"{name}.weight": folded_weight(
                    m, diag, alpha_scale=alpha).to(self.dtype)
                for name, m in self.unet.named_modules() if id(m) in sites}

    def _guided_eps(self, out: torch.Tensor, x2: torch.Tensor,
                    tb: torch.Tensor, guidance_scale: float) -> torch.Tensor:
        """The U-Net's output on the CFG batch [uncond, cond] -> guided eps:
        a v-prediction (SD-2.1) converted to eps first, then
        eps_u + g (eps_c - eps_u)."""
        cfg = self.config
        if cfg.unet.prediction_type == "v_prediction":
            ti = tb.long().clamp(0, cfg.schedule.num_train_timesteps - 1)
            out = self.schedule.velocity_to_epsilon(out, x2.float(), ti)
        eps_u, eps_c = out.chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u)

    # -- the generator -----------------------------------------------------------
    def make_generate(self, num_steps: int = 25, sampler: str = "dpms_m",
                      height: int = 512, width: int = 512):
        """Returns generate(prompt_ids, neg_ids, guidance_scale=7.5,
        lora_scale=None, z=None, generator=None) -> images NHWC in [-1, 1].

        `z` is an optional initial latent [B, h, w, C] (NHWC, as the JAX
        side draws it); without it one is drawn with `generator`, which is
        one `torch.Generator` or a list of B, one per image (row i of the
        latent drawn from generator i alone).
        lora_scale: None (folded or no LoRA) or a [B, rank] diagonal."""
        cfg = self.config
        lh, lw = height // cfg.vae.downscale, width // cfg.vae.downscale

        @torch.no_grad()
        def generate(prompt_ids, neg_ids, guidance_scale: float = 7.5,
                     lora_scale: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None,
                     generator: Generators = None):
            # CFG batch order [uncond, cond]
            context = torch.cat([self.encode_prompt(neg_ids),
                                 self.encode_prompt(prompt_ids)], dim=0)
            b = len(prompt_ids)
            scale2 = (None if lora_scale is None
                      else torch.cat([lora_scale, lora_scale], dim=0))
            if z is None:
                z = batch_randn((b, lh, lw, cfg.unet.in_channels), generator,
                                self.device)
            x = z.to(self.device, torch.float32).permute(0, 3, 1, 2)

            def denoise(x, t):
                x2 = torch.cat([x, x], dim=0).to(self.dtype)
                tb = t.expand(2 * b)
                return self._guided_eps(self.unet(x2, tb, context, scale2),
                                        x2, tb, guidance_scale)

            latents = sample(sampler, self.schedule, denoise, x.contiguous(),
                             num_steps, generator=generator)
            return self._decode(latents).permute(0, 2, 3, 1)

        return generate

    def make_img2img(self, num_steps: int = 10, strength: float = 0.1,
                     height: int = 512, width: int = 512):
        """img2img (SDEdit), the regeneration attack of the eval protocol
        (`aqualora_tpu/diffusion/pipeline.py:226-286`): encode, take a
        posterior sample, noise it to the first of the last
        eff = max(1, int(num_steps * strength)) timesteps of the grid, then
        eff deterministic (DDIM) steps of the CFG U-Net, and decode.

        Returns img2img(images, prompt_ids, neg_ids, guidance_scale=7.5,
        posterior_noise=None, noise=None, generator=None) -> images NHWC
        in [-1, 1].  `images` are NHWC in [-1, 1]; the two draws are NHWC
        latents, drawn from `generator` (one `torch.Generator` or a list
        of B) when not given: the posterior sample's, then the forward
        process's."""
        cfg, schedule = self.config, self.schedule
        lh, lw = height // cfg.vae.downscale, width // cfg.vae.downscale
        eff = max(1, int(num_steps * strength))
        ts = schedule.inference_timesteps(num_steps)[num_steps - eff:]
        # the coefficients as the JAX function takes them: numpy on the
        # float32 alphas_cumprod, then float32
        acp = schedule.alphas_cumprod.cpu().numpy()[ts]
        alpha, sigma = np.sqrt(acp), np.sqrt(1 - acp)
        alpha_n = np.concatenate([alpha[1:], [1.0]]).astype(np.float32)
        sigma_n = np.concatenate([sigma[1:], [0.0]]).astype(np.float32)

        @torch.no_grad()
        def img2img(images, prompt_ids, neg_ids, guidance_scale: float = 7.5,
                    posterior_noise: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    generator: Generators = None):
            context = torch.cat([self.encode_prompt(neg_ids),
                                 self.encode_prompt(prompt_ids)], dim=0)
            b = images.shape[0]
            x = torch.as_tensor(images).to(self.device).permute(0, 3, 1, 2)
            mean, logvar = self.vae.encode_moments(x)
            shape = (b, lh, lw, cfg.vae.latent_channels)
            if posterior_noise is None:
                posterior_noise = batch_randn(shape, generator, self.device)
            if noise is None:
                noise = batch_randn(shape, generator, self.device)
            post = posterior_noise.to(self.device, mean.dtype).permute(
                0, 3, 1, 2)
            z0 = self.vae.sample_from_moments(mean, logvar, post) \
                * cfg.vae.scaling_factor
            x = schedule.add_noise(
                z0.float(), noise.to(self.device, torch.float32).permute(
                    0, 3, 1, 2),
                torch.full((b,), int(ts[0]), device=self.device))
            for i, t in enumerate(ts):
                x2 = torch.cat([x, x], dim=0).to(self.dtype)
                tb = torch.full((2 * b,), float(t), device=self.device)
                # the guidance in the U-Net's type, as JAX's; the step in
                # float32
                eps = self._guided_eps(self.unet(x2, tb, context, None), x2,
                                       tb, guidance_scale).float()
                x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
                x = float(alpha_n[i]) * x0 + float(sigma_n[i]) * eps
            return self._decode(x).permute(0, 2, 3, 1)

        return img2img

    # -- regional multi-message generation ---------------------------------
    def make_regional_generate(self, num_steps: int = 25,
                               sampler: str = "dpms_m", height: int = 512,
                               width: int = 512):
        """Regional generation (`aqualora_tpu/diffusion/pipeline.py:288-394`):
        S regions, each with its own folded weights (a watermark message or
        a LoRA), its own sub-prompt and a spatial mask, compose one image.
        Each denoising step runs the U-Net once per region at the CFG batch
        2B and merges the guided eps predictions with normalized masks, in
        float32:

            eps = sum_s  m_s * eps_s,   m_s = mask_s / (sum_t mask_t + 1e-4)

        Returns regional(region_weights, masks, prompt_ids, neg_ids,
        guidance_scale=7.5, z=None, generator=None) -> images NHWC in
        [-1, 1], where
            region_weights: S dicts of U-Net weights by state-dict name
                (`fold_region_weights`, or `stack_region_params` of state
                dicts); each region's U-Net call takes them in place of the
                module's own (`torch.func.functional_call`), every other
                tensor comes from the module;
            masks: [S, H, W] non-negative weight maps at image resolution,
                resized to the latent's (`resize_masks`);
            prompt_ids: [S, B, 77] one sub-prompt batch per region;
            neg_ids: [B, 77] the negative prompt all regions share;
            z, generator: the initial latent, as `make_generate` takes them.

        The regions run in a Python loop, not under `torch.vmap`: the
        attention kernel's autograd function has no vmap rule, and the loop
        at batch 2B does the work of JAX's vmap (S x 32 forward launches a
        step in SD-1.5)."""
        cfg = self.config
        lh, lw = height // cfg.vae.downscale, width // cfg.vae.downscale

        @torch.no_grad()
        def regional(region_weights: Sequence[Dict[str, torch.Tensor]],
                     masks, prompt_ids, neg_ids, guidance_scale: float = 7.5,
                     z: Optional[torch.Tensor] = None,
                     generator: Generators = None):
            n_regions = len(prompt_ids)
            masks = torch.as_tensor(masks)
            if masks.shape[0] != n_regions or len(region_weights) != n_regions:
                # a count mismatch would otherwise pair masks, prompts and
                # weights of different regions
                raise ValueError(
                    f"{masks.shape[0]} masks and {len(region_weights)} region "
                    f"weights for the {n_regions} regions of prompt_ids")
            ctx_u = self.encode_prompt(neg_ids)
            contexts = [torch.cat([ctx_u, self.encode_prompt(ids)], dim=0)
                        for ids in prompt_ids]
            b = len(neg_ids)
            m = resize_masks(masks.to(self.device), lh, lw)
            m_hat = (m / (m.sum(dim=0, keepdim=True) + 1e-4))[:, None, None]
            if z is None:
                z = batch_randn((b, lh, lw, cfg.unet.in_channels), generator,
                                self.device)
            x = z.to(self.device, torch.float32).permute(0, 3, 1, 2)

            def denoise(x, t):
                x2 = torch.cat([x, x], dim=0).to(self.dtype)
                tb = t.expand(2 * b)
                eps = None
                for weights, context, w in zip(region_weights, contexts,
                                               m_hat):
                    out = functional_call(self.unet, weights,
                                          (x2, tb, context, None))
                    e = self._guided_eps(out, x2, tb, guidance_scale)
                    e = e.float() * w
                    eps = e if eps is None else eps + e
                return eps

            latents = sample(sampler, self.schedule, denoise, x.contiguous(),
                             num_steps, generator=generator)
            return self._decode(latents).permute(0, 2, 3, 1)

        return regional


def resize_masks(masks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Region masks [S, H, W] -> float32 [S, height, width] as
    `jax.image.resize(..., method="bilinear")` computes them: a triangle
    filter with half-pixel centres, widened by the scale when it shrinks
    (antialiased), which torch's antialiased bilinear interpolation is."""
    return F.interpolate(masks.float()[None], size=(height, width),
                         mode="bilinear", align_corners=False,
                         antialias=True)[0]


def stack_region_params(states: Sequence[Dict[str, torch.Tensor]],
                        keep_lora: bool = False
                        ) -> List[Dict[str, torch.Tensor]]:
    """Per-region U-Net state dicts, whole or partial (e.g. `state_dict()`
    of a pipeline folded with each region's message) -> the list
    `make_regional_generate` takes.  The regional U-Net runs with scale
    None, so the LoRA down and up weights a fold keeps are never read: they
    are dropped unless `keep_lora`.  Every region must name the same
    tensors.  (JAX stacks the trees on a leading axis for its vmap; the
    port's regions run in a loop and stay separate.)"""
    if not keep_lora:
        states = [{k: v for k, v in s.items() if ".lora." not in k}
                  for s in states]
    keys = [set(s) for s in states]
    if any(k != keys[0] for k in keys[1:]):
        raise ValueError("the regions' weights name different tensors")
    return list(states)
