"""Text -> watermarked image pipeline in PyTorch.

The port of `aqualora_tpu/diffusion/pipeline.py:33-286` for the serving
path and img2img (`make_img2img`, the SDEdit attack): CLIP encode, the CFG
denoise loop of the U-Net under DPM-Solver++(2M) (`dpms_m`, the default,
as in the JAX package) or DDIM, VAE decode.  The
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
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from aqualora_torch.core.config import PipelineConfig
from aqualora_torch.core.convert import jax_params_to_torch
from aqualora_torch.core.io import (LORA_FILE, MAPPER_FILE, assign_state,
                                    import_lora_safetensors,
                                    import_te_lora_safetensors,
                                    load_safetensors)
from aqualora_torch.diffusion.samplers import Generators, batch_randn, sample
from aqualora_torch.diffusion.schedule import NoiseSchedule
from aqualora_torch.models.clip import CLIPTextModel
from aqualora_torch.models.lora import fold_lora_tree, lora_sites
from aqualora_torch.models.unet import UNet2DConditionModel
from aqualora_torch.models.vae import AutoencoderKL
from aqualora_torch.models.watermark import MapperNet

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
                 device: str | torch.device = "cuda"):
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
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
        # stored in `dtype`, which is JAX's cast at use done once.
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
        for m in lora_sites(self.unet):
            m.weight.data = m.weight.data.to(self.dtype)

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
        v_pred = cfg.unet.prediction_type == "v_prediction"

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
                out = self.unet(x2, tb, context, scale2)
                if v_pred:
                    ti = tb.long().clamp(0, cfg.schedule.num_train_timesteps
                                         - 1)
                    out = self.schedule.velocity_to_epsilon(out, x2.float(),
                                                            ti)
                eps_u, eps_c = out.chunk(2, dim=0)
                return eps_u + guidance_scale * (eps_c - eps_u)

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
        v_pred = cfg.unet.prediction_type == "v_prediction"

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
                out = self.unet(x2, tb, context, None)
                if v_pred:
                    ti = tb.long().clamp(0, cfg.schedule.num_train_timesteps
                                         - 1)
                    out = schedule.velocity_to_epsilon(out, x2.float(), ti)
                # the guidance in the U-Net's type, as JAX's; the step in
                # float32
                eps_u, eps_c = out.chunk(2, dim=0)
                eps = (eps_u + guidance_scale * (eps_c - eps_u)).float()
                x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
                x = float(alpha_n[i]) * x0 + float(sigma_n[i]) * eps
            return self._decode(x).permute(0, 2, 3, 1)

        return img2img
