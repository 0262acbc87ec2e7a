"""DDPM forward-process schedule: precomputed coefficients as tensors.

The port of `aqualora_tpu/diffusion/schedule.py:33-162`.  `betas` and
`alphas_cumprod` are float32 tensors on the schedule's device (computed in
float64 with numpy first, as the JAX side does); every operation is a
function of (schedule, tensors, integer timesteps [B]).
"""

from __future__ import annotations

import numpy as np
import torch

from aqualora_torch.core.config import ScheduleConfig


def _broadcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-sample coefficient [B] reshaped to [B, 1, 1, ...] like `like`."""
    return coef.reshape(coef.shape + (1,) * (like.dim() - coef.dim())
                        ).to(like.dtype)


class NoiseSchedule:
    def __init__(self, betas: torch.Tensor, alphas_cumprod: torch.Tensor,
                 config: ScheduleConfig):
        self.betas = betas
        self.alphas_cumprod = alphas_cumprod
        self.config = config

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(config: ScheduleConfig | None = None,
               device: str | torch.device = "cuda") -> "NoiseSchedule":
        cfg = config or ScheduleConfig()
        T = cfg.num_train_timesteps
        if cfg.beta_schedule == "linear":
            betas = np.linspace(cfg.beta_start, cfg.beta_end, T,
                                dtype=np.float64)
        elif cfg.beta_schedule == "scaled_linear":
            betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T,
                                dtype=np.float64) ** 2
        elif cfg.beta_schedule == "squaredcos_cap_v2":
            t = np.arange(T + 1, dtype=np.float64) / T
            f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
            betas = np.clip(1.0 - f[1:] / f[:-1], 0.0, 0.999)
        else:
            raise ValueError(f"unknown beta_schedule {cfg.beta_schedule}")
        alphas_cumprod = np.cumprod(1.0 - betas)
        as_t = lambda a: torch.tensor(a.astype(np.float32), device=device)
        return NoiseSchedule(as_t(betas), as_t(alphas_cumprod), cfg)

    # -- coefficient lookups -----------------------------------------------
    def sqrt_alpha_prod(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod[t])

    def sqrt_one_minus_alpha_prod(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod[t])

    def snr_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """sqrt(acp) / sqrt(1 - acp)."""
        return self.sqrt_alpha_prod(t) / self.sqrt_one_minus_alpha_prod(t)

    # -- forward process ----------------------------------------------------
    def add_noise(self, x0, noise, t):
        """x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps."""
        a = _broadcast(self.sqrt_alpha_prod(t), x0)
        s = _broadcast(self.sqrt_one_minus_alpha_prod(t), x0)
        return a * x0 + s * noise

    def subtract_noise(self, xt, noise, t):
        """x0 = (x_t - sqrt(1 - acp) eps) / sqrt(acp)."""
        a = _broadcast(self.sqrt_alpha_prod(t), xt)
        s = _broadcast(self.sqrt_one_minus_alpha_prod(t), xt)
        return (xt - s * noise) / a

    # -- prediction-type conversions ----------------------------------------
    def velocity_to_epsilon(self, v, xt, t):
        """eps = sqrt(acp) v + sqrt(1 - acp) x_t."""
        a = _broadcast(self.sqrt_alpha_prod(t), xt)
        s = _broadcast(self.sqrt_one_minus_alpha_prod(t), xt)
        return a * v + s * xt

    def get_velocity(self, x0, noise, t):
        """v = sqrt(acp) eps - sqrt(1 - acp) x0."""
        a = _broadcast(self.sqrt_alpha_prod(t), x0)
        s = _broadcast(self.sqrt_one_minus_alpha_prod(t), x0)
        return a * noise - s * x0

    def pred_original(self, model_out, xt, t, prediction_type=None):
        """x0 estimate from a model output under eps / v / sample prediction."""
        kind = prediction_type or self.config.prediction_type
        a = _broadcast(self.sqrt_alpha_prod(t), xt)
        s = _broadcast(self.sqrt_one_minus_alpha_prod(t), xt)
        if kind == "epsilon":
            return (xt - s * model_out) / a
        if kind == "v_prediction":
            return a * xt - s * model_out
        if kind == "sample":
            return model_out
        raise ValueError(f"unknown prediction_type {kind}")

    def to_epsilon(self, model_out, xt, t, prediction_type=None):
        """Normalize any prediction type to an epsilon prediction."""
        kind = prediction_type or self.config.prediction_type
        if kind == "epsilon":
            return model_out
        if kind == "v_prediction":
            return self.velocity_to_epsilon(model_out, xt, t)
        if kind == "sample":
            a = _broadcast(self.sqrt_alpha_prod(t), xt)
            s = _broadcast(self.sqrt_one_minus_alpha_prod(t), xt)
            return (xt - a * model_out) / s
        raise ValueError(f"unknown prediction_type {kind}")

    # -- inference timestep grids -------------------------------------------
    def inference_timesteps(self, num_steps: int,
                            spacing: str = "leading") -> np.ndarray:
        """Descending timestep grid for samplers (host-side numpy):
          'leading'        : stride grid + steps_offset (DDIM/PNDM/DDPM)
          'linspace_round' : linspace(0, T-1, N+1).round()[::-1][:-1]
          'linspace'       : linspace(0, T-1, N) float points"""
        T = self.config.num_train_timesteps
        if spacing == "leading":
            stride = T // num_steps
            ts = ((np.arange(num_steps) * stride)[::-1]
                  + self.config.steps_offset)
            return np.clip(ts, 0, T - 1).astype(np.int32)
        if spacing == "linspace_round":
            ts = np.linspace(0, T - 1, num_steps + 1).round()[::-1][:-1]
            return ts.astype(np.int32)
        if spacing == "linspace":
            return np.linspace(0, T - 1, num_steps,
                               dtype=np.float32)[::-1].copy()
        raise ValueError(f"unknown timestep spacing {spacing!r}")
