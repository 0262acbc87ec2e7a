"""Samplers.  DDIM is ported; the other eleven of the JAX package's menu
(`aqualora_tpu/diffusion/samplers.py`) are not yet.

Interface: sample_ddim(schedule, denoise, z, num_steps, generator, eta)
  denoise(x_t, t) -> epsilon prediction (CFG applied); t is a 0-dim float32
  tensor on x's device.  Returns the final x0-space latent.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from aqualora_torch.diffusion.schedule import NoiseSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _grid(schedule: NoiseSchedule, num_steps: int,
          spacing: str = "leading", final_alpha_one: bool = True):
    """Descending timesteps + alpha/sigma arrays with the x0 boundary row.

    `final_alpha_one=False` is the config's `set_alpha_to_one: false`
    (SD-1.5 ships it): the final boundary uses alphas_cumprod[0]
    (~0.99915), not 1.0."""
    ts = np.asarray(schedule.inference_timesteps(num_steps, spacing))
    acp_full = schedule.alphas_cumprod.cpu().numpy()
    if ts.dtype.kind == "f":
        s_full = np.sqrt((1.0 - acp_full) / acp_full)
        s = np.interp(ts, np.arange(len(s_full)), s_full)
        acp = 1.0 / (1.0 + s ** 2)
    else:
        acp = acp_full[ts]
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    final_acp = 1.0 if final_alpha_one else float(acp_full[0])
    alpha_n = np.concatenate([alpha[1:], [np.sqrt(final_acp)]])
    sigma_n = np.concatenate([sigma[1:], [np.sqrt(1.0 - final_acp)]])
    return ts, alpha, sigma, alpha_n, sigma_n


def sample_ddim(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                num_steps: int, generator: Optional[torch.Generator] = None,
                eta: float = 0.0) -> torch.Tensor:
    # SD-1.5 config: set_alpha_to_one=false -> final boundary acp[t=0]
    ts, alpha, sigma, alpha_n, _ = _grid(schedule, num_steps,
                                         final_alpha_one=False)
    # DDIM variance (Song et al. 2020, eq. 16)
    acp, acp_n = alpha ** 2, alpha_n ** 2
    var = (eta ** 2) * (1 - acp_n) / (1 - acp) * (1 - acp / acp_n)
    var = np.clip(var, 0.0, None)
    dir_coeff = np.sqrt(np.clip(1.0 - acp_n - var, 0.0, None))
    # float32 coefficients, as the JAX sampler gathers them
    ts_f, a, s, an, dn, vn = (np.asarray(c, np.float32) for c in
                              (ts, alpha, sigma, np.sqrt(acp_n), dir_coeff,
                               np.sqrt(var)))
    x = z
    for i in range(num_steps):
        t = torch.tensor(ts_f[i], dtype=torch.float32, device=z.device)
        eps = denoise(x, t)
        x0 = (x - float(s[i]) * eps) / float(a[i])
        x = float(an[i]) * x0 + float(dn[i]) * eps
        if eta > 0:
            x = x + float(vn[i]) * torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x


SAMPLERS = {"ddim": sample_ddim}
