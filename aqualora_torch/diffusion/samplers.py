"""Samplers: DDIM and DPM-Solver++(2M) (`dpms_m`); the other ten of the
JAX package's menu (`aqualora_tpu/diffusion/samplers.py`) are not ported
yet.

Interface: sample(name, schedule, denoise, z, num_steps, generator, eta)
  denoise(x_t, t) -> epsilon prediction (CFG applied); t is a 0-dim float32
  tensor on x's device.  Returns the final x0-space latent.

Every coefficient is computed once on the host in numpy and rounded to
float32, as the JAX samplers gather theirs, so a step makes no host sync.

`generator` is one `torch.Generator` or a list of them, one per image (the
counterpart of the JAX key stacks, `samplers.py:53-92`): with a list, row i
of every draw comes from generator i alone, so image i does not depend on
how a prompt list is cut into batches.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from aqualora_torch.diffusion.schedule import NoiseSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def batch_randn(shape, generator: Generators, device, dtype=torch.float32
                ) -> torch.Tensor:
    """N(0, 1) of `shape`; a list of generators draws row i from generator
    i (`batch_normal`)."""
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of "
                         f"{shape[0]}")
    return torch.cat([torch.randn((1, *shape[1:]), generator=g, device=device,
                                  dtype=dtype) for g in generator])


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


def _f32(*arrays):
    return tuple(np.asarray(a, np.float32) for a in arrays)


def _t(ts_f: np.ndarray, i: int, device) -> torch.Tensor:
    return torch.tensor(ts_f[i], dtype=torch.float32, device=device)


def sample_ddim(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                num_steps: int, generator: Generators = None,
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
    ts_f, a, s, an, dn, vn = _f32(ts, alpha, sigma, np.sqrt(acp_n),
                                  dir_coeff, np.sqrt(var))
    x = z
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        x = float(an[i]) * x0 + float(dn[i]) * eps
        if eta > 0:
            x = x + float(vn[i]) * batch_randn(x.shape, generator, x.device,
                                               x.dtype)
    return x


def _lambda_grids(schedule: NoiseSchedule, num_steps: int):
    """diffusers 0.24.0's DPM grids (`samplers.py:403-415`) on the
    linspace_round spacing: the final boundary is alphas_cumprod[0], not
    sigma = 0; lambda = log(alpha / sigma)."""
    ts, alpha, sigma, alpha_n, sigma_n = _grid(schedule, num_steps,
                                               spacing="linspace_round",
                                               final_alpha_one=False)
    lam = np.log(alpha / np.maximum(sigma, 1e-10))
    lam_n = np.log(alpha_n / np.maximum(sigma_n, 1e-10))
    return ts, alpha, sigma, alpha_n, sigma_n, lam, lam_n


def sample_dpmpp_2m(schedule: NoiseSchedule, denoise: DenoiseFn,
                    z: torch.Tensor, num_steps: int,
                    generator: Generators = None,
                    eta: float = 0.0) -> torch.Tensor:
    """DPM-Solver++(2M): multistep, one model evaluation a step, in the
    data-prediction form (`sample_dpmpp_2m`, `samplers.py:418-455`).

    diffusers 0.24.0 semantics: the first step is first order; the final
    step drops to first order only below 15 steps (lower_order_final), so
    at 25 steps it is second order.  Which steps are second order is
    decided here on the host; the JAX sampler selects with a `where`."""
    ts, alpha, sigma, alpha_n, sigma_n, lam, lam_n = _lambda_grids(
        schedule, num_steps)
    h = lam_n - lam
    h_prev = np.concatenate([[1.0], h[:-1]])
    r = h_prev / np.maximum(h, 1e-10)
    use2 = np.arange(num_steps) >= 1
    if num_steps < 15:
        use2[-1] = False
    emh = (sigma_n / np.maximum(sigma, 1e-10)) * (alpha / alpha_n)  # e^-h
    ts_f, a, s, an, sn, emh, r = _f32(ts, alpha, sigma, alpha_n, sigma_n,
                                      emh, r)
    # the scalar products of the JAX step, in its order, in float32
    one = np.float32(1.0)
    corr = one / (np.float32(2.0) * r)
    c_x = sn / s
    c_d = an * (emh - one)
    x, x0_prev = z, None
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        d = (float(one + corr[i]) * x0 - float(corr[i]) * x0_prev
             if use2[i] else x0)
        x = float(c_x[i]) * x - float(c_d[i]) * d
        x0_prev = x0
    return x


SAMPLERS = {"ddim": sample_ddim, "dpms_m": sample_dpmpp_2m}


def sample(name: str, schedule: NoiseSchedule, denoise: DenoiseFn,
           z: torch.Tensor, num_steps: int, generator: Generators = None,
           eta: float = 0.0) -> torch.Tensor:
    """Run sampler `name` (`sample`, `samplers.py:612-622`)."""
    if name not in SAMPLERS:
        raise ValueError(f"sampler {name!r} is not ported; have "
                         f"{sorted(SAMPLERS)}")
    return SAMPLERS[name](schedule, denoise, z, num_steps,
                          generator=generator, eta=eta)
