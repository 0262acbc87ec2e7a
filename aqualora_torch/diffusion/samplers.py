"""The twelve samplers of the JAX package's menu
(`aqualora_tpu/diffusion/samplers.py`), in PyTorch.

Interface: sample(name, schedule, denoise, z, num_steps, generator, eta)
  denoise(x_t, t) -> epsilon prediction (CFG applied); t is a 0-dim float32
  tensor on x's device (a fractional timestep for the midpoints of kdpm2,
  kdpm2a and dpms_s).  Returns the final x0-space latent.

Every coefficient is computed once on the host in numpy (the same numpy
as the JAX samplers', on the float32 alphas_cumprod) and rounded to float32
as the JAX samplers gather theirs; the scalar products the JAX step does on
the device in float32 are done here on the host in float32, in its order.
Branches the JAX step takes with `cond` or `where` on a per-step constant
are decided on the host.  So a step makes no host sync.

- alpha space: DDIM, ancestral DDPM, PLMS (`pndm`, the skip_prk warmup);
- the k-diffusion family on the rescaled ODE dy/ds = eps (y = x / alpha,
  s = sigma / alpha): euler, heun, lms (4th-order linear multistep),
  kdpm2 (DPM-Solver-2 midpoint) and kdpm2a (its ancestral variant);
- DPM-Solver++ in lambda = log(alpha / sigma): dpms_m (2M), dpms_s (2S),
  dpms_sde (2M SDE) and unipc (UniPC bh2, order 2).

`generator` is one `torch.Generator` or a list of them, one per image (the
counterpart of the JAX key stacks, `samplers.py:53-92`): with a list, row i
of every draw comes from generator i alone, so image i does not depend on
how a prompt list is cut into batches.  The stochastic samplers (ddpm,
kdpm2a, dpms_sde) draw once a step, as the JAX bodies do, through
`batch_randn`.
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


def _noise(x: torch.Tensor, generator: Generators) -> torch.Tensor:
    return batch_randn(x.shape, generator, x.device, x.dtype)


def sample_ddpm(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                num_steps: int, generator: Generators = None,
                eta: float = 1.0) -> torch.Tensor:
    """Ancestral DDPM on the inference grid (`sample_ddpm`,
    `samplers.py:170-199`); one draw a step, the last with std 0."""
    ts, alpha, sigma, alpha_n, sigma_n = _grid(schedule, num_steps)
    acp, acp_n = alpha ** 2, alpha_n ** 2   # boundary row from _grid
    a_eff = acp / acp_n                     # effective per-step alpha
    b_eff = 1.0 - a_eff
    x0_coef = np.sqrt(acp_n) * b_eff / (1 - acp)
    xt_coef = np.sqrt(a_eff) * (1 - acp_n) / (1 - acp)
    var = np.clip(b_eff * (1 - acp_n) / (1 - acp), 0.0, None)
    var[-1] = 0.0
    ts_f, a, s, x0c, xtc, stdv = _f32(ts, alpha, sigma, x0_coef, xt_coef,
                                      np.sqrt(var))
    x = z
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        x = (float(x0c[i]) * x0 + float(xtc[i]) * x
             + float(stdv[i]) * _noise(x, generator))
    return x


# Adams-Bashforth weights by available order, newest first
_AB = np.asarray([[1.0, 0.0, 0.0, 0.0],
                  [3 / 2, -1 / 2, 0.0, 0.0],
                  [23 / 12, -16 / 12, 5 / 12, 0.0],
                  [55 / 24, -59 / 24, 37 / 24, -9 / 24]], np.float32)


def _combine(weights, terms) -> torch.Tensor:
    """sum_j w_j * term_j left to right, the terms of weight 0 left out
    (adding them adds exact zeros)."""
    out = None
    for w, t in zip(weights, terms):
        if w != 0:
            out = float(w) * t if out is None else out + float(w) * t
    return out


def sample_pndm(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                num_steps: int, generator: Generators = None,
                eta: float = 0.0) -> torch.Tensor:
    """PLMS with the SD-default skip_prk warmup (`sample_pndm`,
    `samplers.py:202-246`): a Heun-corrected first step, whose corrector
    evaluation does not join the history, then Adams-Bashforth orders
    2/3/4 on epsilon.  num_steps + 1 evaluations."""
    ts, alpha, sigma, alpha_n, sigma_n = _grid(schedule, num_steps,
                                               final_alpha_one=False)
    acp, acp_n = alpha ** 2, alpha_n ** 2
    samp_coef = np.sqrt(acp_n / acp)
    denom = acp * np.sqrt(1 - acp_n) + np.sqrt(acp * (1 - acp) * acp_n)
    eps_coef = (acp_n - acp) / denom
    ts_f, sc, ec = _f32(ts, samp_coef, eps_coef)

    def transfer(i, x, eps):
        return float(sc[i]) * x - float(ec[i]) * eps

    e0 = denoise(z, _t(ts_f, 0, z.device))
    x1 = transfer(0, z, e0)
    e1 = denoise(x1, _t(ts_f, 1, z.device) if num_steps > 1
                 else torch.zeros((), device=z.device))
    x = transfer(0, z, (e0 + e1) / 2.0)
    hist = [e0, e0, e0, e0]                 # newest first
    for i in range(1, num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        hist = [eps] + hist[:3]
        x = transfer(i, x, _combine(_AB[min(i, 3)], hist))
    return x


# ---------------------------------------------------------------------------
# the k-diffusion family: the rescaled ODE dy/ds = eps, y = x / alpha
# ---------------------------------------------------------------------------

def _s_grid(schedule: NoiseSchedule, num_steps: int,
            spacing: str = "linspace"):
    """The k-family's float 'linspace' grid in s = sigma / alpha, with the
    boundary s = 0 (`_s_grid`, `samplers.py:253-259`)."""
    ts, alpha, sigma, alpha_n, sigma_n = _grid(schedule, num_steps,
                                               spacing=spacing)
    s = sigma / alpha
    s_next = np.concatenate([s[1:], [0.0]])
    return ts, alpha, s, s_next


def _frac_t_for_sigma_ratio(schedule: NoiseSchedule,
                            s_query: np.ndarray) -> np.ndarray:
    """Fractional timestep t with sigma(t) / alpha(t) == s (the k-samplers'
    interpolated midpoints): log-s interpolated over the training grid."""
    acp = schedule.alphas_cumprod.cpu().numpy()
    s_grid = np.sqrt((1.0 - acp) / acp)                  # ascending in t
    logs = np.log(s_grid)
    tq = np.interp(np.log(np.maximum(s_query, 1e-12)), logs,
                   np.arange(len(logs), dtype=np.float64))
    return tq.astype(np.float32)


def sample_euler(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                 num_steps: int, generator: Generators = None,
                 eta: float = 0.0) -> torch.Tensor:
    ts, alpha, s, s_next = _s_grid(schedule, num_steps)
    ts_f, a, s_f, sn = _f32(ts, alpha, s, s_next)
    dt = sn - s_f
    y = z * float(np.float32(s[0]))
    for i in range(num_steps):
        eps = denoise(float(a[i]) * y, _t(ts_f, i, z.device))
        y = y + float(dt[i]) * eps
    return y


def sample_heun(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                num_steps: int, generator: Generators = None,
                eta: float = 0.0) -> torch.Tensor:
    """Heun's second-order method; the last step (to s = 0) is Euler's, so
    2 * num_steps - 1 evaluations."""
    ts, alpha, s, s_next = _s_grid(schedule, num_steps)
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    ts_next = np.concatenate([ts[1:], [0]]).astype(np.float32)
    ts_f, tn, a, an, s_f, sn = _f32(ts, ts_next, alpha, alpha_next, s, s_next)
    dt = sn - s_f
    y = z * float(np.float32(s[0]))
    for i in range(num_steps):
        d1 = denoise(float(a[i]) * y, _t(ts_f, i, z.device))
        y_e = y + float(dt[i]) * d1
        if sn[i] > 0:
            d2 = denoise(float(an[i]) * y_e, _t(tn, i, z.device))
            y = y + float(dt[i]) * (d1 + d2) / 2.0
        else:
            y = y_e
    return y


def sample_lms(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
               num_steps: int, generator: Generators = None,
               eta: float = 0.0, order: int = 4) -> torch.Tensor:
    """Linear multistep: the Lagrange basis polynomials integrated over
    each [s_i, s_{i+1}] on the host (degree <= 3)."""
    ts, alpha, s, s_next = _s_grid(schedule, num_steps)
    coeffs = np.zeros((num_steps, order), np.float64)
    for i in range(num_steps):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            nodes = [s[i - k] for k in range(cur_order)]
            poly = np.poly1d([1.0])
            for k in range(cur_order):
                if k != j:
                    poly *= np.poly1d([1.0, -nodes[k]]) / (nodes[j] - nodes[k])
            integ = poly.integ()
            coeffs[i, j] = integ(s_next[i]) - integ(s[i])
    ts_f, a, c = _f32(ts, alpha, coeffs)
    y, hist = z * float(np.float32(s[0])), []
    for i in range(num_steps):
        eps = denoise(float(a[i]) * y, _t(ts_f, i, z.device))
        hist = [eps] + hist[:order - 1]
        y = y + _combine(c[i], hist)
    return y


def _kdpm2_grids(schedule: NoiseSchedule, num_steps: int):
    ts, alpha, s, s_next = _s_grid(schedule, num_steps)
    s_mid = np.sqrt(np.maximum(s * s_next, 1e-20))          # geometric mean
    t_mid = _frac_t_for_sigma_ratio(schedule, s_mid)
    a_mid = 1.0 / np.sqrt(1.0 + s_mid ** 2)
    return ts, alpha, s, s_next, s_mid, t_mid, a_mid


def sample_kdpm2(schedule: NoiseSchedule, denoise: DenoiseFn, z: torch.Tensor,
                 num_steps: int, generator: Generators = None,
                 eta: float = 0.0) -> torch.Tensor:
    """DPM-Solver-2 with its midpoint in log s, k-diffusion style; the last
    step is Euler's, so 2 * num_steps - 1 evaluations."""
    ts, alpha, s, s_next, s_mid, t_mid, a_mid = _kdpm2_grids(schedule,
                                                             num_steps)
    ts_f, a, s_f, sn, sm, tm, am = _f32(ts, alpha, s, s_next, s_mid, t_mid,
                                        a_mid)
    y = z * float(np.float32(s[0]))
    for i in range(num_steps):
        d1 = denoise(float(a[i]) * y, _t(ts_f, i, z.device))
        if sn[i] > 0:
            y_mid = y + float(sm[i] - s_f[i]) * d1
            d2 = denoise(float(am[i]) * y_mid, _t(tm, i, z.device))
            y = y + float(sn[i] - s_f[i]) * d2
        else:
            y = y + float(sn[i] - s_f[i]) * d1
    return y


def sample_kdpm2_ancestral(schedule: NoiseSchedule, denoise: DenoiseFn,
                           z: torch.Tensor, num_steps: int,
                           generator: Generators = None,
                           eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver-2 to s_down, then ancestral noise of std s_up; one draw a
    step, 2 * num_steps - 1 evaluations."""
    ts, alpha, s, s_next = _s_grid(schedule, num_steps)
    s_up = np.sqrt(np.clip(s_next ** 2 * (s ** 2 - s_next ** 2)
                           / np.maximum(s ** 2, 1e-20), 0, None))
    s_down = np.sqrt(np.clip(s_next ** 2 - s_up ** 2, 0, None))
    s_mid = np.sqrt(np.maximum(s * s_down, 1e-20))
    t_mid = _frac_t_for_sigma_ratio(schedule, s_mid)
    a_mid = 1.0 / np.sqrt(1.0 + s_mid ** 2)
    ts_f, a, s_f, sd, su, sm, tm, am = _f32(ts, alpha, s, s_down, s_up,
                                            s_mid, t_mid, a_mid)
    y = z * float(np.float32(s[0]))
    for i in range(num_steps):
        d1 = denoise(float(a[i]) * y, _t(ts_f, i, z.device))
        if sd[i] > 0:
            y_mid = y + float(sm[i] - s_f[i]) * d1
            d2 = denoise(float(am[i]) * y_mid, _t(tm, i, z.device))
            y = y + float(sd[i] - s_f[i]) * d2
        else:
            y = y + float(sd[i] - s_f[i]) * d1
        y = y + float(su[i]) * _noise(y, generator)
    return y


# ---------------------------------------------------------------------------
# DPM-Solver++ and UniPC (data prediction, lambda = log(alpha / sigma))
# ---------------------------------------------------------------------------

def _lambda_grids(schedule: NoiseSchedule, num_steps: int,
                  spacing: str = "linspace_round",
                  final_alpha_one: bool = False):
    """diffusers 0.24.0's DPM and UniPC grids (`samplers.py:403-415`): the
    final boundary is alphas_cumprod[0], not sigma = 0; lambda = log(alpha
    / sigma).  The SDE sampler alone ends at sigma = 0 on the float
    'linspace' grid."""
    ts, alpha, sigma, alpha_n, sigma_n = _grid(schedule, num_steps,
                                               spacing=spacing,
                                               final_alpha_one=final_alpha_one)
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


def sample_dpmpp_2s(schedule: NoiseSchedule, denoise: DenoiseFn,
                    z: torch.Tensor, num_steps: int,
                    generator: Generators = None,
                    eta: float = 0.0) -> torch.Tensor:
    """DPM-Solver++(2S): single-step second order, the midpoint at lambda +
    h / 2 (a fractional timestep); the last step first order, so
    2 * num_steps - 1 evaluations (`samplers.py:458-501`)."""
    ts, alpha, sigma, alpha_n, sigma_n, lam, lam_n = _lambda_grids(
        schedule, num_steps)
    h = lam_n - lam
    lam_mid = lam + h / 2.0
    # mid-point alpha/sigma from lambda: alpha^2 = sigmoid(2*lam)
    a_mid = np.sqrt(1.0 / (1.0 + np.exp(-2 * lam_mid)))
    s_mid = np.sqrt(1.0 - a_mid ** 2)
    acp = schedule.alphas_cumprod.cpu().numpy()
    lam_grid = 0.5 * np.log(acp / np.maximum(1 - acp, 1e-12))  # descending
    # interpolate t(lambda): xp must ascend -> reverse the grid
    t_mid = np.interp(lam_mid, lam_grid[::-1],
                      np.arange(len(lam_grid), dtype=np.float64)[::-1])
    emh = (sigma_n / np.maximum(sigma, 1e-10)) * (alpha / alpha_n)
    emh2 = (s_mid / np.maximum(sigma, 1e-10)) * (alpha / a_mid)  # e^-h/2
    ts_f, a, s, an, sn, am, sm, tm, emh, emh2 = _f32(
        ts, alpha, sigma, alpha_n, sigma_n, a_mid, s_mid, t_mid, emh, emh2)
    one = np.float32(1.0)
    c_x, c_d = sn / s, an * (emh - one)
    c_u, c_ud = sm / s, am * (emh2 - one)
    x = z
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        if i < num_steps - 1:
            u = float(c_u[i]) * x - float(c_ud[i]) * x0
            eps_m = denoise(u, _t(tm, i, z.device))
            x0 = (u - float(sm[i]) * eps_m) / float(am[i])
        x = float(c_x[i]) * x - float(c_d[i]) * x0
    return x


def sample_dpmpp_2m_sde(schedule: NoiseSchedule, denoise: DenoiseFn,
                        z: torch.Tensor, num_steps: int,
                        generator: Generators = None,
                        eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver++(2M) SDE (the reference's 'dpms_sde'; eta 1), on the
    float grid to sigma = 0; one draw a step (`samplers.py:504-545`)."""
    ts, alpha, sigma, alpha_n, sigma_n, lam, lam_n = _lambda_grids(
        schedule, num_steps, spacing="linspace", final_alpha_one=True)
    h = lam_n - lam
    h_prev = np.concatenate([[1.0], h[:-1]])
    r = h_prev / np.maximum(h, 1e-10)
    use2 = np.arange(num_steps) >= 1
    use2[-1] = False
    emh = (sigma_n / np.maximum(sigma, 1e-10)) * (alpha / alpha_n)  # e^-h
    # x_t = (sigma_t/sigma_s) e^{-eta h} x_s + alpha_t (1 - e^{-(1+eta)h}) D
    #       + sigma_t sqrt(1 - e^{-2 eta h}) z
    x_decay = emh ** eta
    data_w = 1.0 - emh ** (1.0 + eta)
    noise_std = sigma_n * np.sqrt(np.clip(1.0 - emh ** (2.0 * eta), 0.0,
                                          None))
    ts_f, a, s, an, sn, xd, dw, r, nstd = _f32(
        ts, alpha, sigma, alpha_n, sigma_n, x_decay, data_w, r, noise_std)
    one = np.float32(1.0)
    corr = one / (np.float32(2.0) * r)
    c_x, c_d = (sn / s) * xd, an * dw
    x, x0_prev = z, None
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        d = (float(one + corr[i]) * x0 - float(corr[i]) * x0_prev
             if use2[i] else x0)
        x = float(c_x[i]) * x + float(c_d[i]) * d
        x = x + float(nstd[i]) * _noise(x, generator)
        x0_prev = x0
    return x


def sample_unipc(schedule: NoiseSchedule, denoise: DenoiseFn,
                 z: torch.Tensor, num_steps: int,
                 generator: Generators = None,
                 eta: float = 0.0) -> torch.Tensor:
    """UniPC order 2 (bh2): the UniP-2 predictor (DPM-Solver++(2M)'s step)
    and the UniC corrector, which re-derives each point from the previous
    one once the model's value there is known; one evaluation a step.
    UniPC 0.24.0 demotes the final predictor to first order at every step
    count (`samplers.py:548-593`)."""
    ts, alpha, sigma, alpha_n, sigma_n, lam, lam_n = _lambda_grids(
        schedule, num_steps)
    h = lam_n - lam
    h_prev = np.concatenate([[1.0], h[:-1]])
    r = h_prev / np.maximum(h, 1e-10)
    use2 = np.arange(num_steps) >= 1
    use2[-1] = False
    emh = (sigma_n / np.maximum(sigma, 1e-10)) * (alpha / alpha_n)  # e^-h
    phi1 = emh - 1.0
    phi1_prev = np.concatenate([[0.0], phi1[:-1]])
    sig_prev = np.concatenate([[1.0], sigma[:-1]])
    ts_f, a, s, an, sn, phi1, r, phi1p, sigp = _f32(
        ts, alpha, sigma, alpha_n, sigma_n, phi1, r, phi1_prev, sig_prev)
    one = np.float32(1.0)
    corr = one / (np.float32(2.0) * r)
    c_x, c_d = sn / s, an * phi1
    c_cx, c_cd = s / sigp, a * phi1p
    x, x_prev, x0_prev = z, None, None
    for i in range(num_steps):
        eps = denoise(x, _t(ts_f, i, z.device))
        x0 = (x - float(s[i]) * eps) / float(a[i])
        if i >= 1:      # UniC: correct x with the fresh x0
            d1_t = x0 - x0_prev
            x = (float(c_cx[i]) * x_prev
                 - float(c_cd[i]) * (x0_prev + 0.5 * d1_t))
        d = (float(one + corr[i]) * x0 - float(corr[i]) * x0_prev
             if use2[i] else x0)
        x_prev, x0_prev = x, x0
        x = float(c_x[i]) * x - float(c_d[i]) * d
    return x


# names as the reference's menu (evaluation/utils_eval.py:83-106)
SAMPLERS = {
    "ddim": sample_ddim,
    "ddpm": sample_ddpm,
    "euler": sample_euler,
    "heun": sample_heun,
    "lms": sample_lms,
    "pndm": sample_pndm,
    "dpms_s": sample_dpmpp_2s,
    "dpms_sde": sample_dpmpp_2m_sde,
    "dpms_m": sample_dpmpp_2m,
    "kdpm2": sample_kdpm2,
    "kdpm2a": sample_kdpm2_ancestral,
    "unipc": sample_unipc,
}
# the stochastic three run at their own eta (`sample`, `samplers.py:620`)
STOCHASTIC = ("ddpm", "kdpm2a", "dpms_sde")


def sample(name: str, schedule: NoiseSchedule, denoise: DenoiseFn,
           z: torch.Tensor, num_steps: int, generator: Generators = None,
           eta: float = 0.0) -> torch.Tensor:
    """Run sampler `name` (`sample`, `samplers.py:612-622`).  ddpm, kdpm2a
    and dpms_sde are inherently noisy and keep their own eta."""
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; have {sorted(SAMPLERS)}")
    if name in STOCHASTIC:
        return SAMPLERS[name](schedule, denoise, z, num_steps,
                              generator=generator)
    return SAMPLERS[name](schedule, denoise, z, num_steps,
                          generator=generator, eta=eta)


def unet_evaluations(name: str, num_steps: int) -> int:
    """Model evaluations one call of sampler `name` makes: one a step, two
    a step for heun, kdpm2, kdpm2a and dpms_s but on their last step, and
    one more for pndm's warmup corrector."""
    if name in ("heun", "kdpm2", "kdpm2a", "dpms_s"):
        return 2 * num_steps - 1
    return num_steps + (name == "pndm")
