"""The port's twelve samplers against the JAX package, float32 on the CPU.

Each sampler runs `tests/test_samplers.py`'s analytic denoiser (the
Bayes-optimal epsilon for data ~ N(3, 1)) and is held against the committed
goldens `tests/goldens/sampler_goldens.npz` at 8 and 25 steps, to 1e-5.  The
goldens start from z = normal(PRNGKey(123), (8, 4)); the stochastic three
(ddpm, kdpm2a, dpms_sde) draw from PRNGKey(7) in the JAX bodies, so these
tests hand the port the same draws, made in the order the JAX body makes
them (`key, sub = split(key)` once a step).  The stochastic samplers'
per-image generators and statistics are held on their own, and the
fractional-timestep midpoints (kdpm2, dpms_s) go through the pipeline's
denoise against the JAX pipeline on the tiny U-Net.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
from aqualora_torch.diffusion import samplers as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens", "sampler_goldens.npz")
MU = 3.0
NAMES = sorted(ts.SAMPLERS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host, and a thread pool as wide as the host
    in each of them oversubscribes the cores (the tiny torch ops here then
    run one to two orders of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedule():
    from aqualora_torch.diffusion.schedule import NoiseSchedule
    return NoiseSchedule.create(tcfg.ScheduleConfig(), "cpu")


def _optimal_denoise(sched):
    """`optimal_denoise` of tests/test_samplers.py in torch, float32."""
    acp_all = sched.alphas_cumprod
    t_max = sched.config.num_train_timesteps - 1

    def denoise(x, t):
        t_lo = torch.clamp(torch.floor(t).long(), 0, t_max)
        t_hi = torch.clamp(t_lo + 1, 0, t_max)
        frac = t - t_lo
        acp = (1 - frac) * acp_all[t_lo] + frac * acp_all[t_hi]
        alpha, sig = torch.sqrt(acp), torch.sqrt(1 - acp)
        x0_mean = (MU * sig ** 2 + alpha * x) / (alpha ** 2 + sig ** 2)
        return (x - alpha * x0_mean) / sig

    return denoise


def _jax_draws(steps, shape):
    """The normals the JAX stochastic bodies draw from PRNGKey(7): one
    split a step, the draw from the second half."""
    key, out = jax.random.PRNGKey(7), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


class _Replay:
    """Stands in for `batch_randn`: hands out recorded draws in order."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, shape, generator, device, dtype=torch.float32):
        d = self.draws[self.calls]
        self.calls += 1
        assert tuple(d.shape) == tuple(shape)
        return d.to(device, dtype)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS), np.asarray(
        jax.random.normal(jax.random.PRNGKey(123), (8, 4)))


@pytest.mark.parametrize("steps", [8, 25])
@pytest.mark.parametrize("name", NAMES)
def test_sampler_matches_the_goldens(name, steps, goldens, monkeypatch):
    """All twelve, `sample(name)` on the analytic denoiser against the
    golden of the JAX sampler, within 1e-5; the stochastic ones with the
    JAX body's draws, exactly one a step."""
    table, z = goldens
    golden = table[f"{name}_{steps}"]
    replay = None
    if name in ts.STOCHASTIC:
        replay = _Replay(_jax_draws(steps, z.shape))
        monkeypatch.setattr(ts, "batch_randn", replay)
    sched = _schedule()
    out = ts.sample(name, sched, _optimal_denoise(sched), torch.tensor(z),
                    steps)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), golden, rtol=0, atol=1e-5,
                               err_msg=name)
    assert np.abs(golden - z).max() > 1.0             # it moved
    if replay is not None:
        assert replay.calls == steps


@pytest.mark.parametrize("name", NAMES)
def test_sampler_evaluations_match_the_count(name):
    """`unet_evaluations` counts the denoise calls each sampler makes (it
    gives chip_smoke.py its launch counts)."""
    sched = _schedule()
    inner, calls = _optimal_denoise(sched), []

    def denoise(x, t):
        calls.append(float(t))
        return inner(x, t)

    for steps in (3, 8):
        calls.clear()
        ts.sample(name, sched, denoise, torch.zeros(2, 1), steps,
                  generator=torch.Generator().manual_seed(0))
        assert len(calls) == ts.unet_evaluations(name, steps), steps
    # the midpoint samplers evaluate at fractional timesteps
    frac = any(t != int(t) for t in calls)
    assert frac == (name in ("euler", "heun", "lms", "kdpm2", "kdpm2a",
                             "dpms_s", "dpms_sde"))


@pytest.mark.parametrize("name", ts.STOCHASTIC)
def test_stochastic_rows_follow_their_generator(name):
    """With a list of generators, row i of the result depends on generator
    i alone: the middle row of a batch of 3 equals the batch of 1 run with
    that row's generator; other generators change other rows only."""
    sched = _schedule()
    denoise = _optimal_denoise(sched)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4, 2, 2)).astype(np.float32))

    def run(rows, seeds):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return ts.sample(name, sched, denoise, z[rows], 6, generator=gens)

    three = run(slice(0, 3), (10, 11, 12))
    one = run(slice(1, 2), (11,))
    assert torch.equal(three[1:2], one)
    other = run(slice(0, 3), (20, 11, 22))
    assert torch.equal(other[1], three[1])
    assert not torch.equal(other[0], three[0])


@pytest.mark.parametrize("name", NAMES)
def test_sampler_transports_gaussian(name):
    """`test_sampler_transports_gaussian` of tests/test_samplers.py with
    torch's draws: z ~ N(0, I) of 4096 goes to samples of mean 3 (within
    0.15 for the stochastic samplers, which forget the init, 0.35 for the
    ODE ones) and std 1 (within 0.15), at 50 steps."""
    sched = _schedule()
    z = torch.randn(4096, 1, generator=torch.Generator().manual_seed(42))
    out = ts.sample(name, sched, _optimal_denoise(sched), z, 50,
                    generator=torch.Generator().manual_seed(7))
    mean, std = out.mean().item(), out.std(unbiased=False).item()
    tol = 0.15 if name in ts.STOCHASTIC else 0.35
    assert abs(mean - MU) < tol, (name, mean)
    assert abs(std - 1.0) < 0.15, (name, std)


def test_unknown_sampler_is_refused():
    sched = _schedule()
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.sample("dpm_fast", sched, _optimal_denoise(sched),
                  torch.zeros(1, 1), 2)


# ---------------------------------------------------------------------------
# the fractional midpoints through the pipeline's denoise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pipes():
    """The tiny JAX pipeline and the port's, on the same seeded weights
    (every LoRA leaf zero, so the plain U-Net runs)."""
    from aqualora_tpu.core.config import PipelineConfig
    from aqualora_tpu.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)

    jpipe = StableDiffusionPipeline(PipelineConfig.tiny())
    shapes = jax.eval_shape(lambda: jpipe.init_params(
        jax.random.PRNGKey(0), 32, 32))
    rng = np.random.default_rng(3)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias" or any(getattr(k, "key", None) == "lora"
                                 for k in path):
            return np.zeros(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tpipe = TPipe(tcfg.PipelineConfig.tiny(), device="cpu")
    tpipe.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return jpipe, params, tpipe


@pytest.mark.parametrize("name", ["kdpm2", "dpms_s"])
def test_fractional_midpoints_match_the_jax_pipeline(name, tiny_pipes):
    """kdpm2 and dpms_s evaluate the U-Net at fractional timesteps (their
    midpoints): the port's generate against the JAX pipeline's, 3 steps
    at CFG 7.5 from the same initial latent, within 2e-3 (the pipeline
    tests' tolerance)."""
    jpipe, params, tpipe = tiny_pipes
    rng = np.random.default_rng(11)
    cfg = jpipe.config
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                     (2, 16, 16, 4)))
    j_img = np.asarray(jpipe.make_generate(
        num_steps=3, sampler=name, height=32, width=32)(
        params, jnp.asarray(ids), jnp.asarray(neg), key, 7.5, None))
    t_img = tpipe.make_generate(num_steps=3, sampler=name, height=32,
                                width=32)(ids, neg, 7.5,
                                          z=torch.tensor(z)).numpy()
    assert j_img.std() > 0.1
    np.testing.assert_allclose(t_img, j_img, atol=2e-3)
