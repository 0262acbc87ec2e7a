"""Regional generation (`make_regional_generate`, `stack_region_params`,
`fold_region_weights`, `resize_masks` in `aqualora_torch/diffusion/
pipeline.py`) against the JAX package's on the CPU: JAX's tiny pipeline and
seeded weights carried over with `load_jax_params`, 32^2, DDIM 2 steps, two
messages, two sub-prompts and non-uniform masks, JAX's initial latent
replayed; for an epsilon- and a v-predicting U-Net.  Then what holds of the
port alone: a one-hot mask gives the plain folded generate, identical
regions collapse, counts must agree, and folding a region leaves the
pipeline as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
import aqualora_tpu.core.config as jcfg
from test_torch_port_pipeline import _fill, _tiny

KEY = jax.random.PRNGKey(0)
RES, LAT, STEPS, GUIDANCE = 32, 16, 2, 7.5
# images in [-1, 1]: the tolerance the slice's generate is held to
# (tests/test_torch_port_pipeline.py)
IMAGE_TOL = 2e-3
# two identical regions against one, float32: the normalized masks sum to
# 1 within a few float32 ulps, which two DDIM steps and the VAE keep small
COLLAPSE_TOL = 1e-5


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


def _masks():
    """Two regions, left and right, with a soft seam: non-uniform weights
    whose sum is not constant either."""
    col = np.clip(np.linspace(-0.5, 1.5, RES), 0.0, 1.0).astype(np.float32)
    left = np.broadcast_to(1.0 - col, (RES, RES))
    right = np.broadcast_to(col, (RES, RES)) * 0.7
    return np.stack([left, right]).astype(np.float32)


def _inputs(cfg):
    rng = np.random.default_rng(18)
    bits = cfg.watermark.msg_bits
    msgs = rng.integers(0, 2, (2, bits)).astype(np.float32)
    prompt_ids = rng.integers(0, cfg.clip.vocab_size, (2, 2, 77)).astype(
        np.int32)                                   # [S, B, 77]
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77)).astype(np.int32)
    return msgs, prompt_ids, neg


@pytest.fixture(scope="module", params=["epsilon", "v_prediction"])
def case(request):
    """JAX's regional call and the port's on the same weights, messages,
    prompts, masks and initial latent."""
    from aqualora_torch.diffusion.pipeline import (
        StableDiffusionPipeline as TPipe)
    from aqualora_tpu.diffusion.pipeline import (
        StableDiffusionPipeline as JPipe, stack_region_params)

    jpipe = JPipe(_tiny(jcfg, request.param))
    params = _fill(jax.eval_shape(lambda: jpipe.init_params(KEY, RES, RES)),
                   1)
    msgs, prompt_ids, neg = _inputs(jpipe.config)
    masks = _masks()
    stack = stack_region_params(
        [jpipe.fold_message(params, jnp.asarray(m))["unet"] for m in msgs])
    regional = jpipe.make_regional_generate(num_steps=STEPS, sampler="ddim",
                                            height=RES, width=RES)
    key = jax.random.PRNGKey(5)
    j_img = np.asarray(regional(params, stack, jnp.asarray(masks),
                                jnp.asarray(prompt_ids), jnp.asarray(neg),
                                key, GUIDANCE))
    # the initial latent JAX's regional call draws from `key`
    z = np.array(jax.random.normal(jax.random.split(key)[1],
                                   (2, LAT, LAT, 4)))

    tpipe = TPipe(_tiny(tcfg, request.param), device="cpu")
    tpipe.load_jax_params(params)
    weights = [tpipe.fold_region_weights(torch.from_numpy(m)) for m in msgs]
    t_regional = tpipe.make_regional_generate(num_steps=STEPS,
                                              sampler="ddim", height=RES,
                                              width=RES)
    t_img = t_regional(weights, masks, prompt_ids, neg, GUIDANCE,
                       z=torch.from_numpy(z)).numpy()
    return dict(j_img=j_img, t_img=t_img, pipe=tpipe, weights=weights,
                regional=t_regional, msgs=msgs, prompt_ids=prompt_ids,
                neg=neg, masks=masks, z=torch.from_numpy(z))


def test_regional_matches_jax(case):
    j_img, t_img = case["j_img"], case["t_img"]
    assert t_img.shape == j_img.shape == (2, RES, RES, 3)
    assert np.isfinite(t_img).all() and np.abs(t_img).max() <= 1.0
    assert j_img.std() > 0.1          # not a degenerate all-equal image
    np.testing.assert_allclose(t_img, j_img, atol=IMAGE_TOL)
    # both regions act: the right half is not the left region's image
    left_only = case["regional"](
        case["weights"], case["masks"] * np.array([1.0, 0.0])[:, None, None]
        .astype(np.float32), case["prompt_ids"], case["neg"], GUIDANCE,
        z=case["z"]).numpy()
    assert np.abs(left_only - t_img).max() > 1e-3


def test_one_hot_mask_is_the_folded_generate(case):
    """masks (1e6, 0): m = 1e6 / (1e6 + 1e-4) is exactly 1 in float32 and
    the other region's weight exactly 0, so the call is the plain generate
    of the pipeline folded with region A's message, bit for bit."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline

    src = case["pipe"]
    masks = np.stack([np.full((RES, RES), 1e6, np.float32),
                      np.zeros((RES, RES), np.float32)])
    ids = case["prompt_ids"]
    out = case["regional"](case["weights"], masks, ids, case["neg"],
                           GUIDANCE, z=case["z"])
    folded = StableDiffusionPipeline(src.config, device="cpu")
    folded.load_state_from(src)
    folded.fold_message(torch.from_numpy(case["msgs"][0]))
    ref = folded.make_generate(STEPS, "ddim", RES, RES)(
        ids[0], case["neg"], GUIDANCE, z=case["z"])
    assert torch.equal(out, ref)


def test_identical_regions_collapse(case):
    """Two regions with the same weights and sub-prompt under a non-uniform
    split equal that region alone."""
    w, ids = case["weights"][0], case["prompt_ids"][0]
    col = np.linspace(0.25, 0.75, RES, dtype=np.float32)[None, :]
    m1 = np.broadcast_to(col, (RES, RES)) * 1e6
    two = case["regional"]([w, w], np.stack([m1, 1e6 - m1]), [ids, ids],
                           case["neg"], GUIDANCE, z=case["z"])
    one = case["regional"]([w], np.full((1, RES, RES), 1e6, np.float32),
                           [ids], case["neg"], GUIDANCE, z=case["z"])
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=COLLAPSE_TOL)


RESIZES = [(512, 64), (32, 4), (768, 96)]


def _resize_case(size, out):
    """Random masks with an edge inside, and jax.image.resize's bilinear
    resize of them to (out, out)."""
    rng = np.random.default_rng(size)
    masks = rng.random((2, size, size), dtype=np.float32)
    masks[1, : size // 3] = 0.0
    ref = np.asarray(jax.image.resize(jnp.asarray(masks), (2, out, out),
                                      method="bilinear"))
    return torch.from_numpy(masks), ref


@pytest.mark.parametrize("size,out", RESIZES)
def test_mask_resize_matches_jax(size, out):
    """The masks go to latent size as jax.image.resize's bilinear does,
    antialiased when it shrinks."""
    from aqualora_torch.diffusion.pipeline import resize_masks

    masks, ref = _resize_case(size, out)
    ours = resize_masks(masks, out, out).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("size,out", RESIZES)
def test_plain_bilinear_resize_is_not_jax_resize(size, out):
    """The plain (non-antialiased) bilinear resize of ops/resize.py samples
    the masks instead of averaging them: far from jax.image.resize, so the
    regional path cannot use it."""
    from aqualora_torch.ops.resize import bilinear_resize

    masks, ref = _resize_case(size, out)
    plain = bilinear_resize(masks[None], out, out)[0].numpy()
    assert np.abs(plain - ref).max() > 0.1


def test_region_count_mismatch_raises(case):
    """A mask stack whose region count disagrees with prompt_ids raises
    before any work is done."""
    three = np.ones((3, RES, RES), np.float32)
    with pytest.raises(ValueError, match="regions"):
        case["regional"](case["weights"], three, case["prompt_ids"],
                         case["neg"], GUIDANCE, z=case["z"])
    with pytest.raises(ValueError, match="regions"):
        case["regional"](case["weights"][:1], case["masks"],
                         case["prompt_ids"], case["neg"], GUIDANCE,
                         z=case["z"])


def test_stack_region_params_drops_lora_keys(case):
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   stack_region_params)

    src = case["pipe"]
    states = []
    for m in case["msgs"]:
        p = StableDiffusionPipeline(src.config, device="cpu")
        p.load_state_from(src)
        p.fold_message(torch.from_numpy(m))
        states.append(p.unet.state_dict())
    dropped = stack_region_params(states)
    kept = stack_region_params(states, keep_lora=True)
    assert len(dropped) == len(kept) == 2
    assert not any(".lora." in k for s in dropped for k in s)
    assert any(".lora." in k for k in kept[0])
    assert set(dropped[0]) == {k for k in kept[0] if ".lora." not in k}
    # a whole folded state dict drives the regional call as the site
    # weights alone do
    out = case["regional"](dropped, case["masks"], case["prompt_ids"],
                           case["neg"], GUIDANCE, z=case["z"])
    assert torch.equal(out, torch.from_numpy(case["t_img"]))
    with pytest.raises(ValueError, match="different tensors"):
        stack_region_params([states[0], dropped[1]], keep_lora=True)


def test_fold_region_weights_leaves_the_pipeline(case):
    """Folding a region reads the pipeline and changes nothing of it; it
    returns the weights of the LoRA sites alone, equal to what fold_message
    writes in place."""
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.models.lora import lora_sites

    pipe = case["pipe"]
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    msg = torch.from_numpy(case["msgs"][1])
    weights = pipe.fold_region_weights(msg)
    after = pipe.unet.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert len(weights) == len(lora_sites(pipe.unet))
    folded = StableDiffusionPipeline(pipe.config, device="cpu")
    folded.load_state_from(pipe)
    folded.fold_message(msg)
    state = folded.unet.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in weights.items())
