"""The port's img2img (`StableDiffusionPipeline.make_img2img`, the SDEdit
attack of the robustness benchmark) against the JAX package's, on the CPU at
the tiny config: the same weights, JAX's posterior and forward-process draws
replayed, strength 0.1 and 0.2 at 10 steps and 0.5 at 4, for epsilon and
v-prediction; and the port's own draws from its generators.

The JAX side runs jitted on the CPU, one compile a case (about 5 s each
here), which is why these cases have a file of their own beside
`tests/test_torch_port_distortion.py` (the runner and the distortions):
each file stays under a minute alone on one worker.  Tolerance: the float
images of the slice tests (IMAGE_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aqualora_torch.core.config as tcfg
from test_torch_port_distortion import (TINY_VOCAB, _configs, _gradient,
                                        _img2img_draws, generated,
                                        jax_img2img)  # noqa: F401
from test_torch_port_eval import IMAGE_TOL, art  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread in this module (the tier-1 run puts
    several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps,strength", [(10, 0.1), (10, 0.2), (4, 0.5)])
def test_make_img2img_matches_jax(art, generated, jax_img2img, pred, steps,
                                  strength):
    """`make_img2img` against JAX's on the same weights and draws (eff = 1,
    2 and 2 denoising steps): images within IMAGE_TOL, and the attack
    moves the image."""
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline

    x01 = np.stack([generated, _gradient(32, 32)]).astype(np.float32) / 255
    images = x01 * 2 - 1
    tok = load_tokenizer(None, vocab_size=TINY_VOCAB)
    ids, neg = tok(["masterpiece", "a red fox"]), tok(["", ""])
    key = jax.random.PRNGKey(steps + int(10 * strength))
    want = np.array(jax_img2img(pred, steps, strength)(
        art["params"], jnp.asarray(images), jnp.asarray(ids),
        jnp.asarray(neg), key, 7.5))
    pipe = StableDiffusionPipeline(_configs(pred)[1], device="cpu")
    pipe.load_jax_params(art["params"])
    got = pipe.make_img2img(steps, strength, 32, 32)(
        torch.from_numpy(images), ids, neg, 7.5,
        **_img2img_draws(key, 2)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(want - images).max() > 0.1
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


def test_make_img2img_draws_from_its_generators(art, generated):
    """Without draws, img2img takes the posterior's and then the forward
    process's from the generator (one per image): the same images as the
    same numbers handed in."""
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.diffusion.samplers import batch_randn

    pipe = StableDiffusionPipeline(tcfg.PipelineConfig.tiny(), device="cpu")
    pipe.load_jax_params(art["params"])
    fn = pipe.make_img2img(10, 0.2, 32, 32)
    tok = load_tokenizer(None, vocab_size=TINY_VOCAB)
    images = torch.from_numpy(np.stack([generated] * 2).astype(np.float32)
                              / 127.5 - 1)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (1, 2)]
    drawn = fn(images, tok(["a", "b"]), tok(["", ""]), generator=gens())
    g = gens()
    post, noise = (batch_randn((2, 16, 16, 4), g, "cpu") for _ in range(2))
    given = fn(images, tok(["a", "b"]), tok(["", ""]), posterior_noise=post,
               noise=noise)
    assert torch.equal(drawn, given)
    assert (drawn[0] - drawn[1]).abs().max() > 1e-3
