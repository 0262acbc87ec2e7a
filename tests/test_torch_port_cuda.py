"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip on
a host without a card.  This file imports no JAX (the GPU machine has none);
run it there without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from aqualora_torch.ops import flash_attention as fa
from aqualora_torch.ops.attention import dot_product_attention

# float32: both sides accumulate in float32 in different orders (~1e-6);
# lse is float32 for either input type
TOL_F32 = 1e-4
TOL_LSE = 1e-4


def _tol_o(dtype, o_ref):
    """bfloat16 O is rounded on both sides, so an element may differ by one
    bf16 ulp at its magnitude: at most 2^-7 * max|O_ref|."""
    if dtype == torch.float32:
        return TOL_F32
    return 2.0 ** -7 * o_ref.float().abs().max().item() + TOL_F32


@pytest.fixture(autouse=True)
def _full_float32():
    """The plain versions are the references: float32 products and
    convolutions in full float32 (cuDNN takes TF32 by default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# the tilings of stage 3's 768^2 shapes (B8 under CFG, the VAE at B4) that
# the determinism cases must reach
STAGE3_768_ROWS = {(8, 8, 9216, 9216, 40): 128, (8, 8, 144, 144, 160): 16,
                   (4, 1, 9216, 9216, 512): 32}


# rows: the query rows per block of the bf16 instance the case must reach
# (fwd_tile_rows).  The wide tiles are taken when they give at least two
# blocks per SM; every case has at most 64 or at least 512 wide blocks, so
# the choice is the same on any card with 33 to 256 SMs (the H100 has 132).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,tq,tk,d,rows", [
    (2, 8, 300, 77, 40, 16),      # ragged Tq, cross-attention Tk, d=40
    (1, 8, 1024, 1024, 80, 16),   # 32^2 self, 16-row tiles
    (2, 3, 65, 64, 160, 16),
    (1, 1, 200, 333, 512, 32),    # VAE head dim, ragged lengths
    (1, 2, 7, 1, 3, 16),          # one key, tiny head dim
    (8, 8, 1000, 1000, 40, 128),  # 128-row tiles, Tq not a multiple of 128
    (8, 8, 1000, 77, 40, 128),    # 128-row tiles at Tk = 77
    (8, 8, 1000, 777, 80, 128),   # 128-row tiles at d=80, ragged both ways
    (16, 8, 250, 250, 160, 64),   # 64-row tiles at d=160, ragged both ways
    (16, 8, 1024, 77, 80, 128),   # the serving batch's 32^2 cross-attention
    (2, 4, 100, 90, 36, 16),      # d not a multiple of 8: staged by plain loads
    (1, 1, 4096, 4096, 512, 32),  # the VAE mid-block at B1
    (5, 1, 4096, 4096, 512, 32),  # the VAE mid-block at the stage-1 batch
    (1, 2, 77, 50, 300, 32),      # d = 512 kernel at a narrower head dim
    # SD-2.1 at 512^2: d = 64 at every level, on the DP = 80 instances with
    # 16 columns masked
    (4, 5, 4096, 4096, 64, 128),  # 64^2 self
    (4, 5, 4096, 77, 64, 128),    # 64^2 cross
    (16, 10, 1024, 1024, 64, 128),  # 32^2 self at the serving batch
    (16, 10, 1024, 77, 64, 128),  # 32^2 cross
    (16, 20, 256, 256, 64, 128),  # 16^2 self
    (1, 20, 256, 77, 64, 16),     # 16^2 cross, 16-row tiles
    (2, 20, 64, 64, 64, 16),      # the mid-block's 8^2 self
    (2, 20, 64, 77, 64, 16),      # its cross-attention
    # stage 3 at 768^2 (STAGE3_768_ROWS)
    (2, 8, 9216, 9216, 40, 128),  # 96^2 self
    (8, 8, 144, 144, 160, 16),    # 12^2 self at the CFG batch
    (4, 1, 9216, 9216, 512, 32),  # the VAE mid-block at B4
])
def test_flash_kernel_matches_plain(dtype, b, h, tq, tk, d, rows):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(tq * d)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
               for t in (tq, tk, tk))
    if dtype == torch.bfloat16:
        assert fa.fwd_tile_rows(q) == rows
    before = fa.launches.count
    o, lse = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    assert o.dtype == dtype and lse.shape == (b, h, tq)
    err = (o.float() - o_ref.float()).abs().max().item()
    assert err <= _tol_o(dtype, o_ref)
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d,dtype", [
    (2, 8, 4096, 4096, 40, torch.bfloat16),   # the 64^2 self, 128-row tiles
    (2, 8, 4096, 77, 40, torch.bfloat16),     # its cross-attention
    (16, 8, 1024, 1024, 80, torch.bfloat16),  # 32^2 self at the serving batch
    (2, 8, 300, 77, 160, torch.bfloat16),     # 16-row tiles, warps merged
    (16, 10, 1024, 1024, 64, torch.bfloat16),  # SD-2.1's d = 64, masked
    (1, 1, 1000, 1000, 512, torch.bfloat16),  # the d = 512 kernel
    (5, 1, 4096, 4096, 512, torch.float32),   # d = 512 float32 (3xTF32)
    (2, 1, 1000, 1000, 512, torch.float32),   # d = 512 float32, ragged
    # stage 3 at 768^2, with their tilings (STAGE3_768_ROWS)
    (8, 8, 9216, 9216, 40, torch.bfloat16),   # 96^2 self
    (8, 8, 144, 144, 160, torch.bfloat16),    # 12^2 self
    (4, 1, 9216, 9216, 512, torch.bfloat16),  # the VAE mid-block
    (4, 1, 9216, 9216, 512, torch.float32),
])
def test_flash_fwd_is_deterministic(b, h, tq, tk, d, dtype):
    """No atomics, and the warps' partial results are merged in a fixed
    order, so two calls give the same bits: bf16, and float32 on the d = 512
    tensor-core kernel."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(tk + d)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               .to(dtype) for t in (tq, tk, tk))
    if dtype == torch.bfloat16 and (b, h, tq, tk, d) in STAGE3_768_ROWS:
        assert fa.fwd_tile_rows(q) == STAGE3_768_ROWS[(b, h, tq, tk, d)]
    first = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    again = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_dispatch_on_cuda_launches_kernel_only_unmasked():
    _need_cuda()
    q = torch.randn(2, 4, 77, 16, device="cuda")
    before = fa.launches.count
    dot_product_attention(q, q, q)
    assert fa.launches.count == before + 1
    mask = torch.ones(77, 77, dtype=torch.bool, device="cuda").tril()
    dot_product_attention(q, q, q, mask=mask[None, None])
    assert fa.launches.count == before + 1


def _tol_grad(dtype, ref):
    """float32: both sides accumulate in float32 in other orders, over up
    to Tq or Tk terms, so 1e-4 of the largest gradient (plus 1e-5 for
    gradients near zero).  bfloat16 adds one bf16 ulp at the reference's
    largest value: each side rounds its float32 gradient once."""
    m = ref.float().abs().max().item()
    tol = 1e-4 * m + 1e-5
    return tol if dtype == torch.float32 else tol + 2.0 ** -7 * m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 8, 300, 77, 40),      # ragged Tq and cross-attention Tk, d=40
    (2, 8, 300, 77, 80),      # Tk = 77 at d=80
    (2, 8, 300, 77, 160),     # Tk = 77 at d=160
    (1, 3, 65, 64, 160),      # ragged Tq, d=160
    (1, 2, 130, 200, 80),     # ragged both ways, d=80
    (2, 2, 1, 77, 40),        # one query
    (1, 2, 33, 9, 80),        # fewer keys than one 16-row step
    (1, 4, 100, 130, 40),     # Tq not a multiple of 16 or 64
    (1, 2, 70, 50, 20),       # d not a multiple of 8: staged by plain loads
    (4, 8, 1024, 1000, 80),   # 64-row tiles at d=80, ragged Tk
    (2, 8, 1100, 1100, 160),  # 64-row tiles at d=160, ragged both ways
    (1, 8, 4096, 4096, 40),   # the 64^2 self-attention at B1
    (5, 1, 4096, 4096, 512),  # the VAE mid-block at the stage-1 batch
    (2, 1, 1000, 1000, 512),  # d = 512, ragged Tq and Tk
    (1, 2, 77, 50, 300),      # d = 512 kernels at a narrower head dim
])
def test_flash_bwd_kernels_match_plain(dtype, b, h, tq, tk, d):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(tq + d)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
               for t in (tq, tk, tk))
    do = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dtype)
    o, lse = fa.flash_attention_plain(q, k, v, d ** -0.5)
    counts = (fa.dq_launches.count, fa.dkv_launches.count)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.dq_launches.count, fa.dkv_launches.count) == (
        counts[0] + 1, counts[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == r.shape
        err = (g.float() - r.float()).abs().max().item()
        assert err <= _tol_grad(dtype, r), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d,dtype", [
    (1, 8, 4096, 4096, 40, torch.bfloat16),   # 64-row tiles, a warp per rows
    (2, 8, 300, 77, 160, torch.bfloat16),     # 16-row tiles, warps' partials
    (5, 1, 4096, 4096, 512, torch.bfloat16),  # d = 512: partial scores
    (2, 1, 1000, 1000, 512, torch.bfloat16),  # d = 512, ragged
    (5, 1, 4096, 4096, 512, torch.float32),   # d = 512 float32 (3xTF32)
    (2, 1, 1000, 1000, 512, torch.float32),   # d = 512 float32, ragged
])
def test_flash_bwd_is_deterministic(b, h, tq, tk, d, dtype):
    """No sum crosses blocks and the warps' partial sums are added in a
    fixed order, so two calls give the same bits: bf16, and float32 on the
    d = 512 tensor-core kernels."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_bwd_refuses_wide_heads_on_cuda():
    """Head dims above 512 are refused (d = 512 has kernels of its own)."""
    _need_cuda()
    q = torch.randn(1, 1, 16, 513, device="cuda")
    o, lse = fa.flash_attention_plain(q, q, q, 513 ** -0.5)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, o, lse, torch.randn_like(q), 0.05)


@pytest.mark.cuda
def test_gradient_through_dot_product_attention_on_cuda():
    """Gradients reach every attention input on the card (the autograd
    function's backward is the kernels) and equal the plain path's on the
    CPU."""
    _need_cuda()
    gen = torch.Generator().manual_seed(7)
    cpu = [torch.randn(2, 4, 100, 40, generator=gen) for _ in range(2)] + \
        [torch.randn(2, 4, 77, 40, generator=gen) for _ in range(2)]
    q, do = cpu[0], cpu[1]
    k, v = cpu[2], cpu[3]
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (q, k, v)]
        out = dot_product_attention(*leaves)
        out.backward(do.to(dev))
        grads[dev] = [t.grad.cpu() for t in leaves]
    for g_cuda, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_cuda.abs().max() > 0
        assert (g_cuda - g_cpu).abs().max().item() <= _tol_grad(
            torch.float32, g_cpu)


def _inject_args(b, dtype, wdtype, seed=3):
    """A latent [b, 4, 64, 64] of `dtype` and a 48-bit message with
    SecretEncoder weights of `wdtype` (the PPFT trainer keeps them in bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    latent = rnd(b, 4, 64, 64).to(dtype)
    msg = torch.bernoulli(torch.full((b, 48), 0.5, device="cuda"),
                          generator=gen)
    return (latent, msg, *(w.to(wdtype) for w in (
        0.2 * rnd(1024, 48), 0.1 * rnd(1024), 0.1 * rnd(4, 4, 3, 3),
        0.1 * rnd(4))))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 8])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_secret_inject_kernel_matches_plain(dtype, wdtype, b):
    """One bf16 ulp at the output's largest value for a bf16 latent (both
    sides compute in float32 from the same weights and round once), float32
    sums in other orders otherwise."""
    from aqualora_torch.ops import secret_inject as si

    _need_cuda()
    args = _inject_args(b, dtype, wdtype)
    before = si.launches.count
    out = si.fused_secret_inject(*args, base_res=32)
    ref = si.inject_plain(*args, base_res=32)
    torch.cuda.synchronize()
    assert si.launches.count == before + 1 and out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else \
        2.0 ** -7 * ref.float().abs().max().item() + 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_secret_inject_is_one_cuda_kernel():
    """One `fused_secret_inject` call at the PPFT shape (B8, bf16 latent and
    weights) runs exactly one CUDA kernel on the card, the injection's."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.ops import secret_inject as si

    _need_cuda()
    args = _inject_args(8, torch.bfloat16, torch.bfloat16)
    si.fused_secret_inject(*args, base_res=32)       # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        si.fused_secret_inject(*args, base_res=32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "secret_inject_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_stage1_tiny_step_card_matches_cpu():
    """The tiny stage-1 loss and every trainable's gradient on the card
    (kernels) against the CPU (plain versions), the same weights and
    draws, float32, for each of the six stage-1 distortions: the loss to
    1e-4 relative, each gradient to 1e-3 of its leaf's largest value plus
    1e-5 of the module's (the card sums in other orders through the VAE,
    LPIPS and the decoder; leaves with an exact gradient of 0, the
    decoder's project BatchNorm biases, read float32 noise)."""
    from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                            WatermarkConfig)
    from aqualora_torch.train import latent_wm_pretrain as tt

    _need_cuda()
    pixels = torch.rand(2, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(4)).numpy() * 2 - 1
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = tt.build_models(VAEConfig.tiny(), WatermarkConfig.tiny(),
                                      EfficientNetConfig.tiny(), dev)
    tt.init_models(models["cpu"], 5)
    with torch.no_grad():     # a non-zero encoder conv: every gradient lives
        w = models["cpu"].sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, generator=torch.Generator()
                                  .manual_seed(6)))
    for part in ("vae", "lpips", "sec_encoder", "sec_decoder"):
        getattr(models["cuda"], part).load_state_dict(
            getattr(models["cpu"], part).state_dict())
    gen = torch.Generator().manual_seed(7)
    for index in range(6):
        probs = [float(i == index) for i in range(6)]
        draws = tt.draw(models["cpu"], gen, (2, 3, 64, 64), probs)
        out = {}
        for dev, m in models.items():
            m.sec_encoder.zero_grad(set_to_none=True)
            m.sec_decoder.zero_grad(set_to_none=True)
            x = torch.from_numpy(pixels).to(dev).permute(0, 3, 1, 2)
            before = (fa.launches.count, fa.dq_launches.count,
                      fa.dkv_launches.count)
            loss, _ = tt.make_loss_fn(m)(x, draws.to(dev), tt.Control())
            loss.backward()
            after = (fa.launches.count, fa.dq_launches.count,
                     fa.dkv_launches.count)
            if dev == "cuda":
                assert [a - b for a, b in zip(after, before)] == [3, 1, 1]
            out[dev] = (loss.item(), {
                part: {n: p.grad.cpu() for n, p in
                       getattr(m, part).named_parameters()}
                for part in ("sec_encoder", "sec_decoder")})
        (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
        assert l_cpu > 0 and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
        for part, grads in g_cpu.items():
            part_max = max(g.abs().max().item() for g in grads.values())
            for name, g in grads.items():
                tol = 1e-3 * g.abs().max().item() + 1e-5 * part_max
                err = (g_gpu[part][name] - g).abs().max().item()
                assert err <= tol, (index, part, name, err, tol)


@pytest.mark.cuda
def test_jpeg_roundtrip_card_equals_cpu():
    """libjpeg's round trip in integer torch ops (`eval/jpeg.py`) gives the
    same bits on the card as on the CPU: noise and a smooth image at the
    protocol's B8 512^2, and a ragged 37x45 batch, at qualities 50 and
    10."""
    from aqualora_torch.eval.jpeg import jpeg_roundtrip

    _need_cuda()
    gen = torch.Generator().manual_seed(12)
    noise = torch.randint(0, 256, (4, 512, 512, 3), generator=gen,
                          dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(512.0), torch.arange(512.0),
                            indexing="ij")
    smooth = torch.stack([(torch.sin(yy / 40 + c) * 0.5 + 0.5) * xx / 2
                          for c in range(3)], -1).to(torch.uint8)
    batch = torch.cat([noise, smooth.expand(4, -1, -1, -1)])
    ragged = torch.randint(0, 256, (3, 37, 45, 3), generator=gen,
                           dtype=torch.uint8)
    for images in (batch, ragged):
        for quality in (50, 10):
            card = jpeg_roundtrip(images.cuda(), quality)
            assert card.is_cuda
            assert torch.equal(card.cpu(), jpeg_roundtrip(images, quality))


@pytest.mark.cuda
def test_img2img_tiny_card_matches_cpu_and_launches():
    """The tiny SDEdit call on the card (kernels) against the CPU (plain
    versions), the same weights and draws, float32, at strength 0.1 and
    0.2 of 10 steps: images within 2e-3, and the forward kernel launched
    once in the VAE encoder, once in the decoder and a U-Net evaluation's
    worth for each denoising step (32 + 2 at SD-1.5's width for 0.1)."""
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core.tokenizer import load_tokenizer
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline

    _need_cuda()
    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(12)
    pipes["cuda"].load_state_from(pipes["cpu"])
    tok = load_tokenizer(None, vocab_size=cfg.clip.vocab_size)
    ids, neg = tok(["masterpiece"] * 2), tok([""] * 2)
    gen = torch.Generator().manual_seed(12)
    images = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    draws = {k: torch.randn(2, 16, 16, 4, generator=gen)
             for k in ("posterior_noise", "noise")}
    # a U-Net evaluation's launches: one DDIM step's generate less the VAE's
    before = fa.launches.count
    pipes["cuda"].make_generate(1, "ddim", 32, 32)(
        ids, neg, z=torch.randn(2, 16, 16, 4, generator=gen))
    per_eval = fa.launches.count - before - 1
    assert per_eval > 0
    for strength, eff in ((0.1, 1), (0.2, 2)):
        out = {}
        for dev, pipe in pipes.items():
            before = fa.launches.count
            out[dev] = pipe.make_img2img(10, strength, 32, 32)(
                images, ids, neg, **draws).cpu()
            launched = fa.launches.count - before
        assert launched == 2 + eff * per_eval, (strength, launched)
        assert (out["cuda"] - out["cpu"]).abs().max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d", [
    (4, 12, 197, 64),     # DreamSim's ViT-B/16 ensemble, d = 64 masked
    (8, 12, 50, 64),      # ViT-B/32, one ragged tile
    (4, 16, 197, 64),     # MAE ViT-L/16
    (4, 16, 257, 80),     # MAE ViT-H/14
])
def test_flash_kernel_float32_at_the_vit_shapes(b, h, t, d):
    """The float32 CUDA-core forward at DreamSim's shapes: O and lse
    against the plain version, two calls bit-identical."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(t * d)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    again = fa.flash_attention_fwd(q, k, v, d ** -0.5)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, d ** -0.5)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert (o - o_ref).abs().max().item() <= TOL_F32
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.cuda
def test_fidelity_extractors_card_match_cpu():
    """InceptionV3 and a narrow DreamSim ensemble (seeded random weights)
    on the card against the CPU, with TF32 allowed around the calls: the
    extractors compute in float32 themselves and give the flags back."""
    import numpy as np

    from aqualora_torch.eval.dreamsim import DreamSim
    from aqualora_torch.eval.fid import InceptionExtractor

    _need_cuda()
    rng = np.random.default_rng(0)
    imgs = rng.random((3, 96, 80, 3), dtype=np.float32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    card = InceptionExtractor(device="cuda")(imgs, batch_size=2)
    ref = InceptionExtractor(device="cpu")(imgs, batch_size=2)
    assert np.abs(card - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-5
    over = {"dim": 64, "depth": 2, "heads": 2}
    before = fa.launches.count
    d_card = DreamSim(vit_overrides=over, device="cuda")(imgs, imgs[::-1])
    assert fa.launches.count == before + 2 * 3 * 2
    d_cpu = DreamSim(vit_overrides=over, device="cpu")(imgs, imgs[::-1])
    assert np.abs(d_card - d_cpu).max() <= 1e-5
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
