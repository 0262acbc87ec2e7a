"""The port's flash-attention forward against the JAX package.

The plain version (`flash_attention_plain`, what a CPU tensor runs) is held
against the Pallas kernel in interpret mode and against `_xla_attention`;
the CUDA kernel itself is held against the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from aqualora_torch.ops import flash_attention as fa
from aqualora_torch.ops.attention import dot_product_attention


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


@contextlib.contextmanager
def _interpret_pallas():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp_call
    try:
        yield
    finally:
        pl.pallas_call = orig


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, t, d), dtype=np.float32)
                 for t in (tq, tk, tk))


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_pallas_interpret(d):
    """O and the row logsumexp of the Pallas forward (interpret mode) equal
    the port's plain version within 2e-5 (float32)."""
    import aqualora_tpu.ops.flash_attention as F

    q, k, v = _qkv(d, 1, 2, 256, 384, d)
    scale = d ** -0.5
    with _interpret_pallas():
        out, lse = F._flash_forward(jax.numpy.asarray(q), jax.numpy.asarray(k),
                                    jax.numpy.asarray(v), scale,
                                    need_lse=True)
    o_t, lse_t = fa.flash_attention_plain(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(out), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse)[..., 0],
                               atol=2e-5)


@pytest.mark.parametrize("d,tq,tk", [(40, 64, 77), (80, 96, 77),
                                     (40, 50, 50), (160, 16, 77)])
def test_plain_matches_xla_attention(d, tq, tk):
    """The SD-1.5 head dims and the 77-token cross-attention, which the
    Pallas kernel does not take, against `_xla_attention`."""
    from aqualora_tpu.ops.attention import _xla_attention

    q, k, v = _qkv(tq + d, 2, 3, tq, tk, d)
    scale = d ** -0.5
    ref = _xla_attention(jax.numpy.asarray(q), jax.numpy.asarray(k),
                         jax.numpy.asarray(v), None, scale)
    o_t, _ = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(ref), atol=2e-5)


def test_masked_dispatch_matches_xla_attention():
    """CLIP's causal mask goes to the plain path, `_xla_attention`'s
    counterpart, and never to the kernel."""
    from aqualora_tpu.ops.attention import _xla_attention

    q, k, v = _qkv(3, 2, 4, 77, 77, 16)
    mask = np.tril(np.ones((77, 77), bool))[None, None]
    ref = _xla_attention(jax.numpy.asarray(q), jax.numpy.asarray(k),
                         jax.numpy.asarray(v), jax.numpy.asarray(mask),
                         0.25)
    before = fa.launches.count
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                mask=torch.from_numpy(mask), scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert fa.launches.count == before


def test_wrapper_on_cpu_takes_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 33, 77, 40))
    before = fa.launches.count
    o, lse = fa.flash_attention_fwd(q, k, v, 0.2)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, 0.2)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert lse.shape == (1, 2, 33) and lse.dtype == torch.float32
    assert fa.launches.count == before       # no kernel launch on the CPU
    out = dot_product_attention(q, k, v, scale=0.2)
    assert torch.equal(out, o_ref)


def test_fwd_tile_rows_refuses_a_cpu_query():
    """The tiling is the CUDA kernel's decision: a CPU tensor has none."""
    q = torch.zeros(1, 2, 33, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.fwd_tile_rows(q)


@pytest.mark.parametrize("case", ["rank", "dtype", "mixed_dtype", "head_dim",
                                  "contiguity", "kv_shape", "scale"])
def test_wrapper_rejects_unsupported_input(case):
    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 2, 8, 16)
    v = torch.randn(1, 2, 8, 16)
    if case == "rank":
        q, k, v = q[0], k[0], v[0]
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "head_dim":
        q, k, v = (torch.randn(1, 1, 4, 520) for _ in range(3))
    elif case == "contiguity":
        q = torch.randn(1, 8, 2, 16).transpose(1, 2)
    elif case == "kv_shape":
        v = torch.randn(1, 2, 9, 16)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_fwd(q, k, v, -0.25 if case == "scale" else 0.25)


def _autograd_grads(q, k, v, g, scale, fn):
    """dq, dk, dv of <fn(q, k, v), g> through torch autograd."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(q, k, v, scale)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()


def test_bwd_plain_matches_pallas_interpret():
    """dq, dk, dv of the Pallas backward kernels (`_fa_fwd` / `_fa_bwd` in
    interpret mode, the shapes of tests/test_ops.py) against the port's
    `flash_attention_bwd_plain` and against autograd through
    `FlashAttention` on the CPU, atol 1e-4 as the JAX test holds them."""
    import aqualora_tpu.ops.flash_attention as F

    q, k, v = _qkv(11, 1, 2, 256, 128, 64)
    g = np.random.default_rng(12).standard_normal(q.shape, dtype=np.float32)
    scale = 64 ** -0.5
    with _interpret_pallas():
        out, res = F._fa_fwd(*map(jax.numpy.asarray, (q, k, v)), scale)
        ref = F._fa_bwd(scale, res, jax.numpy.asarray(g))
    o, lse = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      scale)
    plain = fa.flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v)),
                                         o, lse, torch.from_numpy(g), scale)
    t_out, *auto = _autograd_grads(q, k, v, g, scale, fa.flash_attention)
    np.testing.assert_allclose(t_out, np.asarray(out), atol=2e-5)
    for want, p, a in zip(ref, plain, auto):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(a, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("d,tq,tk", [(40, 64, 77), (80, 96, 77),
                                     (160, 16, 77)])
def test_bwd_matches_xla_vjp(d, tq, tk):
    """The SD-1.5 head dims at the 77-token cross-attention, which the
    Pallas kernels do not take: autograd through `dot_product_attention`
    (the `FlashAttention` function, plain backward on the CPU) against
    `jax.vjp` of `_xla_attention`."""
    from aqualora_tpu.ops.attention import _xla_attention

    q, k, v = _qkv(tq + d + 1, 2, 3, tq, tk, d)
    g = np.random.default_rng(d).standard_normal(q.shape, dtype=np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, None, scale),
                     *map(jax.numpy.asarray, (q, k, v)))
    ref = vjp(jax.numpy.asarray(g))
    _, *got = _autograd_grads(
        q, k, v, g, scale,
        lambda q, k, v, s: dot_product_attention(q, k, v, scale=s))
    for want, a in zip(ref, got):
        np.testing.assert_allclose(a, np.asarray(want), atol=1e-4)


def test_bwd_wrapper_on_cpu_takes_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(13, 1, 2, 33, 77, 40))
    o, lse = fa.flash_attention_plain(q, k, v, 0.2)
    do = torch.randn_like(q)
    counts = (fa.dq_launches.count, fa.dkv_launches.count)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, 0.2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.dq_launches.count, fa.dkv_launches.count) == counts


@pytest.mark.parametrize("case", ["head_dim", "lse_shape", "do_dtype"])
def test_bwd_wrapper_rejects_unsupported_input(case):
    """d > 512 is refused (the VAE mid-block's d = 512, differentiated in
    stage 1, is the largest head dim of the port), as are a mis-shaped lse
    and a dO of another type."""
    d = 513 if case == "head_dim" else 16
    q, k, v = (torch.randn(1, 2, 8, d) for _ in range(3))
    o, lse = fa.flash_attention_plain(q, k, v, 0.25)
    do = torch.randn_like(q)
    if case == "lse_shape":
        lse = lse[..., :4].contiguous()
    elif case == "do_dtype":
        do = do.bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do, 0.25)


def test_no_grad_call_is_one_forward():
    """Without an input that requires grad, `flash_attention` is the
    forward alone: no graph, the plain forward's values."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(14, 1, 2, 20, 30, 40))
    out = fa.flash_attention(q, k, v, 0.3)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, 0.3)[0])


def _bf16_kernel_arithmetic(q, k, v, do, lse, delta, scale):
    """What the bf16 backward kernels compute: bf16 inputs, S and dP summed
    in float32, P and dS rounded to bf16 as the operands of the dQ, dK and
    dV products, float32 sums, each gradient rounded to bf16 once."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    return ((ds16 @ kf * scale).bfloat16(),
            (ds16.transpose(-1, -2) @ qf * scale).bfloat16(),
            (p16.transpose(-1, -2) @ dof).bfloat16())


@pytest.mark.parametrize("tk", [256, 77])
@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_bf16_operand_rounding_fits_grad_tolerance(d, tk):
    """Rounding P and dS to bf16 (the one rounding the tensor-core kernels
    add) keeps dq, dk, dv within the card's bf16 gradient limit of
    `flash_attention_bwd_plain`, which test_bwd_plain_matches_pallas_interpret
    ties to the Pallas backward: 1e-4 of the largest gradient + 1e-5, plus one
    bf16 ulp (2^-7) at that gradient."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(d + tk, 1, 2, 256, tk, d))
    do = torch.from_numpy(np.random.default_rng(d).standard_normal(
        q.shape, dtype=np.float32)).bfloat16()
    scale = d ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    delta = fa.attention_delta(o, do)
    got = _bf16_kernel_arithmetic(q, k, v, do, lse, delta, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        m = r.float().abs().max().item()
        tol = 1e-4 * m + 1e-5 + 2.0 ** -7 * m
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def _bf16_fwd_kernel_arithmetic(q, k, v, scale, key_tile):
    """What the bf16 forward kernels compute, tile by tile over `key_tile`
    keys: bf16 inputs, S summed in float32, the running max and sum in
    float32 (log2 units), P rounded to bf16 as the operand of O += P V (the
    sum l is taken from the unrounded P), O rounded to bf16 once."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale_log2 = scale * 1.4426950408889634
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, k.shape[2], key_tile):
        s = qf @ kf[:, :, k0:k0 + key_tile].transpose(-1, -2) * scale_log2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + (
            p.bfloat16().float() @ vf[:, :, k0:k0 + key_tile])
        m = m_new
    return (acc / l[..., None]).bfloat16(), m * np.log(2.0) + torch.log(l)


@pytest.mark.parametrize("tk", [77, 256])
@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_fwd_bf16_operand_rounding_fits_o_tolerance(d, tk):
    """Rounding P to bf16 (the one rounding the tensor-core forward adds)
    keeps O within the card's bf16 O limit of `flash_attention_plain`,
    which test_plain_matches_pallas_interpret ties to the Pallas kernel: one
    bf16 ulp at the largest |O| (2^-7 of it) + 1e-4; lse within 1e-4.  Key
    tiles as in csrc/flash_fwd.cu's wide query tiles: 64 keys at d = 40,
    32 at d >= 80."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(d + tk + 1, 1, 2, 256, tk, d))
    scale = d ** -0.5
    o, lse = _bf16_fwd_kernel_arithmetic(q, k, v, scale,
                                         64 if d <= 40 else 32)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    tol = 2.0 ** -7 * o_ref.float().abs().max().item() + 1e-4
    err = (o.float() - o_ref.float()).abs().max().item()
    assert err <= tol, (err, tol)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def _tf32(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest, ties away
    from zero, 10 mantissa bits.  A float32 is sign and magnitude, so adding
    half a TF32 ulp to its bits and clearing the 13 low ones rounds the
    magnitude."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_mma(acc, a, b, split):
    """acc + a @ b as the float32 d = 512 kernels' tensor-core products do
    it: with `split`, 3xTF32 (x = hi + lo, hi = tf32(x), lo = tf32(x - hi)),
    the small terms first: a_lo b_hi, a_hi b_lo, a_hi b_hi, each added to the
    float32 sum; without, one TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if split:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        acc = acc + al @ bh
        acc = acc + ah @ bl
    return acc + ah @ bh


def _f32_d512_kernel_arithmetic(q, k, v, do, lse, delta, scale, split):
    """What csrc/flash_bwd.cu's float32 d = 512 kernels compute: S and dP
    as four partials over 128-column quarters of the head dim (one a warp),
    added in warp order; P = 2^(S scale log2e - L log2e) and dS = P o (dP -
    delta) in float32; then dQ += dS K, dK += dS^T Q and dV += P^T dO over
    streamed tiles of 16 rows.  Every product is `_tf32_mma`."""
    log2e = 1.4426950408889634
    sl = scale * log2e

    def scores(a, b):
        parts = [_tf32_mma(0.0, a[..., c:c + 128],
                           b[..., c:c + 128].transpose(-1, -2), split)
                 for c in range(0, a.shape[-1], 128)]
        return ((parts[0] + parts[1]) + parts[2]) + parts[3]

    def accumulate(x, y):
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:])
        for t0 in range(0, y.shape[-2], 16):
            acc = _tf32_mma(acc, x[..., t0:t0 + 16], y[..., t0:t0 + 16, :],
                            split)
        return acc

    l2, dl = lse * log2e, delta
    # dQ kernel: own rows are queries, keys stream
    p = torch.exp2(scores(q, k) * sl - l2[..., None])
    ds = p * (scores(do, v) - dl[..., None])
    dq = accumulate(ds, k) * scale
    # dK/dV kernel: own rows are keys, queries stream (S^T, dP^T)
    pt = torch.exp2(scores(k, q) * sl - l2[..., None, :])
    dst = pt * (scores(v, do) - dl[..., None, :])
    return dq, accumulate(dst, q) * scale, accumulate(pt, do)


_D512_SHAPES = [(256, 256), (200, 200), (256, 200), (200, 256)]


@pytest.fixture(scope="module")
def d512_cases():
    """Seeded float32 inputs at d = 512, H = 1 and the JAX package's forward
    (O, lse) and backward (dq, dk, dv) for each (Tq, Tk) of _D512_SHAPES:
    the Pallas kernels in interpret mode where they take the shape (Tq, Tk
    multiples of 128), else `_xla_attention`, its logsumexp and its
    `jax.vjp` (the Pallas kernels refuse a ragged length)."""
    import aqualora_tpu.ops.flash_attention as F
    from aqualora_tpu.ops.attention import _xla_attention

    d, scale, cases = 512, 512 ** -0.5, {}
    for tq, tk in _D512_SHAPES:
        q, k, v = _qkv(tq + tk, 1, 1, tq, tk, d)
        g = np.random.default_rng(tq * tk).standard_normal(
            q.shape, dtype=np.float32)
        jq, jk, jv, jg = map(jax.numpy.asarray, (q, k, v, g))
        if tq % 128 == 0 and tk % 128 == 0:
            with _interpret_pallas():
                out, res = F._fa_fwd(jq, jk, jv, scale)
                ref = F._fa_bwd(scale, res, jg)
            lse = res[4][..., 0]
        else:
            out, vjp = jax.vjp(
                lambda q, k, v: _xla_attention(q, k, v, None, scale),
                jq, jk, jv)
            ref = vjp(jg)
            lse = jax.nn.logsumexp(
                jax.numpy.einsum("bhqd,bhkd->bhqk", jq, jk,
                                 precision="highest") * scale, axis=-1)
        cases[(tq, tk)] = ((q, k, v, g), [np.asarray(r) for r in ref],
                           (np.asarray(out), np.asarray(lse)))
    return cases


def _d512_errors(case, split):
    """Each gradient's max |error| of the emulated kernel arithmetic against
    the JAX reference, over its limit 1e-4 max|g| + 1e-5."""
    (q, k, v, g), ref, _ = case
    q, k, v, do = map(torch.from_numpy, (q, k, v, g))
    scale = 512 ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    delta = fa.attention_delta(o, do)
    got = _f32_d512_kernel_arithmetic(q, k, v, do, lse, delta, scale, split)
    ratios = {}
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        tol = 1e-4 * np.abs(r).max() + 1e-5
        ratios[name] = np.abs(x.numpy() - r).max() / tol
    return ratios


@pytest.mark.parametrize("tq,tk", _D512_SHAPES)
def test_fp32_d512_3xtf32_arithmetic_fits_grad_tolerance(d512_cases, tq, tk):
    """The float32 d = 512 kernels' arithmetic (3xTF32 products, partial
    scores added in warp order, 16-row streamed tiles, ragged lengths) keeps
    dq, dk, dv within the card's float32 limit of the JAX backward:
    1e-4 of the largest gradient + 1e-5."""
    ratios = _d512_errors(d512_cases[(tq, tk)], split=True)
    assert max(ratios.values()) <= 1.0, ratios


def test_fp32_d512_one_pass_tf32_misses_grad_tolerance(d512_cases):
    """Why the split: the same arithmetic with one TF32 product (10 mantissa
    bits an operand) misses that limit."""
    ratios = _d512_errors(d512_cases[(256, 256)], split=False)
    assert max(ratios.values()) > 1.0, ratios


def _f32_d512_fwd_kernel_arithmetic(q, k, v, scale, split):
    """What csrc/flash_fwd.cu's float32 d = 512 forward computes, tile by
    tile over 16 keys: S as four partials over 128-column quarters of the
    head dim (one a warp), added in warp order; the online softmax in log2
    units in float32; P kept in float32 (no rounding) and l summed from it;
    O = alpha O + P V.  Every product is `_tf32_mma`."""
    sl = scale * 1.4426950408889634
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], 16):
        kt, vt = k[:, :, k0:k0 + 16], v[:, :, k0:k0 + 16]
        parts = [_tf32_mma(0.0, q[..., c:c + 128],
                           kt[..., c:c + 128].transpose(-1, -2), split)
                 for c in range(0, q.shape[-1], 128)]
        s = (((parts[0] + parts[1]) + parts[2]) + parts[3]) * sl
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = _tf32_mma(acc * alpha[..., None], p, vt, split)
        m = m_new
    return acc / l[..., None], m * np.log(2.0) + torch.log(l)


def _d512_fwd_errors(case, split):
    """max |error| of the emulated forward's O and lse against the JAX
    forward, each over its float32 limit of 1e-4."""
    (q, k, v, _), _, (o_ref, lse_ref) = case
    o, lse = _f32_d512_fwd_kernel_arithmetic(
        *map(torch.from_numpy, (q, k, v)), 512 ** -0.5, split)
    return {"o": np.abs(o.numpy() - o_ref).max() / 1e-4,
            "lse": np.abs(lse.numpy() - lse_ref).max() / 1e-4}


@pytest.mark.parametrize("tq,tk", _D512_SHAPES)
def test_fp32_d512_fwd_3xtf32_arithmetic_fits_o_tolerance(d512_cases, tq, tk):
    """The float32 d = 512 forward's arithmetic (3xTF32 products, partial
    scores added in warp order, 16-key tiles, P in float32, ragged lengths)
    keeps O and lse within the card's float32 limit (1e-4) of the JAX
    forward."""
    ratios = _d512_fwd_errors(d512_cases[(tq, tk)], split=True)
    assert max(ratios.values()) <= 1.0, ratios


def test_fp32_d512_fwd_one_pass_tf32_misses_o_tolerance(d512_cases):
    """Why the forward splits too: the same arithmetic with one TF32 product
    (10 mantissa bits an operand) misses the O limit."""
    ratios = _d512_fwd_errors(d512_cases[(256, 256)], split=False)
    assert max(ratios.values()) > 1.0, ratios
