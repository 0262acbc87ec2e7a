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


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 8, 300, 77, 40),      # ragged Tq, cross-attention Tk, d=40
    (1, 8, 1024, 1024, 80),
    (2, 3, 65, 64, 160),
    (1, 1, 200, 333, 512),    # VAE head dim, ragged lengths
    (1, 2, 7, 1, 3),          # one key, tiny head dim
])
def test_flash_kernel_matches_plain(dtype, b, h, tq, tk, d):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(tq * d)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
               for t in (tq, tk, tk))
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
def test_dispatch_on_cuda_launches_kernel_only_unmasked():
    _need_cuda()
    q = torch.randn(2, 4, 77, 16, device="cuda")
    before = fa.launches.count
    dot_product_attention(q, q, q)
    assert fa.launches.count == before + 1
    mask = torch.ones(77, 77, dtype=torch.bool, device="cuda").tril()
    dot_product_attention(q, q, q, mask=mask[None, None])
    assert fa.launches.count == before + 1
