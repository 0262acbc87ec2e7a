"""Blockwise 8-bit AdamW (`--use_8bit_adam`), in PyTorch.

The port of `aqualora_tpu/train/adamw8bit.py:1-115`: AdamW whose first and
second moments are kept as int8 codes with one float32 scale per block of
256 elements, symmetric linear codes for m, non-negative ones for v (stored
offset by -128 so both fit int8).  The state is about a quarter of
float32 moments: at rank 320, 0.26 GiB beside 1.0 GiB.

The codes and scales equal the JAX function's bit for bit, which takes:

- blocks per parameter: each parameter is zero-padded to a whole number of
  blocks (`:45-58`), so no block spans two parameters;
- the JAX expressions in their order, one rounding per operation
  (`b1 * m + (1 - b1) * g`, `b2 * v + (1 - b2) * g * g`, `max / 127`),
  round half to even (`torch.round` as `jnp.round`), the scale's floor of
  1e-12, and every division a quotient (`_div`), on the card too.  That is the JAX function op by op; XLA's jit on the CPU contracts
  the multiply-adds into FMAs and turns `/ 127` into `* (1 / 127)`, which
  moves a few scales in 10^4 by one ulp;
- the learning rate at the update count before the increment (`:83-87`,
  what `LambdaLR` stepped after the optimizer gives), the bias corrections
  at the count after it, in float32, and the weight decay inside the
  update (`:96`).

The update runs on flat buffers: a group's parameters are cut into chunks
of at most `CHUNK` padded elements, and each chunk's gradients and values
are gathered into one padded float32 buffer (`torch.cat`), updated with a
few dozen whole-buffer operations and added back (`torch._foreach_add_`).
Per parameter, the 384 LoRA tensors of SD-1.5 would cost some 8,000 kernel
launches a step.  A chunk's state (its count, codes and scales) lives
under its first parameter in `self.state`, so `state_dict` is the base
class's.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

BLOCK = 256
CHUNK = 1 << 25          # padded elements of one flat buffer (128 MiB f32)


def padded(n: int) -> int:
    return n + (-n) % BLOCK


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded once.  The divisor is a tensor on x's device: CUDA
    divides by a Python scalar as a product with its reciprocal, which is
    not always the quotient's float32 rounding (the CPU divides)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize(flat: torch.Tensor, signed: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 vector of whole blocks -> (int8 codes [blocks, 256],
    float32 scales [blocks, 1])."""
    blocks = flat.view(-1, BLOCK)
    if signed:
        scale = _div(blocks.abs().amax(-1, keepdim=True), 127.0)
    else:
        scale = _div(blocks.amax(-1, keepdim=True), 255.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.round(blocks / scale).clamp_(-127 if signed else 0,
                                           127 if signed else 255)
    if not signed:
        q = q - 128
    return q.to(torch.int8), scale


def dequantize(code: torch.Tensor, scale: torch.Tensor,
               signed: bool) -> torch.Tensor:
    vals = code.float()
    if not signed:
        vals = vals + 128
    return (vals * scale).view(-1)


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta^count in float32, as JAX computes it (`:85-86`): an
    element whose v quantized to 0 moves by m / c1 / eps, where a double
    c1 would be off by up to 1e-7 relative."""
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1 - b ** torch.tensor(float(count)))


class AdamW8bit(torch.optim.Optimizer):
    """`optax.adamw` with int8 blockwise moments (see the module
    docstring).  Every parameter must be float32."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def chunks(group) -> List[List[torch.Tensor]]:
        """The group's parameters in runs of at most `CHUNK` padded
        elements (a larger parameter alone)."""
        out, size = [], CHUNK
        for p in group["params"]:
            if size + padded(p.numel()) > CHUNK:
                out.append([])
                size = 0
            out[-1].append(p)
            size += padded(p.numel())
        return out

    @staticmethod
    def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
        """The tensors' float32 values, each zero-padded to whole blocks,
        in one buffer."""
        zeros = tensors[0].new_zeros(BLOCK, dtype=torch.float32)
        parts = []
        for t in tensors:
            parts.append(t.reshape(-1).float())
            pad = (-t.numel()) % BLOCK
            if pad:
                parts.append(zeros[:pad])
        return torch.cat(parts)

    def load_state_dict(self, state_dict) -> None:
        # the base class casts every state tensor of a float32 parameter
        # to float32; the codes go back to int8 (exact)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("m_code", "v_code"):
                if k in st:
                    st[k] = st[k].to(torch.int8)

    def state_bytes(self) -> int:
        """Bytes of the codes and scales."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for params in self.chunks(group):
                st = self.state[params[0]]
                n = sum(padded(p.numel()) for p in params)
                if not st:
                    zero = torch.zeros(n, device=params[0].device)
                    st["step"] = 0
                    st["m_code"], st["m_scale"] = quantize(zero, True)
                    st["v_code"], st["v_scale"] = quantize(zero, False)
                st["step"] += 1
                c1, c2 = (_bias_correction(b, st["step"]) for b in (b1, b2))
                g = self._flat([p.grad if p.grad is not None
                                else torch.zeros_like(p) for p in params])
                m = b1 * dequantize(st["m_code"], st["m_scale"], True) \
                    + (1 - b1) * g
                v = b2 * dequantize(st["v_code"], st["v_scale"], False) \
                    + (1 - b2) * g * g
                upd = _div(m, c1) / (torch.sqrt(_div(v, c2)) + eps)
                delta = -lr * (upd + wd * self._flat(params))
                st["m_code"], st["m_scale"] = quantize(m, True)
                st["v_code"], st["v_scale"] = quantize(v, False)
                views = [d[:p.numel()].view_as(p) for p, d in zip(
                    params, delta.split([padded(p.numel()) for p in params]))]
                torch._foreach_add_(params, views)
