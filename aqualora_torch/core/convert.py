"""JAX parameter trees -> torch state dicts, without flax or JAX.

`jax_params_to_torch(params, batch_stats=None)` takes a model's parameter
tree as nested dicts of numpy arrays (what `jax.device_get` returns) and
gives the state dict that the port's module of the same name loads with
`load_state_dict(strict=True)`.  It reimplements the conversion of
`aqualora_tpu/core/io.py:73-157`:

- flax names fold list indices into the name (`down_blocks_0`); they become
  `down_blocks.0`, except the diffusers names whose `_N` is literal
  (`linear_1`, `conv_1`, ...);
- Dense kernels (in, out) become Linear weights (out, in); Conv kernels HWIO
  become OIHW; norm `scale` and `embedding` leaves become `weight`; the
  MapperNet's `bit_embeddings` table becomes `bit_embeddings.weight` (the
  reference's mapper.pt layout).

BatchNorm statistics (`batch_stats`, EfficientNet) become `running_mean` /
`running_var`, with the `num_batches_tracked` counter torch's BatchNorm
carries.  An EfficientNet tree (one with a `stem`) is renamed into
torchvision's layout (`features.N.M.block.K`), which the port's EfficientNet
follows so that the reference's `msgdecoder.pt` loads as it is.  An LPIPS
tree (one with `vgg/conv0`) is renamed into the lpips package's layout: the
VGG16 convolutions `vgg/convI` become `net.sliceS.N` (N torchvision's
feature index) and each lin weight [C, 1] becomes `linI.model.1.weight`
[1, C, 1, 1].

An InceptionV3 tree keeps torchvision's names as they stand
(`Mixed_6b/branch7x7_1` is `Mixed_6b.branch7x7_1`, whose `_1` is no
index).  A ViT tree (one with a `cls_token`) is renamed into DINO's layout:
`patch_embed` becomes `patch_embed.proj`, a block's `qkv` and `proj`
`attn.qkv` and `attn.proj`, its `fc1` and `fc2` `mlp.fc1` and `mlp.fc2`;
the CLIP projection `proj` [dim, proj_dim] stays as it is.  These are the
reverse of `tools/torch_import.py`'s readers.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from aqualora_torch.models.efficientnet import B0_STAGES
from aqualora_torch.models.lpips import vgg16_conv_indices

Path = Tuple[str, ...]

# names whose trailing _N is literal in diffusers (not a list index)
_PROTECTED = {"linear_1", "linear_2", "norm_1", "norm_2", "conv_1", "conv_2"}
# torchvision's InceptionV3 names, whose digits are no list index
_INCEPTION_NAME = re.compile(r"^(Conv2d_\w+|Mixed_\w+|branch\w+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(path: Path) -> str:
    """('down_blocks_0', 'attentions_1', 'to_out_0', 'weight') ->
    'down_blocks.0.attentions.1.to_out.0.weight'."""
    parts = []
    for p in path:
        if p in _PROTECTED or _INCEPTION_NAME.match(p):
            parts.append(p)
        else:
            parts.append(re.sub(r"_(\d+)$", r".\1",
                                re.sub(r"_(\d+)_", r".\1_", p)))
    return ".".join(parts)


def _leaf(path: Path, a: np.ndarray) -> Tuple[Path, np.ndarray]:
    head, leaf = path[:-1], path[-1]
    if leaf == "kernel":
        if a.ndim == 4:
            return head + ("weight",), np.transpose(a, (3, 2, 0, 1))
        return head + ("weight",), np.transpose(a, (1, 0))
    if leaf in ("scale", "embedding"):
        return head + ("weight",), a
    if leaf == "bit_embeddings":
        return path + ("weight",), a
    return path, a


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: torch cannot wrap it
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _efficientnet_renames(keys) -> Dict[str, str]:
    """Generic keys of every EfficientNet in `keys` -> torchvision keys."""
    out = {}
    for stem_key in [k for k in keys if k.endswith("stem.conv.weight")]:
        pre = stem_key[: -len("stem.conv.weight")]
        # B0-family stage 0 has no expand conv: [depthwise, se, project]
        names = {si: (["depthwise", "se", "project"] if er == 1 else
                      ["expand", "depthwise", "se", "project"])
                 for si, (er, *_rest) in enumerate(B0_STAGES)}
        rules = [(re.compile(re.escape(pre) + r"stem\.(conv|bn)\.(.*)$"),
                  lambda m: f"{pre}features.0.{_cba(m[1])}.{m[2]}"),
                 (re.compile(re.escape(pre) + r"head\.(conv|bn)\.(.*)$"),
                  lambda m: f"{pre}features.{len(B0_STAGES) + 1}."
                            f"{_cba(m[1])}.{m[2]}"),
                 (re.compile(re.escape(pre) + r"classifier\.(.*)$"),
                  lambda m: f"{pre}classifier.1.{m[1]}")]
        block = re.compile(re.escape(pre)
                           + r"blocks\.(\d+)\.(\d+)\.(\w+)\.(\w+)\.(.*)$")
        for k in keys:
            if not k.startswith(pre):
                continue
            m = block.match(k)
            if m:
                si, bi, part, sub, leaf = m.groups()
                idx = names[int(si)].index(part)
                tail = f"{sub}.{leaf}" if part == "se" else f"{_cba(sub)}.{leaf}"
                out[k] = (f"{pre}features.{int(si) + 1}.{bi}.block."
                          f"{idx}.{tail}")
                continue
            for rule, fmt in rules:
                m = rule.match(k)
                if m:
                    out[k] = fmt(m)
                    break
    return out


def _cba(sub: str) -> str:
    """conv/bn inside torchvision's Conv2dNormActivation."""
    return {"conv": "0", "bn": "1"}[sub]


def _lpips_layout(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every LPIPS tree in `out` (keys and arrays) -> the lpips layout."""
    stems = [k[: -len("vgg.conv0.weight")] for k in out
             if k.endswith("vgg.conv0.weight")]
    if not stems:
        return out
    slices = [(si + 1, idx) for si, stage in enumerate(vgg16_conv_indices())
              for idx in stage]
    moved: Dict[str, np.ndarray] = {}
    for k, a in out.items():
        pre = next((p for p in stems if k.startswith(p)), None)
        m = None if pre is None else re.fullmatch(
            r"vgg\.conv(\d+)\.(weight|bias)|lin(\d+)", k[len(pre):])
        if m is None:
            moved[k] = a
        elif m[1] is not None:
            si, idx = slices[int(m[1])]
            moved[f"{pre}net.slice{si}.{idx}.{m[2]}"] = a
        else:
            moved[f"{pre}lin{m[3]}.model.1.weight"] = a.T[:, :, None, None]
    return moved


_VIT_BLOCK = re.compile(r"(blocks\.\d+\.)(qkv|proj|fc1|fc2)\.(weight|bias)$")
_VIT_SUB = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2"}


def _vit_renames(keys) -> Dict[str, str]:
    """Generic keys of every ViT in `keys` -> DINO's keys."""
    out = {}
    for cls_key in [k for k in keys if k.endswith("cls_token")]:
        pre = cls_key[: -len("cls_token")]
        for k in keys:
            if not k.startswith(pre):
                continue
            rest = k[len(pre):]
            m = _VIT_BLOCK.fullmatch(rest)
            if m:
                out[k] = f"{pre}{m[1]}{_VIT_SUB[m[2]]}.{m[3]}"
            elif rest in ("patch_embed.weight", "patch_embed.bias"):
                out[k] = f"{pre}patch_embed.proj.{rest.split('.')[-1]}"
    return out


def torch_layout(params: Mapping, batch_stats: Optional[Mapping] = None
                 ) -> Dict[str, np.ndarray]:
    """Torch keys and numpy arrays in torch layout (transposed views, no
    copies), for a JAX parameter tree and its BatchNorm statistics."""
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params):
        path, a = _leaf(path, np.asarray(v))
        out[torch_key(path)] = a
    for path, v in _flatten(batch_stats or {}):
        out[torch_key(path[:-1] + (_STATS[path[-1]],))] = np.asarray(v)
        out[torch_key(path[:-1] + ("num_batches_tracked",))] = np.zeros(
            (), np.int64)
    renames = {**_efficientnet_renames(list(out)), **_vit_renames(list(out))}
    return _lpips_layout({renames.get(k, k): a for k, a in out.items()})


def jax_params_to_torch(params: Mapping,
                        batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (and BatchNorm statistics) -> torch state dict."""
    return {k: _tensor(a)
            for k, a in torch_layout(params, batch_stats).items()}
