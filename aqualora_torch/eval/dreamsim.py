"""DreamSim, the perceptual distance of the fidelity benchmark, in PyTorch.

The port of `aqualora_tpu/eval/dreamsim.py` (the reference's
`dreamsim/model.py:14-158` with the dims and model lists of
`dreamsim/config.py:1-43`):

  - 'ensemble' (what `run_dreamsim` runs): DINO ViT-B/16 ('cls' tap, 768),
    CLIP ViT-B/16 and OpenCLIP ViT-B/16 (DINO layout, 'embedding' tap, 512
    each), concatenated to 1792; the peft qkv-LoRA is folded into the
    imported weights, and the MLP head is the identity in LoRA mode;
  - the single-backbone types of `MODEL_CONFIGS`.

Each backbone normalises the images with its own mean and std (ImageNet for
DINO and MAE, CLIP's for both CLIP variants) after a bicubic resize to
`image_size` (`ops/resize.bicubic_resize`, `jax.image.resize`'s
antialiased bicubic).  Embeddings are unit-normalised and their row mean
subtracted (`model.py:244-248`), and a pair's distance is 1 - cosine.
Everything runs on `device` (the card unless the caller asks for the CPU)
in full float32 (`utils/precision.full_float32`); the ViTs' attention is
the forward kernel on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from aqualora_torch.models.vit import DreamSimMLP, ViTB16
from aqualora_torch.ops.resize import bicubic_resize
from aqualora_torch.utils.precision import full_float32

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# backbone hyperparameters (aqualora_tpu/eval/dreamsim.py:42-69)
BACKBONES: Dict[str, Dict] = {
    "dino_vitb16": dict(patch=16, pre_norm=False, quick_gelu=False,
                        ln_eps=1e-6, proj_dim=0,
                        mean=_IMAGENET_MEAN, std=_IMAGENET_STD),
    "clip_vitb16": dict(patch=16, pre_norm=True, quick_gelu=True,
                        ln_eps=1e-5, proj_dim=512,
                        mean=_CLIP_MEAN, std=_CLIP_STD),
    "open_clip_vitb16": dict(patch=16, pre_norm=True, quick_gelu=False,
                             ln_eps=1e-5, proj_dim=512,
                             mean=_CLIP_MEAN, std=_CLIP_STD),
    "clip_vitb32": dict(patch=32, pre_norm=True, quick_gelu=True,
                        ln_eps=1e-5, proj_dim=512,
                        mean=_CLIP_MEAN, std=_CLIP_STD),
    "open_clip_vitb32": dict(patch=32, pre_norm=True, quick_gelu=False,
                             ln_eps=1e-5, proj_dim=512,
                             mean=_CLIP_MEAN, std=_CLIP_STD),
    "mae_vitb16": dict(patch=16, pre_norm=False, quick_gelu=False,
                       ln_eps=1e-6, proj_dim=0,
                       mean=_IMAGENET_MEAN, std=_IMAGENET_STD),
    "mae_vitl16": dict(patch=16, dim=1024, depth=24, heads=16,
                       pre_norm=False, quick_gelu=False, ln_eps=1e-6,
                       proj_dim=0, mean=_IMAGENET_MEAN, std=_IMAGENET_STD),
    "mae_vith14": dict(patch=14, dim=1280, depth=32, heads=16,
                       pre_norm=False, quick_gelu=False, ln_eps=1e-6,
                       proj_dim=0, mean=_IMAGENET_MEAN, std=_IMAGENET_STD),
}

# (backbone, feature tap) per dreamsim_type (aqualora_tpu/eval/
# dreamsim.py:71-84)
MODEL_CONFIGS: Dict[str, list] = {
    "ensemble": [("dino_vitb16", "cls"), ("clip_vitb16", "embedding"),
                 ("open_clip_vitb16", "embedding")],
    "dino_vitb16": [("dino_vitb16", "cls")],
    "clip_vitb32": [("clip_vitb32", "embedding")],
    "open_clip_vitb32": [("open_clip_vitb32", "embedding")],
    "mae_vitb16": [("mae_vitb16", "cls")],
    "mae_vitl16": [("mae_vitl16", "cls")],
    "mae_vith14": [("mae_vith14", "cls")],
}

# the reference's table (model.py:249-263), for the backbones built here
EMBED_DIMS: Dict[str, Dict[str, int]] = {
    "dino_vitb16": {"cls": 768, "last_layer": 768},
    "clip_vitb16": {"cls": 768, "embedding": 512, "last_layer": 768},
    "clip_vitb32": {"cls": 768, "embedding": 512, "last_layer": 512},
    "mae_vitb16": {"cls": 768, "last_layer": 768},
    "mae_vitl16": {"cls": 1024, "last_layer": 1024},
    "mae_vith14": {"cls": 1280, "last_layer": 1280},
    "open_clip_vitb16": {"cls": 768, "embedding": 512, "last_layer": 768},
    "open_clip_vitb32": {"cls": 768, "embedding": 512, "last_layer": 768},
}


def normalize_embedding(e: torch.Tensor) -> torch.Tensor:
    """Unit-normalise rows, then subtract each row's mean."""
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e - e.mean(dim=-1, keepdim=True)


def backbone_kwargs(name: str, vit_overrides: Optional[Dict] = None) -> Dict:
    """The ViTB16 arguments of backbone `name`, with `vit_overrides`."""
    kw = {k: v for k, v in BACKBONES[name].items() if k not in ("mean", "std")}
    kw.update(vit_overrides or {})
    return kw


class DreamSim:
    """dreamsim(img0_01, img1_01) -> the distance of each pair [B] (numpy).

    `params`: {backbone name: ViTB16 state dict} (and 'mlp' with
    `use_mlp`), e.g. from `tools/torch_import.dreamsim_from_torch`, loaded
    strictly.  None gives seeded random weights: backbone i from a
    generator seeded i, the MLP from one seeded 99 (the JAX package's
    PRNGKey(i) and PRNGKey(99); the values differ from JAX's)."""

    def __init__(self, params: Optional[Dict] = None,
                 dreamsim_type: str = "ensemble", image_size: int = 224,
                 use_mlp: bool = False, hidden_size: int = 512,
                 normalize_embeds: bool = True,
                 vit_overrides: Optional[Dict] = None,
                 device: str | torch.device = "cuda"):
        self.config = MODEL_CONFIGS[dreamsim_type]
        self.image_size = image_size
        self.normalize_embeds = normalize_embeds
        self.device = torch.device(device)
        self.backbones: Dict[str, ViTB16] = {}
        self.stats = {}
        for i, (name, _) in enumerate(self.config):
            vit = ViTB16(image_size=image_size,
                         **backbone_kwargs(name, vit_overrides))
            if params is None:
                vit.init_weights(torch.Generator().manual_seed(i))
            else:
                vit.load_state_dict(params[name], strict=True)
            self.backbones[name] = vit.to(self.device).eval(
                ).requires_grad_(False)
            self.stats[name] = tuple(
                torch.from_numpy(BACKBONES[name][k]).to(self.device).view(
                    1, 3, 1, 1) for k in ("mean", "std"))
        # read off the built modules, so vit_overrides stay consistent
        self.embed_size = sum(
            self.backbones[n].proj_dim if f == "embedding"
            else self.backbones[n].dim for n, f in self.config)
        self.mlp = None
        if use_mlp:
            mlp = DreamSimMLP(self.embed_size, hidden_size)
            if params is None:
                g = torch.Generator().manual_seed(99)
                for lin in (mlp.fc1, mlp.fc2):
                    with torch.no_grad():
                        lin.weight.copy_(torch.randn(
                            lin.weight.shape, generator=g)
                            * lin.weight.shape[1] ** -0.5)
                        lin.bias.zero_()
            else:
                mlp.load_state_dict(params["mlp"], strict=True)
            self.mlp = mlp.to(self.device).eval().requires_grad_(False)

    def _prep(self, img01) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> NCHW float32 on the device, resized to
        image_size (the reference's bicubic, model.py:231-235)."""
        x = torch.from_numpy(np.ascontiguousarray(img01, np.float32)).to(
            self.device)
        return bicubic_resize(x.permute(0, 3, 1, 2), self.image_size,
                              self.image_size)

    @torch.no_grad()
    def embed(self, img01) -> torch.Tensor:
        with full_float32():
            x = self._prep(img01)
            feats = []
            for name, tap in self.config:
                mean, std = self.stats[name]
                feats.append(self.backbones[name]((x - mean) / std)[tap])
            e = torch.cat(feats, dim=-1)
            if self.mlp is not None:
                e = self.mlp(e)
            if self.normalize_embeds:
                e = normalize_embedding(e)
        return e

    def __call__(self, img0_01, img1_01) -> np.ndarray:
        e0, e1 = self.embed(img0_01), self.embed(img1_01)
        cos = (e0 * e1).sum(-1) / (torch.linalg.vector_norm(e0, dim=-1)
                                   * torch.linalg.vector_norm(e1, dim=-1))
        return (1.0 - cos).cpu().numpy()
