"""Read the reference's published torch weights into the port.

The port of `aqualora_tpu/tools/torch_import.py`.  The port's modules carry
the published key names (torchvision's EfficientNet-B1 in
`models/efficientnet.py`, lpips' VGG16 in `models/lpips.py`, torchvision's
InceptionV3 in `models/inception.py`, DINO's ViT in `models/vit.py`), so a
reader only unwraps a checkpoint, renames what the release names otherwise,
folds adapters and casts to float32; the consumer loads the state dict with
`load_state_dict(strict=True)` or `core.io.assign_state`.  No transposes,
and no `transformers`: the MAE mapping works on a plain state dict.

  - `efficientnet_b1_from_torch`, `secret_decoder_from_torch`: the
    release's `msgdecoder.pt` (torchvision's `efficientnet_b1` layout, with
    or without the SecretDecoder's `model.` prefix, with or without
    BatchNorm's `num_batches_tracked`, which is filled with zeros: eval
    never reads it);
  - `secret_encoder_from_torch`: the reference's SecretEncoder
    (`secret_scaler.0` the Linear, `secret_scaler.5` the zero conv) ->
    `secret_dense` / `conv_out`;
  - `mapper_from_torch`, `latentwm_from_torch`: `mapper.pt` and
    `pretrained_latentwm.pth` ({'sec_encoder', 'sec_decoder'}), the latter
    in the format `train.ppft_train.load_pretrain` reads;
  - `lpips_from_torch`: the lpips package's VGG16 (`net.sliceK.N`), or
    torchvision's `features.N` / `net.features.N`, with the
    `lin{i}.model.1.weight` or `lins.{i}.model.1.weight` heads;
  - `inception_from_torch`: the FID weights (`pt_inception-2015-12-05`,
    torchvision's `inception_v3` layout), `fc.`, `AuxLogits.` and
    `num_batches_tracked` dropped;
  - `dino_vit_from_torch`, `fold_qkv_lora`, `_unwrap_checkpoint`: DINO
    state dicts and the CLIP/OpenCLIP-as-DINO `.pth.tar` conversions (a
    `pos_drop` LayerNorm and a `proj`), with peft's qkv LoRA folded in;
  - `_mae_hf_to_dino_state`, `mae_as_vit_from_torch`, `load_mae_as_vit`:
    the MAE backbones (HF ViTMAEModel's layout for ViT-B/16, DINO's under
    `model` for ViT-L/16 and ViT-H/14);
  - `dreamsim_from_torch`: the unzipped DreamSim checkpoint directory.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from aqualora_torch.core.config import EfficientNetConfig
from aqualora_torch.core.io import load_safetensors, load_torch_pickle

State = Dict[str, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to(torch.float32).contiguous()


def _state(path_or_state) -> dict:
    return (load_torch_pickle(path_or_state)
            if isinstance(path_or_state, str) else path_or_state)


# -- SecretDecoder (EfficientNet-B1), SecretEncoder, MapperNet -------------

def efficientnet_b1_from_torch(state, cfg: Optional[EfficientNetConfig] = None,
                               prefix: str = "model.") -> State:
    """A torchvision efficientnet_b1 state dict -> the state dict of the
    port's `EfficientNet(cfg)` (B1 by default).  `prefix` (the
    SecretDecoder's `model.`) is stripped where a key has it.  Every
    parameter and running statistic of the module must be present; a
    missing `num_batches_tracked` becomes 0, and keys the module does not
    have are left out."""
    from aqualora_torch.models.efficientnet import EfficientNet
    st = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in state.items()}
    with torch.device("meta"):
        model = EfficientNet(cfg or EfficientNetConfig.b1())
    out: State = {}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            out[k] = (torch.as_tensor(st[k]).to(torch.int64) if k in st
                      else torch.zeros((), dtype=torch.int64))
        else:
            out[k] = _f32(st[k])
    return out


def secret_decoder_from_torch(path_or_state, bitnum: int = 48,
                              cfg: Optional[EfficientNetConfig] = None
                              ) -> State:
    """msgdecoder.pt, or its state dict -> the state dict of the port's
    `SecretDecoder` (its backbone under `model.`).  `bitnum` is the JAX
    reader's argument, unused there too: the head's shape is the file's."""
    del bitnum
    backbone = efficientnet_b1_from_torch(_state(path_or_state), cfg)
    return {f"model.{k}": v for k, v in backbone.items()}


def secret_encoder_from_torch(path_or_state) -> State:
    """The reference's SecretEncoder state dict (utils/models.py:51-64):
    secret_scaler.0 = Linear(bits -> 32*32), secret_scaler.5 = the zero
    conv -> the port's `secret_dense` / `conv_out`."""
    st = _state(path_or_state)
    return {f"{dst}.{leaf}": _f32(st[f"secret_scaler.{src}.{leaf}"])
            for src, dst in ((0, "secret_dense"), (5, "conv_out"))
            for leaf in ("weight", "bias")}


def mapper_from_torch(path_or_state) -> State:
    """mapper.pt -> the port's MapperNet state dict."""
    return {"bit_embeddings.weight":
            _f32(_state(path_or_state)["bit_embeddings.weight"])}


def latentwm_from_torch(path: str,
                        cfg: Optional[EfficientNetConfig] = None) -> dict:
    """pretrained_latentwm.pth {'sec_encoder', 'sec_decoder'} (the stage-1
    artifact, latent_wm_pretrain.py:246-249) -> the same dict of the port's
    state dicts, which `train.ppft_train.load_pretrain` reads."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {"sec_encoder": secret_encoder_from_torch(obj["sec_encoder"]),
            "sec_decoder": secret_decoder_from_torch(obj["sec_decoder"],
                                                     cfg=cfg)}


# -- LPIPS VGG16 -------------------------------------------------------------

def lpips_from_torch(path_or_state) -> State:
    """The lpips package's checkpoint (`net.sliceK.N`, `lin{i}`), or a dict
    with torchvision's `features.N` / `net.features.N` VGG16 keys and the
    `lin{i}.model.1.weight` or `lins.{i}.model.1.weight` heads -> the state
    dict of the port's `LPIPS`."""
    from aqualora_torch.models.lpips import vgg16_conv_indices
    st = _state(path_or_state)
    out: State = {}
    for si, stage in enumerate(vgg16_conv_indices()):
        for n in stage:
            ours = f"net.slice{si + 1}.{n}"
            src = next((key for key in (f"features.{n}", f"net.features.{n}")
                        if f"{key}.weight" in st), ours)
            for leaf in ("weight", "bias"):
                out[f"{ours}.{leaf}"] = _f32(st[f"{src}.{leaf}"])
    for i in range(len(vgg16_conv_indices())):
        key = next((k for k in (f"lin{i}.model.1.weight",
                                f"lins.{i}.model.1.weight") if k in st), None)
        if key is None:
            raise KeyError(f"lin{i}")
        out[f"lin{i}.model.1.weight"] = _f32(st[key])
    return out


# -- FID InceptionV3 -------------------------------------------------------

def inception_from_torch(state) -> State:
    """A torchvision inception_v3 state dict, or the path of one (the
    layout of the FID weights, pytorch_fid's `inception.py:16,196-221`) ->
    the state dict of `models/inception.InceptionV3Features`.  The `fc`
    and `AuxLogits` heads and the BatchNorm counters are dropped (FID reads
    pool3 only); any other key that is not a convolution weight or a
    BatchNorm tensor raises."""
    if isinstance(state, str):
        state = load_torch_pickle(state)
    out: State = {}
    for k, v in state.items():
        if k.startswith(("fc.", "AuxLogits.")) or "num_batches" in k:
            continue
        parts = k.split(".")
        sub, leaf = parts[-2:] if len(parts) >= 2 else ("", "")
        if (sub == "conv" and leaf == "weight") or (
                sub == "bn" and leaf in ("weight", "bias", "running_mean",
                                         "running_var")):
            out[k] = _f32(v)
        else:
            raise KeyError(f"unrecognized inception key {k}")
    return out


# -- DreamSim ViT backbones ------------------------------------------------

def fold_qkv_lora(state: State, lora_state: State, r: int = 16,
                  alpha: float = 0.5) -> State:
    """Fold a peft LoRA adapter on `qkv` (dreamsim config.py:28-34) into a
    DINO-layout state dict: qkv.weight += (alpha / r) * B @ A, peft's merge
    rule, in float32.  Adapter keys look like
    `base_model.model.model.blocks.N.attn.qkv.lora_A.weight`."""
    out = dict(state)
    scaling = alpha / r
    for k, a in lora_state.items():
        if "lora_A" not in k:
            continue
        prefix = k[:k.index(".lora_A")]
        b = lora_state[k.replace("lora_A", "lora_B")]
        target = prefix[prefix.index("blocks."):] + ".weight"
        out[target] = _f32(out[target]) + (scaling * _f32(b)) @ _f32(a)
    return out


def _unwrap_checkpoint(state) -> dict:
    """Strip a training checkpoint's nesting and the DDP and DINO wrapper
    prefixes.  'student' before 'teacher': a full DINO checkpoint carries
    both, and the reference reads sd['student'] (extractor.py:71-77)."""
    for outer in ("state_dict", "student", "teacher", "model"):
        if outer in state and isinstance(state[outer], dict):
            state = state[outer]
    return {k.replace("module.", "").replace("backbone.", ""): v
            for k, v in state.items()}


_BLOCK_PARTS = ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                "mlp.fc2")


def dino_vit_from_torch(state, pre_norm: bool = False,
                        proj: Optional[torch.Tensor] = None) -> State:
    """A DINO-layout ViT state dict, or the path of one (dreamsim
    feature_extraction/vision_transformer.py:139-161; the CLIP variants add
    a `pos_drop` LayerNorm, load_clip_as_dino.py:21) -> the state dict of
    `models/vit.ViTB16`.  Keys the ViT does not have (a DINO head) are left
    out; `proj` (or the state's own) becomes the projection."""
    if isinstance(state, str):
        state = load_torch_pickle(state)
    state = _unwrap_checkpoint(state)
    if proj is None and "proj" in state:
        proj = state["proj"]
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    if pre_norm:
        keys += ["pos_drop.weight", "pos_drop.bias"]
    n_blocks = 1 + max(int(k.split(".")[1]) for k in state
                       if re.match(r"blocks\.\d+\.", k))
    keys += [f"blocks.{i}.{part}.{leaf}" for i in range(n_blocks)
             for part in _BLOCK_PARTS for leaf in ("weight", "bias")]
    out = {k: _f32(state[k]) for k in keys}
    if proj is not None:
        out["proj"] = _f32(proj)
    return out


def _mae_hf_to_dino_state(state) -> State:
    """HF ViTMAEModel's state dict ('facebook/vit-mae-base' layout), or the
    path of one -> a DINO-layout state dict, the key mapping of
    `evaluation/dreamsim/feature_extraction/load_mae_as_vit.py:9-37`: q, k
    and v concatenated into qkv, layernorm_before/after -> norm1/norm2,
    intermediate/output dense -> mlp fc1/fc2, embeddings.* -> cls_token,
    pos_embed, patch_embed."""
    if isinstance(state, str):
        state = load_torch_pickle(state)
    for outer in ("model", "state_dict"):
        if outer in state and isinstance(state[outer], dict):
            state = state[outer]

    def g(k):
        return _f32(state[k])

    d: State = {
        "cls_token": g("embeddings.cls_token"),
        "pos_embed": g("embeddings.position_embeddings"),
        "patch_embed.proj.weight":
            g("embeddings.patch_embeddings.projection.weight"),
        "patch_embed.proj.bias":
            g("embeddings.patch_embeddings.projection.bias"),
        "norm.weight": g("layernorm.weight"),
        "norm.bias": g("layernorm.bias"),
    }
    n_blocks = 1 + max(int(k.split(".")[2]) for k in state
                       if k.startswith("encoder.layer."))
    for i in range(n_blocks):
        s, t = f"encoder.layer.{i}", f"blocks.{i}"
        for leaf in ("weight", "bias"):
            d[f"{t}.norm1.{leaf}"] = g(f"{s}.layernorm_before.{leaf}")
            d[f"{t}.attn.qkv.{leaf}"] = torch.cat(
                [g(f"{s}.attention.attention.{m}.{leaf}")
                 for m in ("query", "key", "value")], dim=0)
            d[f"{t}.attn.proj.{leaf}"] = g(
                f"{s}.attention.output.dense.{leaf}")
            d[f"{t}.norm2.{leaf}"] = g(f"{s}.layernorm_after.{leaf}")
            d[f"{t}.mlp.fc1.{leaf}"] = g(f"{s}.intermediate.dense.{leaf}")
            d[f"{t}.mlp.fc2.{leaf}"] = g(f"{s}.output.dense.{leaf}")
    return d


def mae_as_vit_from_torch(state) -> State:
    """HF ViTMAEModel state dict -> ViTB16 state dict."""
    return dino_vit_from_torch(_mae_hf_to_dino_state(state))


def load_mae_as_vit(model_type: str, path_or_state,
                    lora_state: Optional[State] = None,
                    lora_scaling: Tuple[int, float] = (16, 0.5)) -> State:
    """`load_mae_as_vit.py:8-54`: mae_vitb16 ships in HF ViTMAEModel's
    layout (the q/k/v concatenation); mae_vitl16 and mae_vith14 in DINO's,
    under 'model'.  `lora_state`: a peft qkv adapter folded in with
    `lora_scaling` = (r, alpha)."""
    if model_type == "mae_vitb16":
        state = _mae_hf_to_dino_state(path_or_state)
    elif model_type in ("mae_vitl16", "mae_vith14"):
        state = path_or_state
        if isinstance(state, str):
            state = load_torch_pickle(state)
        for outer in ("model", "state_dict"):
            if outer in state and isinstance(state[outer], dict):
                state = state[outer]
    else:
        raise ValueError(f"model {model_type} not supported")
    if lora_state is not None:
        state = fold_qkv_lora(dict(state), lora_state, r=lora_scaling[0],
                              alpha=lora_scaling[1])
    return dino_vit_from_torch(state)


def _load_peft_adapter(lora_dir: str) -> Tuple[State, int, float]:
    """-> (adapter state, r, alpha).  r and alpha come from the adapter's
    own adapter_config.json when it has one (the dreamsim release's 16 and
    0.5 are only the fallback); the weights from
    adapter_model.safetensors (the port's own reader), else
    adapter_model.bin."""
    r, alpha = 16, 0.5
    cfg_path = os.path.join(lora_dir, "adapter_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        r = int(c.get("r", r))
        alpha = float(c.get("lora_alpha", alpha))
    st_path = os.path.join(lora_dir, "adapter_model.safetensors")
    if os.path.exists(st_path):
        return load_safetensors(st_path), r, alpha
    return load_torch_pickle(os.path.join(lora_dir, "adapter_model.bin")), \
        r, alpha


def dreamsim_from_torch(cache_dir: str,
                        dreamsim_type: str = "ensemble") -> Dict[str, State]:
    """The unzipped DreamSim checkpoint directory (dreamsim/model.py:160-191:
    `<name>_pretrain.pth[.tar]` and `<name>_[single_]lora/` peft adapters;
    `single_` for a single-backbone type) -> {backbone name: ViTB16 state
    dict} for `eval/dreamsim.DreamSim`."""
    from aqualora_torch.eval.dreamsim import MODEL_CONFIGS
    tag = "" if dreamsim_type == "ensemble" else "single_"
    out: Dict[str, State] = {}
    for name, _ in MODEL_CONFIGS[dreamsim_type]:
        lora_dir = os.path.join(cache_dir, f"{name}_{tag}lora")
        adapter = (_load_peft_adapter(lora_dir) if os.path.isdir(lora_dir)
                   else None)
        if name.startswith("mae_"):
            out[name] = load_mae_as_vit(
                name, os.path.join(cache_dir, f"{name}_pretrain.pth"),
                lora_state=adapter[0] if adapter else None,
                lora_scaling=adapter[1:] if adapter else (16, 0.5))
            continue
        pre_norm = name != "dino_vitb16"
        fname = (f"{name}_pretrain.pth.tar" if pre_norm
                 else "dino_vitb16_pretrain.pth")
        state = _unwrap_checkpoint(
            load_torch_pickle(os.path.join(cache_dir, fname)))
        proj = state.pop("proj", None)
        if adapter:
            state = fold_qkv_lora(state, adapter[0], r=adapter[1],
                                  alpha=adapter[2])
        out[name] = dino_vit_from_torch(state, pre_norm=pre_norm, proj=proj)
    return out
