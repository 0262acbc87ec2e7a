"""Stability-AI ModelSpec metadata (`modelspec.*`) for safetensors files.

The port of `aqualora_tpu/tools/sai_model_spec.py`, the reference's
kohya-derived `scripts/lib/sai_model_spec.py`: `build_metadata` (:94-236,
the whole Must/Should/Can field set with the same defaults and deletions),
`build_merged_from` (:255-264, titles taken from each file's own modelspec
metadata), `load_metadata_from_safetensors` (:244-252, through the port's
`core.io.read_safetensors_header`) and `precalculate_safetensors_hashes`
(:79-88: sha256 over each tensor's raw little-endian bytes in state-dict
order, so the hash equals kohya's and the JAX package's for equal types and
values).  bfloat16 and float16 tensors are hashed through a uint8 view of
their own bytes; no value goes through numpy, which has no bfloat16.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Dict, List, Optional, Tuple, Union

import torch

from aqualora_torch.core.io import read_safetensors_header

BASE_METADATA = {
    # === Must ===
    "modelspec.sai_model_spec": "1.0.0",
    "modelspec.architecture": None,
    "modelspec.implementation": None,
    "modelspec.title": None,
    "modelspec.resolution": None,
    # === Should ===
    "modelspec.description": None,
    "modelspec.author": None,
    "modelspec.date": None,
    # === Can ===
    "modelspec.license": None,
    "modelspec.tags": None,
    "modelspec.merged_from": None,
    "modelspec.prediction_type": None,
    "modelspec.timestep_range": None,
    "modelspec.encoder_layer": None,
}

MODELSPEC_TITLE = "modelspec.title"

ARCH_SD_V1 = "stable-diffusion-v1"
ARCH_SD_V2_512 = "stable-diffusion-v2-512"
ARCH_SD_V2_768_V = "stable-diffusion-v2-768-v"
ARCH_SD_XL_V1_BASE = "stable-diffusion-xl-v1-base"

ADAPTER_LORA = "lora"
ADAPTER_TEXTUAL_INVERSION = "textual-inversion"

IMPL_STABILITY_AI = "https://github.com/Stability-AI/generative-models"
IMPL_DIFFUSERS = "diffusers"

PRED_TYPE_EPSILON = "epsilon"
PRED_TYPE_V = "v"


def precalculate_safetensors_hashes(state_dict: Dict[str, torch.Tensor]
                                    ) -> str:
    """sha256 over each tensor's raw little-endian bytes, tensor by tensor
    in state-dict order (sai_model_spec.py:66-88: the bytes after a
    single-tensor safetensors header are exactly the raw tensor data)."""
    h = hashlib.sha256()
    for v in state_dict.values():
        t = v.detach().contiguous().reshape(-1)
        if t.numel():
            h.update(t.cpu().view(torch.uint8).numpy().data)
    return f"0x{h.hexdigest()}"


def build_metadata(
    state_dict: Optional[Dict[str, torch.Tensor]],
    v2: bool,
    v_parameterization: bool,
    sdxl: bool,
    lora: bool,
    textual_inversion: bool,
    timestamp: float,
    title: Optional[str] = None,
    reso: Optional[Union[int, Tuple[int, int], str]] = None,
    is_stable_diffusion_ckpt: Optional[bool] = None,
    author: Optional[str] = None,
    description: Optional[str] = None,
    license: Optional[str] = None,
    tags: Optional[str] = None,
    merged_from: Optional[str] = None,
    timesteps: Optional[Union[int, Tuple[int, int], str]] = None,
    clip_skip: Optional[int] = None,
) -> Dict[str, str]:
    """Reference-equal field set and rules (sai_model_spec.py:94-236).
    state_dict is unused for the hash (the reference leaves it TODO)."""
    del state_dict
    metadata = dict(BASE_METADATA)

    if sdxl:
        arch = ARCH_SD_XL_V1_BASE
    elif v2:
        arch = ARCH_SD_V2_768_V if v_parameterization else ARCH_SD_V2_512
    else:
        arch = ARCH_SD_V1
    if lora:
        arch += f"/{ADAPTER_LORA}"
    elif textual_inversion:
        arch += f"/{ADAPTER_TEXTUAL_INVERSION}"
    metadata["modelspec.architecture"] = arch

    if not lora and not textual_inversion and is_stable_diffusion_ckpt is None:
        is_stable_diffusion_ckpt = True
    if (lora and sdxl) or textual_inversion or is_stable_diffusion_ckpt:
        impl = IMPL_STABILITY_AI
    else:
        impl = IMPL_DIFFUSERS     # v1/v2 LoRA or Diffusers
    metadata["modelspec.implementation"] = impl

    if title is None:
        title = ("LoRA" if lora else
                 "TextualInversion" if textual_inversion else "Checkpoint")
        title += f"@{timestamp}"
    metadata[MODELSPEC_TITLE] = title

    for key, val in (("modelspec.author", author),
                     ("modelspec.description", description),
                     ("modelspec.merged_from", merged_from),
                     ("modelspec.license", license),
                     ("modelspec.tags", tags)):
        if val is not None:
            metadata[key] = val
        else:
            del metadata[key]

    metadata["modelspec.date"] = (
        datetime.datetime.fromtimestamp(int(timestamp)).isoformat())

    if reso is not None:
        if isinstance(reso, str):
            reso = tuple(map(int, reso.split(",")))
        if isinstance(reso, tuple) and len(reso) == 1:
            reso = (reso[0], reso[0])
    else:
        reso = 1024 if sdxl else (768 if v2 and v_parameterization else 512)
    if isinstance(reso, int):
        reso = (reso, reso)
    metadata["modelspec.resolution"] = f"{reso[0]}x{reso[1]}"

    metadata["modelspec.prediction_type"] = (
        PRED_TYPE_V if v_parameterization else PRED_TYPE_EPSILON)

    if timesteps is not None:
        if isinstance(timesteps, (str, int)):
            timesteps = (timesteps, timesteps)
        if len(timesteps) == 1:
            timesteps = (timesteps[0], timesteps[0])
        metadata["modelspec.timestep_range"] = f"{timesteps[0]},{timesteps[1]}"
    else:
        del metadata["modelspec.timestep_range"]

    if clip_skip is not None:
        metadata["modelspec.encoder_layer"] = f"{clip_skip}"
    else:
        del metadata["modelspec.encoder_layer"]

    assert all(v is not None for v in metadata.values()), metadata
    return metadata


def load_metadata_from_safetensors(path: str) -> Dict[str, str]:
    """The `__metadata__` block of a safetensors file, without reading its
    tensors (sai_model_spec.py:244-252); {} for any other path."""
    if not path.endswith(".safetensors") or not os.path.exists(path):
        return {}
    return read_safetensors_header(path)[1]


def build_merged_from(models: List[str]) -> str:
    """Comma-joined titles: each model's own modelspec.title when present,
    else its filename stem (sai_model_spec.py:255-264)."""
    def get_title(model: str) -> str:
        title = load_metadata_from_safetensors(model).get(MODELSPEC_TITLE)
        if title is None:
            title = os.path.splitext(os.path.basename(model))[0]
        return title

    return ", ".join(get_title(m) for m in models)
