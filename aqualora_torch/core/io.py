"""Artifact I/O: safetensors written by hand, torch pickles, the
watermark-LoRA key layout, and strict loading of torch state dicts into
modules.

The port of `aqualora_tpu/core/io.py:32-66,160-336`.  The JAX
package reads and writes safetensors through the `safetensors` package;
the port has its own reader and writer, so that a machine without that
package runs it.  A file is an 8-byte little-endian header length, a JSON
header {name: {"dtype", "shape", "data_offsets"}, "__metadata__": {...}}
padded with spaces to a multiple of 8 bytes, then the tensors' raw bytes,
back to back.  The writer orders the tensors as the `safetensors` package
does (by element type, widest first, then by name), so both write the same
bytes, but for the order of two or more metadata keys (the package's
follows a hash).

`pytorch_lora_weights.safetensors` keeps the reference's key layout
(`train/ppft_train.py:442-471` of the reference): an attention site as
`unet.<module>.processor.to_{q,k,v,out}_lora.{down,up}.weight`, a proj or
ff site as `unet.<module>.lora.{down,up}.weight`.  The port's LoRA weights
are already in torch layout (`LoRALinear.lora.{down,up}.weight` [out, in],
`LoRAConv2d` OIHW), so export and import only map keys.  A text-encoder
LoRA (`--train_text_encoder`) goes into the same file under
`text_encoder.text_model.encoder.layers.<i>.`: its attention sites as
`self_attn.to_{q,k,v,out}_lora.{down,up}.weight`, its MLP sites as
`mlp.fc{1,2}.lora_linear_layer.{down,up}.weight` (`te_lora_torch_keys`).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Iterable, List, Mapping, Optional

import torch
import torch.nn as nn

# safetensors dtype names, in the order of the format's Dtype enum: the
# writer sorts by it, widest first, as the `safetensors` package does
_DTYPES = {"BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
           "I16": torch.int16, "F16": torch.float16, "BF16": torch.bfloat16,
           "I32": torch.int32, "F32": torch.float32, "F64": torch.float64,
           "I64": torch.int64}
_NAMES = {dt: name for name, dt in _DTYPES.items()}
_ORDER = {name: i for i, name in enumerate(_DTYPES)}
_MAX_HEADER = 100 * 2 ** 20         # the package's own limit

LORA_FILE = "pytorch_lora_weights.safetensors"
MAPPER_FILE = "mapper.safetensors"


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors I/O needs a little-endian host")


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device) to `path` in the safetensors format."""
    _check_byteorder()
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
    names = sorted(tensors, key=lambda n: (-_ORDER[_NAMES[tensors[n].dtype]],
                                           n))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().reshape(-1)
            if t.numel():
                f.write(t.cpu().view(torch.uint8).numpy().data)


def read_safetensors_header(path: str) -> tuple:
    """-> (header without `__metadata__`, metadata, data start, data
    length), after checking that every tensor's bytes lie inside the data,
    match its dtype and shape, and overlap no other tensor's."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if size < 8 or n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path}: header length {n} runs past the file")
        raw = f.read(n)
    try:
        header = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    data_len = size - 8 - n
    spans = []
    for name, info in header.items():
        try:
            dtype = _DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            start, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: malformed entry {name!r}: {info!r}"
                             ) from None
        numel = 1
        for s in shape:
            if s < 0:
                raise ValueError(f"{path}: {name}: negative dim in {shape}")
            numel *= s
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= data_len:
            raise ValueError(f"{path}: {name}: offsets [{start}, {end}] run "
                             f"past the {data_len} data bytes")
        if end - start != nbytes:
            raise ValueError(f"{path}: {name}: {end - start} bytes for "
                             f"{info['dtype']} {shape} ({nbytes})")
        spans.append((start, end, name))
    spans.sort()
    for (_, e0, a), (s1, _, b) in zip(spans, spans[1:]):
        if s1 < e0:
            raise ValueError(f"{path}: the bytes of {a} and {b} overlap")
    return header, metadata, 8 + n, data_len


def load_safetensors(path: str, device: str | torch.device = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file onto `device`."""
    _check_byteorder()
    header, _, start, _ = read_safetensors_header(path)
    out = {}
    with open(path, "rb") as f:
        for name, info in header.items():
            dtype, shape = _DTYPES[info["dtype"]], info["shape"]
            lo, hi = info["data_offsets"]
            if hi == lo:
                t = torch.empty(shape, dtype=dtype)
            else:
                buf = bytearray(hi - lo)
                f.seek(start + lo)
                if f.readinto(buf) != len(buf):
                    raise ValueError(f"{path}: {name}: short read")
                t = torch.frombuffer(buf, dtype=torch.uint8).view(
                    dtype).reshape(shape)
            out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# torch pickles
# ---------------------------------------------------------------------------

def load_torch_pickle(path: str) -> Dict[str, object]:
    """A torch .pt/.pth checkpoint -> its state dict, tensors kept as torch
    tensors on the CPU (`aqualora_tpu/core/io.py:44-66`).  Read
    with `weights_only=True`; a full DINO training checkpoint stores an
    `argparse.Namespace` under `args`, which the safe unpickler refuses, so
    the retry allows exactly that type (a pickled module stays refused)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        import argparse
        with torch.serialization.safe_globals([argparse.Namespace]):
            obj = torch.load(path, map_location="cpu", weights_only=True)
    return dict(obj)


# ---------------------------------------------------------------------------
# strict loading into modules (the counterpart of `assign_into`)
# ---------------------------------------------------------------------------

def assign_state(module: nn.Module, state: Mapping[str, torch.Tensor],
                 skip: Iterable[str] = (), what: str = "") -> None:
    """Copy `state` into `module`'s parameters and buffers: every key of
    the module but those in `skip` must be present, no other key may be,
    shapes must match, and each tensor keeps the module's type and device
    (`assign_into`, `core/io.py:160-179`)."""
    own = module.state_dict()
    skip = set(skip)
    missing = sorted(k for k in own if k not in state and k not in skip)
    unexpected = sorted(k for k in state if k not in own or k in skip)
    if missing or unexpected:
        raise ValueError(
            f"{what or type(module).__name__}: missing {len(missing)} keys "
            f"{missing[:3]}, unexpected {len(unexpected)} keys "
            f"{unexpected[:3]}")
    with torch.no_grad():
        for k, v in state.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{what} {k}: shape {tuple(v.shape)} vs "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(v)


# ---------------------------------------------------------------------------
# the watermark-LoRA key layout
# ---------------------------------------------------------------------------

def lora_torch_key(module_key: str, which: str) -> str:
    """`_lora_torch_key` (`core/io.py:186-195`): attention sites go through
    `.processor.to_*_lora`, proj and ff sites get a `.lora` suffix."""
    k = module_key
    for a in ("to_q", "to_k", "to_v"):
        k = k.replace(f".{a}", f".processor.{a}_lora")
    k = k.replace(".to_out.0", ".processor.to_out_lora")
    if ".proj_in" in k or ".proj_out" in k or ".ff." in k:
        k = k + ".lora"
    return f"unet.{k}.{which}.weight"


def unet_module_keys(config) -> List[str]:
    """The LoRA sites of a U-Net config in `unet_keys.json` order (192 for
    SD-1.5), as `unet_module_keys` (`core/io.py:198-223`)."""
    sites = ["proj_in", "proj_out",
             "transformer_blocks.0.attn1.to_k",
             "transformer_blocks.0.attn1.to_out.0",
             "transformer_blocks.0.attn1.to_q",
             "transformer_blocks.0.attn1.to_v",
             "transformer_blocks.0.attn2.to_k",
             "transformer_blocks.0.attn2.to_out.0",
             "transformer_blocks.0.attn2.to_q",
             "transformer_blocks.0.attn2.to_v",
             "transformer_blocks.0.ff.net.0.proj",
             "transformer_blocks.0.ff.net.2"]
    keys = []
    n_blocks = len(config.block_out_channels)
    for i in range(n_blocks):
        if config.attn_down_blocks[i]:
            for j in range(config.layers_per_block):
                keys += [f"down_blocks.{i}.attentions.{j}.{s}" for s in sites]
    keys += [f"mid_block.attentions.0.{s}" for s in sites]
    for i in range(n_blocks):
        if config.attn_up_blocks[i]:
            for j in range(config.layers_per_block + 1):
                keys += [f"up_blocks.{i}.attentions.{j}.{s}" for s in sites]
    return keys


def lora_key_map(config) -> Dict[str, str]:
    """file key -> the U-Net module's parameter name, for every LoRA
    tensor of `config` (two a site)."""
    return {lora_torch_key(mk, which): f"{mk}.lora.{which}.weight"
            for mk in unet_module_keys(config) for which in ("down", "up")}


def export_lora_safetensors(unet: nn.Module, config,
                            path: Optional[str] = None
                            ) -> Dict[str, torch.Tensor]:
    """The U-Net's LoRA weights in the reference's layout, in their own
    type (`export_lora_safetensors`, `core/io.py:230-250`); written to
    `path` when one is given."""
    own = dict(unet.named_parameters())
    out = {}
    for tkey, name in lora_key_map(config).items():
        if name not in own:
            raise KeyError(f"no LoRA parameter {name}")
        out[tkey] = own[name].detach()
    if path:
        save_safetensors(out, path)
    return out


def import_lora_safetensors(unet: nn.Module, config,
                            state: Mapping[str, torch.Tensor]) -> None:
    """Copy a reference-layout LoRA state into the U-Net, in place: every
    key must be present and every shape must match; each weight keeps the
    module's type (`import_lora_safetensors`, `core/io.py:311-336`).  Keys
    of other modules (a text-encoder LoRA) are left alone, as in JAX."""
    own = dict(unet.named_parameters())
    pairs = []
    for tkey, name in lora_key_map(config).items():
        if tkey not in state:
            raise KeyError(f"LoRA key {tkey} not in checkpoint")
        if name not in own:
            raise KeyError(f"U-Net has no LoRA parameter {name}; build it "
                           f"with the LoRA enabled")
        if tuple(state[tkey].shape) != tuple(own[name].shape):
            raise ValueError(f"{tkey}: shape {tuple(state[tkey].shape)} vs "
                             f"{tuple(own[name].shape)}")
        pairs.append((own[name], state[tkey]))
    with torch.no_grad():
        for p, v in pairs:
            p.copy_(v)


# ---------------------------------------------------------------------------
# the text-encoder LoRA
# ---------------------------------------------------------------------------

def te_lora_torch_keys(clip_config) -> Dict[str, str]:
    """file key -> the CLIP module's parameter name, for every text-encoder
    LoRA tensor (`te_lora_torch_keys`, `core/io.py:253-274`)."""
    out: Dict[str, str] = {}
    for i in range(clip_config.num_layers):
        pre = f"text_encoder.text_model.encoder.layers.{i}"
        for tname, name in (("to_q_lora", "q_proj"), ("to_k_lora", "k_proj"),
                            ("to_v_lora", "v_proj"),
                            ("to_out_lora", "out_proj")):
            for which in ("down", "up"):
                out[f"{pre}.self_attn.{tname}.{which}.weight"] = (
                    f"layers.{i}.self_attn.{name}.lora.{which}.weight")
        for fc in ("fc1", "fc2"):
            for which in ("down", "up"):
                out[f"{pre}.mlp.{fc}.lora_linear_layer.{which}.weight"] = (
                    f"layers.{i}.mlp.{fc}.lora.{which}.weight")
    return out


def export_te_lora_safetensors(clip: nn.Module, clip_config
                               ) -> Dict[str, torch.Tensor]:
    """The CLIP LoRA weights in the reference's layout, in their own type
    (`export_te_lora_safetensors`, `core/io.py:277-289`)."""
    own = dict(clip.named_parameters())
    out = {}
    for tkey, name in te_lora_torch_keys(clip_config).items():
        if name not in own:
            raise KeyError(f"no text-encoder LoRA parameter {name}")
        out[tkey] = own[name].detach()
    return out


def import_te_lora_safetensors(clip: nn.Module, clip_config,
                               state: Mapping[str, torch.Tensor]) -> None:
    """Copy the text-encoder LoRA keys of a reference-layout state into the
    CLIP, in place, strictly (`import_te_lora_safetensors`,
    `core/io.py:292-309`); U-Net keys are left alone."""
    own = dict(clip.named_parameters())
    pairs = []
    for tkey, name in te_lora_torch_keys(clip_config).items():
        if tkey not in state:
            raise KeyError(f"text-encoder LoRA key {tkey} not in checkpoint")
        if name not in own:
            raise KeyError(f"CLIP has no LoRA parameter {name}; build it "
                           "with clip.with_lora()")
        if tuple(state[tkey].shape) != tuple(own[name].shape):
            raise ValueError(f"{tkey}: shape {tuple(state[tkey].shape)} vs "
                             f"{tuple(own[name].shape)}")
        pairs.append((own[name], state[tkey]))
    with torch.no_grad():
        for p, v in pairs:
            p.copy_(v)
