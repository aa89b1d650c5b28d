# Weight bridge: JAX param trees and flat-npz checkpoints → the port's
# Whisper, Llama, ResNet, Detector, TTS and Vocoder modules, and back.
#
# The flat-npz scheme is the JAX package's (elements/speech.py
# load_flat_npz / save_flat_npz): one array per leaf, keyed by the
# '/'-joined tree path ("dec_blocks/3/attn/q/w").  The port's parameter
# names are the same path joined by '.', so every copy is by name.
# numpy has no bfloat16: bf16 leaves travel as f32 and round to the
# model's dtype on the way in (round to nearest even, as jnp's astype).

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["flatten_tree", "params_from_numpy", "quantized_from_numpy",
           "load_flat_npz", "save_flat_npz"]


def _to_numpy(leaf) -> np.ndarray:
    array = np.asarray(leaf)
    if array.dtype.kind == "V" or array.dtype.name == "bfloat16":
        array = array.astype(np.float32)
    return array


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict/list param tree → {'/'-joined path: numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _to_numpy(tree)}
    flat = {}
    for key, value in items:
        flat.update(flatten_tree(value, f"{prefix}/{key}" if prefix
                                 else str(key)))
    return flat


@torch.no_grad()
def _overlay(model: torch.nn.Module, flat: dict, strict: bool) -> None:
    expected = dict(model.named_parameters())
    if strict:
        names = {name.replace(".", "/") for name in expected}
        missing, extra = names - set(flat), set(flat) - names
        if missing or extra:
            raise ValueError(f"param tree does not match the model: "
                             f"missing {sorted(missing)[:5]}, unexpected "
                             f"{sorted(extra)[:5]}")
    for name, param in expected.items():
        key = name.replace(".", "/")
        if key not in flat:
            continue
        loaded = np.asarray(flat[key])
        shape = tuple(param.shape)
        if loaded.shape != shape:
            # position tables may be longer in the checkpoint than the
            # serving context: a leading-dim prefix is the right slice
            if (loaded.ndim == param.ndim and
                    loaded.shape[1:] == shape[1:] and
                    loaded.shape[0] > shape[0] and
                    key.rsplit("/", 1)[-1].startswith("pos_embed")):
                loaded = loaded[:shape[0]]
            else:
                raise ValueError(f"weights[{key}]: shape {loaded.shape} "
                                 f"!= model {shape}")
        param.copy_(torch.from_numpy(
            np.array(loaded, dtype=np.float32)).to(param.dtype))


def params_from_numpy(tree, config, device=None):
    """A JAX Whisper, Llama, ResNet, detector, TTS or vocoder param tree
    (leaves as numpy arrays, or anything np.asarray takes) → the loaded
    port module that `config`'s type names (WhisperConfig → Whisper,
    LlamaConfig → Llama, ResNetConfig → ResNet, DetectorConfig →
    Detector, TTSConfig → TTS, VocoderConfig → Vocoder) on `device`
    (None: the card).  Every leaf must be present with its shape."""
    from .models.detector import Detector, DetectorConfig
    from .models.llama import Llama, LlamaConfig
    from .models.resnet import ResNet, ResNetConfig
    from .models.tts import TTS, TTSConfig
    from .models.vocoder import Vocoder, VocoderConfig
    from .models.whisper import Whisper
    model_type = Whisper
    for config_type, module_type in ((LlamaConfig, Llama),
                                     (ResNetConfig, ResNet),
                                     (DetectorConfig, Detector),
                                     (TTSConfig, TTS),
                                     (VocoderConfig, Vocoder)):
        if isinstance(config, config_type):
            model_type = module_type
    model = model_type(config, device=resolve_device(device))
    _overlay(model, flatten_tree(tree), strict=True)
    return model


def quantized_from_numpy(tree, config, device=None):
    """A JAX weight-quantized Llama tree (layers.quantize_linear_tree:
    {"w8" int8, "s" f32} linears beside the unquantized leaves) as the
    port's nested dicts and lists of tensors, the form the port decoder
    builds from its own weights with weight_quant: int8 leaves stay
    int8, the scales "s" f32, every other float leaf takes `config`'s
    dtype (bf16 through f32, as params_from_numpy).  The port can also
    quantize the carried f32 / bf16 weights itself
    (layers.quantize_linear_tree), with the same int8 values and
    scales."""
    device = resolve_device(device)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {key: walk(value, key) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(value, name) for value in node]
        array = _to_numpy(node)
        if array.dtype == np.int8:
            return torch.from_numpy(array).to(device)
        tensor = torch.from_numpy(np.array(array, dtype=np.float32))
        dtype = torch.float32 if name == "s" else config.dtype
        return tensor.to(device=device, dtype=dtype)

    return walk(tree)


def load_flat_npz(model: torch.nn.Module, pathname: str):
    """Overlay weights from an npz whose keys are '/'-joined tree paths.
    Parameters absent from the file keep their values; shape mismatches
    raise.  Returns the model."""
    with np.load(pathname) as archive:
        flat = {key: archive[key] for key in archive.files}
    _overlay(model, flat, strict=False)
    return model


def save_flat_npz(model: torch.nn.Module, pathname: str) -> None:
    """Inverse of load_flat_npz: every parameter as an f32 (or its own
    dtype, bf16 excepted) array under its '/'-joined path."""
    flat = {}
    for name, param in model.named_parameters():
        tensor = param.detach().cpu()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.float()
        flat[name.replace(".", "/")] = tensor.numpy()
    np.savez(pathname, **flat)
