# conversion CLI: progress goes to the console by design
# graft: disable-file=lint-print
"""Convert a HuggingFace Whisper checkpoint directory to the flat-npz
weight scheme + tokenizer files, and load the result into the port's
Whisper.

The port's copy of the repo's tools/convert_whisper.py: the same
mapping, byte for byte the same arrays, plus `load_whisper`, which
reads the npz into models/whisper.py's Whisper through
bridge.load_flat_npz (the vocabulary unpadded: Whisper's 51,865 rows are
padded only when a model axis cuts them, parallel/sharding.py).

Usage:
    python -m aiko_services_tpu_torch.tools.convert_whisper \
        /path/to/whisper-small out_dir/

Input directory layout (what `huggingface-cli download openai/whisper-small`
produces): model.safetensors or pytorch_model.bin, vocab.json, merges.txt.
Output: out_dir/weights.npz (keys are '/'-joined paths into the
parameters of models/whisper.py) and copies of vocab.json/merges.txt for
models/tokenizer.load_tokenizer.

The mapping below is name/layout translation only (torch Linear stores
[out, in], the scheme stores [in, out]; torch Conv1d stores
[out, in, k] vs [k, in, out]).  Runs fully offline on the host.
"""

import argparse
import os
import shutil
import sys

import numpy as np


def load_state_dict(model_dir: str) -> dict:
    safetensors_path = os.path.join(model_dir, "model.safetensors")
    torch_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(safetensors_path):
        from safetensors import safe_open
        state = {}
        with safe_open(safetensors_path, framework="np") as handle:
            for key in handle.keys():
                state[key] = handle.get_tensor(key)
        return state
    if os.path.exists(torch_path):
        import torch
        state = torch.load(torch_path, map_location="cpu",
                           weights_only=True)
        return {k: v.numpy() for k, v in state.items()}
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {model_dir}")


def _linear(out: dict, prefix: str, state: dict, hf_prefix: str,
            bias: bool = True) -> None:
    out[f"{prefix}/w"] = state[f"{hf_prefix}.weight"].T
    if bias and f"{hf_prefix}.bias" in state:
        out[f"{prefix}/b"] = state[f"{hf_prefix}.bias"]


def _layer_norm(out: dict, prefix: str, state: dict, hf_prefix: str) -> None:
    out[f"{prefix}/scale"] = state[f"{hf_prefix}.weight"]
    out[f"{prefix}/bias"] = state[f"{hf_prefix}.bias"]


def _attention(out: dict, prefix: str, state: dict, hf_prefix: str) -> None:
    _linear(out, f"{prefix}/q", state, f"{hf_prefix}.q_proj")
    _linear(out, f"{prefix}/k", state, f"{hf_prefix}.k_proj", bias=False)
    _linear(out, f"{prefix}/v", state, f"{hf_prefix}.v_proj")
    _linear(out, f"{prefix}/o", state, f"{hf_prefix}.out_proj")


def convert(state: dict) -> dict:
    state = {k.removeprefix("model."): v for k, v in state.items()}
    out = {}
    # encoder frontend: torch Conv1d [out, in, k] → [k, in, out]
    for conv in ("conv1", "conv2"):
        out[f"{conv}/w"] = state[f"encoder.{conv}.weight"].transpose(2, 1, 0)
        out[f"{conv}/b"] = state[f"encoder.{conv}.bias"]

    layer = 0
    while f"encoder.layers.{layer}.fc1.weight" in state:
        hf = f"encoder.layers.{layer}"
        ours = f"enc_blocks/{layer}"
        _layer_norm(out, f"{ours}/ln_attn", state, f"{hf}.self_attn_layer_norm")
        _attention(out, f"{ours}/attn", state, f"{hf}.self_attn")
        _layer_norm(out, f"{ours}/ln_mlp", state, f"{hf}.final_layer_norm")
        _linear(out, f"{ours}/mlp_in", state, f"{hf}.fc1")
        _linear(out, f"{ours}/mlp_out", state, f"{hf}.fc2")
        layer += 1
    _layer_norm(out, "ln_enc", state, "encoder.layer_norm")

    out["tok_embed/table"] = state["decoder.embed_tokens.weight"]
    out["pos_embed"] = state["decoder.embed_positions.weight"]
    layer = 0
    while f"decoder.layers.{layer}.fc1.weight" in state:
        hf = f"decoder.layers.{layer}"
        ours = f"dec_blocks/{layer}"
        _layer_norm(out, f"{ours}/ln_attn", state, f"{hf}.self_attn_layer_norm")
        _attention(out, f"{ours}/attn", state, f"{hf}.self_attn")
        _layer_norm(out, f"{ours}/ln_cross", state,
                    f"{hf}.encoder_attn_layer_norm")
        _attention(out, f"{ours}/cross", state, f"{hf}.encoder_attn")
        _layer_norm(out, f"{ours}/ln_mlp", state, f"{hf}.final_layer_norm")
        _linear(out, f"{ours}/mlp_in", state, f"{hf}.fc1")
        _linear(out, f"{ours}/mlp_out", state, f"{hf}.fc2")
        layer += 1
    _layer_norm(out, "ln_dec", state, "decoder.layer_norm")
    return out


def load_whisper(pathname: str, config, device=None):
    """The port's Whisper for `config` on `device` (None: the card) with
    every parameter from the npz at `pathname` (convert()'s keys; a
    longer pos_embed table is cut to config.n_text_ctx rows)."""
    from ..models.whisper import Whisper
    from .convert_llama import load_complete
    return load_complete(Whisper, config, pathname, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_dir")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    state = load_state_dict(args.model_dir)
    flat = convert(state)
    np.savez(os.path.join(args.out_dir, "weights.npz"),
             **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    for name in ("vocab.json", "merges.txt"):
        src = os.path.join(args.model_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out_dir, name))
        else:
            print(f"warning: {name} not found in {args.model_dir}",
                  file=sys.stderr)
    print(f"wrote {len(flat)} arrays to {args.out_dir}/weights.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
