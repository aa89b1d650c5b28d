# conversion CLI: progress goes to the console by design
# graft: disable-file=lint-print
"""Convert a HuggingFace Llama checkpoint directory to the flat-npz
weight scheme, and load the result into the port's Llama.

The port's copy of the repo's tools/convert_llama.py: the same mapping,
byte for byte the same arrays, plus `load_llama`, which reads the npz
into models/llama.py's Llama through bridge.load_flat_npz.

Usage:
    python -m aiko_services_tpu_torch.tools.convert_llama \
        /path/to/llama-hf out_dir/

Input directory layout (what `huggingface-cli download meta-llama/...`
produces): model.safetensors / model-0000N-of-*.safetensors /
pytorch_model.bin, plus tokenizer files.  Output: out_dir/weights.npz
with '/'-joined parameter paths of models/llama.py (the JAX package's
tree paths), and tokenizer files copied through for
models/tokenizer.load_tokenizer.

Two real transformations beyond renaming:
  * torch Linear stores [out, in]; the scheme stores [in, out] → T;
  * HF attention was trained with the rotate_half RoPE convention
    (pairs (i, i + D/2)); models/layers.apply_rope rotates interleaved
    pairs (2i, 2i+1).  Q/K projection OUTPUT rows are permuted per head
    so the checkpoint works under the interleaved convention:
    new[2i] = old[i], new[2i+1] = old[i + D/2].

Runs fully offline on the host.
"""


import argparse
import glob
import os
import shutil
import sys

import numpy as np


def load_state_dict(model_dir: str) -> dict:
    shards = sorted(glob.glob(os.path.join(model_dir,
                                           "model*.safetensors")))
    if shards:
        from safetensors import safe_open
        state = {}
        for shard in shards:
            with safe_open(shard, framework="np") as handle:
                for key in handle.keys():
                    state[key] = handle.get_tensor(key)
        return state
    torch_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(torch_path):
        import torch
        state = torch.load(torch_path, map_location="cpu",
                           weights_only=True)
        return {k: v.float().numpy() for k, v in state.items()}
    raise FileNotFoundError(
        f"no model*.safetensors or pytorch_model.bin in {model_dir}")


def permute_rope_rows(weight: np.ndarray, num_heads: int) -> np.ndarray:
    """Reorder a [H*D, in] projection's output rows from rotate_half to
    interleaved RoPE pairing, per head."""
    out_dim, in_dim = weight.shape
    head_dim = out_dim // num_heads
    half = head_dim // 2
    per_head = weight.reshape(num_heads, head_dim, in_dim)
    interleaved = np.empty_like(per_head)
    interleaved[:, 0::2] = per_head[:, :half]
    interleaved[:, 1::2] = per_head[:, half:]
    return interleaved.reshape(out_dim, in_dim)


def convert(state: dict, num_heads: int, num_kv_heads: int) -> dict:
    out = {}
    out["embed/table"] = state["model.embed_tokens.weight"]
    layer_indices = sorted({
        int(key.split(".")[2]) for key in state
        if key.startswith("model.layers.")})
    for i in layer_indices:
        hf = f"model.layers.{i}"
        mine = f"layers/{i}"
        out[f"{mine}/ln_attn/scale"] = \
            state[f"{hf}.input_layernorm.weight"]
        out[f"{mine}/ln_mlp/scale"] = \
            state[f"{hf}.post_attention_layernorm.weight"]
        out[f"{mine}/attn/q/w"] = permute_rope_rows(
            state[f"{hf}.self_attn.q_proj.weight"], num_heads).T
        out[f"{mine}/attn/k/w"] = permute_rope_rows(
            state[f"{hf}.self_attn.k_proj.weight"], num_kv_heads).T
        out[f"{mine}/attn/v/w"] = state[f"{hf}.self_attn.v_proj.weight"].T
        out[f"{mine}/attn/o/w"] = state[f"{hf}.self_attn.o_proj.weight"].T
        out[f"{mine}/gate/w"] = state[f"{hf}.mlp.gate_proj.weight"].T
        out[f"{mine}/up/w"] = state[f"{hf}.mlp.up_proj.weight"].T
        out[f"{mine}/down/w"] = state[f"{hf}.mlp.down_proj.weight"].T
    out["ln_out/scale"] = state["model.norm.weight"]
    if "lm_head.weight" in state:
        out["lm_head/w"] = state["lm_head.weight"].T
    else:   # tied embeddings (llama-3.2 style)
        out["lm_head/w"] = state["model.embed_tokens.weight"].T
    return out


def read_head_config(model_dir: str):
    """Head counts from the checkpoint's own config.json — wrong manual
    flags would produce a shape-valid but silently garbage RoPE
    permutation."""
    config_path = os.path.join(model_dir, "config.json")
    if not os.path.exists(config_path):
        return None, None
    import json
    with open(config_path, encoding="utf-8") as handle:
        config = json.load(handle)
    heads = config.get("num_attention_heads")
    return heads, config.get("num_key_value_heads", heads)


def load_llama(pathname: str, config, device=None):
    """The port's Llama for `config` on `device` (None: the card) with
    every parameter from the npz at `pathname` (convert()'s keys)."""
    from ..models.llama import Llama
    return load_complete(Llama, config, pathname, device)


def load_complete(model_class, config, pathname: str, device=None):
    """A `model_class(config)` module with every parameter read from the
    flat npz at `pathname` through bridge.load_flat_npz, on `device`
    (None: the card).  Raises when the file lacks a parameter: the
    module is never initialised otherwise."""
    from .. import resolve_device
    from ..bridge import load_flat_npz

    device = resolve_device(device)
    model = model_class(config, device=device)
    with np.load(pathname) as archive:
        keys = set(archive.files)
    missing = sorted(key for key in (name.replace(".", "/") for name, _ in
                                     model.named_parameters())
                     if key not in keys)
    if missing:
        raise ValueError(f"{pathname} lacks {missing[:5]}")
    return load_flat_npz(model, pathname)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--num-heads", type=int, default=None,
                        help="attention heads (default: read from the "
                             "checkpoint's config.json)")
    parser.add_argument("--num-kv-heads", type=int, default=None,
                        help="KV heads (default: read from config.json)")
    args = parser.parse_args(argv)

    config_heads, config_kv = read_head_config(args.model_dir)
    num_heads = args.num_heads or config_heads
    num_kv_heads = args.num_kv_heads or config_kv
    if not num_heads or not num_kv_heads:
        config_path = os.path.join(args.model_dir, "config.json")
        reason = ("has no num_attention_heads/num_key_value_heads "
                  "entries" if os.path.exists(config_path)
                  else "does not exist")
        parser.error(f"{config_path} {reason}: pass "
                     f"--num-heads/--num-kv-heads explicitly")
    state = load_state_dict(args.model_dir)
    flat = convert(state, num_heads, num_kv_heads)
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, "weights.npz"),
             **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    for name in ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                 "merges.txt"):
        src = os.path.join(args.model_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out_dir, name))
    print(f"wrote {len(flat)} tensors to "
          f"{os.path.join(args.out_dir, 'weights.npz')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
