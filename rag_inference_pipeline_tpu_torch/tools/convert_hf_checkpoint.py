"""Copy a local HF checkpoint directory into the port's weights layout,
`MODEL_WEIGHTS_DIR/<org__name>/*.safetensors` plus the tokenizer files,
and check that the port loads it.

    python -m rag_inference_pipeline_tpu_torch.tools.convert_hf_checkpoint \\
        SRC_DIR Qwen/Qwen2.5-0.5B-Instruct --weights-dir artifacts/weights --arch qwen

Port of `scripts/convert_hf_checkpoint.py`. SRC_DIR is an already
downloaded snapshot (nothing is fetched): its `*.safetensors` are copied
as they are; a checkpoint with only `*.bin` files is read with
`torch.load(weights_only=True)` and written as one `model.safetensors` by
the port's own writer (`models/safetensors.py`). The result is then loaded
through the port's mappers (`models/weights.py`) in bf16 and run through
one forward pass: a prefill of 8 tokens for a decoder, an embedding for an
encoder. The model name must be one the port serves (`models/components.py`
names its configurations). The check runs on the card, or on the CPU with
`--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Optional

import torch

TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.txt",
    "sentencepiece.bpe.model",
)


def copy_checkpoint(src: str, dst: str) -> int:
    """Copy the safetensors and tokenizer files of `src` into `dst`, or,
    with no safetensors there, re-serialize its `*.bin` state dicts.
    Returns the number of files written."""
    from ..models.safetensors import save_safetensors

    os.makedirs(dst, exist_ok=True)
    copied = 0
    for f in sorted(os.listdir(src)):
        if f.endswith(".safetensors") or f in TOKENIZER_FILES:
            shutil.copy(os.path.join(src, f), os.path.join(dst, f))
            copied += 1
    if not any(f.endswith(".safetensors") for f in os.listdir(dst)):
        bins = sorted(f for f in os.listdir(src) if f.endswith(".bin"))
        if not bins:
            raise FileNotFoundError(f"no safetensors or .bin weights in {src}")
        state: dict[str, torch.Tensor] = {}
        for b in bins:
            state.update(torch.load(os.path.join(src, b), map_location="cpu",
                                    weights_only=True))
        save_safetensors(state, os.path.join(dst, "model.safetensors"))
        copied += 1
    return copied


@torch.inference_mode()
def validate(model_dir: str, model_name: str, arch: str, device: torch.device) -> str:
    """Load `model_dir` through the port's mappers in bf16 and run one
    forward pass; returns a line that says what ran."""
    from ..models.bert import bert_embed
    from ..models.components import _bert_config_for, _qwen_config_for
    from ..models.qwen import KVCache, qwen_prefill
    from ..models.safetensors import load_safetensors_dict
    from ..models.weights import bert_params_from_hf, qwen_params_from_hf

    ids = torch.arange(1, 9, device=device)[None]
    mask = torch.ones_like(ids)
    with load_safetensors_dict(model_dir) as raw:
        if arch in ("qwen", "llama"):
            cfg = _qwen_config_for(model_name)
            params = qwen_params_from_hf(raw, cfg, device=device, dtype=torch.bfloat16)
            cache = KVCache.zeros(cfg.layers, 1, 8, cfg.kv_heads, cfg.head_dim,
                                  device=device)
            logits, _ = qwen_prefill(params, cfg, ids, mask, cache)
            out, what = logits, "logits"
        else:
            cfg = _bert_config_for(model_name)
            params = bert_params_from_hf(raw, cfg, device=device, dtype=torch.bfloat16)
            out, what = bert_embed(params, cfg, ids, mask), "embedding"
    if not bool(torch.isfinite(out).all()):
        raise ValueError(f"{model_name}: the forward pass gave non-finite {what}")
    return f"validated {arch} forward on {device}: {what} {tuple(out.shape)}"


def main(argv: Optional[list[str]] = None) -> int:
    from ..core.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="local HF snapshot directory")
    p.add_argument("model_name", help="canonical name, e.g. BAAI/bge-base-en-v1.5")
    p.add_argument("--weights-dir", default="artifacts/weights")
    p.add_argument("--arch", choices=["bert", "qwen", "llama"], required=True,
                   help="which mapper validates the converted weights")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the check's forward pass runs")
    args = p.parse_args(argv)

    dst = os.path.join(args.weights_dir, args.model_name.replace("/", "__"))
    print(f"copied {copy_checkpoint(args.src, dst)} files -> {dst}")
    print(validate(dst, args.model_name, args.arch, resolve_device(args.device)))
    print(f"\nUse with: MODEL_WEIGHTS_DIR={os.path.abspath(args.weights_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
