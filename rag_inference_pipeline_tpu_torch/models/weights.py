"""Parameter trees for the port's models: from HF safetensors checkpoints,
and from the JAX package's trees.

`bert_params_from_hf` / `qwen_params_from_hf` port the reference's mappers
(`rag_inference_pipeline_tpu/models/weights.py:82-200`): HF names, with the
`bert.` / `roberta.` / `model.` / `transformer.` prefix or none, map to the
port's `ParamTree` in its layouts (a float linear weight [in, out], as in
JAX; a `QuantizedLinear.q` [out, in], the HF layout). Each leaf is copied to
the device as it is mapped, read from its file straight onto the device
(on a CUDA device through one pinned buffer: `models/safetensors.py`), and
cast there to the param dtype (round half to even, as `jnp.asarray(x,
dtype)` rounds). The finished tree is checked, name and shape, against the
model's own skeleton. `BERT_EMBED_HF`, `BERT_LAYER_HF` and `QWEN_LAYER_HF`
name each leaf's HF tensor; a layer's 2-D leaves are its linear weights,
stored [out, in] by HF.

`bert_params_from_jax` / `qwen_params_from_jax` take a tree as the JAX
package builds it (`init_bert_params`, `init_qwen_params`: dicts and lists
of arrays, fetched to numpy with `jax.device_get`) and load it name for
name into the port's `ParamTree`, on the port's device and in its dtype.
Names and shapes are checked against the model's own skeleton
(`load_state_dict(strict=True)`), so a missing, extra or misshapen leaf
raises. Importing this module does not import jax.

A quantized JAX tree (`quantize_qwen_params`, `init_qwen_params_int8`,
`quantize_bert_params`: `QuantizedLinear` / `QuantizedEmbed` leaves) loads
into the port's W8A8 tree: `q` stays int8 and `s` float32 whatever the
param dtype, and a `QuantizedLinear.q` is transposed once to the port's
[out, in] layout (`models/layers.py::QuantizedLinear`).
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from .bert import BertConfig, init_bert_params, quantize_bert_params
from .layers import (
    ParamTree,
    QuantizedEmbed,
    QuantizedLinear,
    quantize_embed,
    quantize_linear,
)
from .qwen import QwenConfig, init_qwen_params, quantize_qwen_params
from .safetensors import SafetensorsDict

_PREFIXES = ("bert.", "roberta.", "model.", "transformer.", "")
# tree leaf -> HF name: BERT's `embeddings.*`, each BERT `encoder.layer.{i}.*`
# and each decoder `layers.{i}.*` (the qkv biases only under `qkv_bias`)
BERT_EMBED_HF = {
    "word": "word_embeddings.weight", "position": "position_embeddings.weight",
    "token_type": "token_type_embeddings.weight", "ln_w": "LayerNorm.weight",
    "ln_b": "LayerNorm.bias",
}
BERT_LAYER_HF = {
    "q_w": "attention.self.query.weight", "q_b": "attention.self.query.bias",
    "k_w": "attention.self.key.weight", "k_b": "attention.self.key.bias",
    "v_w": "attention.self.value.weight", "v_b": "attention.self.value.bias",
    "o_w": "attention.output.dense.weight", "o_b": "attention.output.dense.bias",
    "attn_ln_w": "attention.output.LayerNorm.weight",
    "attn_ln_b": "attention.output.LayerNorm.bias",
    "ffn_in_w": "intermediate.dense.weight", "ffn_in_b": "intermediate.dense.bias",
    "ffn_out_w": "output.dense.weight", "ffn_out_b": "output.dense.bias",
    "ffn_ln_w": "output.LayerNorm.weight", "ffn_ln_b": "output.LayerNorm.bias",
}
QWEN_LAYER_HF = {
    "in_ln": "input_layernorm.weight", "post_ln": "post_attention_layernorm.weight",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.o_proj.weight", "gate_w": "mlp.gate_proj.weight",
    "up_w": "mlp.up_proj.weight", "down_w": "mlp.down_proj.weight",
}
_QKV_BIAS = ("q_b", "k_b", "v_b")
# f32 elements of one block of rows quantized on load: bounds the
# quantization's temporaries on the device (64 MB)
_QUANT_BLOCK = 1 << 24


def _is_int8_leaf(v) -> bool:
    """The JAX package's `QuantizedLinear` / `QuantizedEmbed` (NamedTuples
    of q and s), told apart from a list of arrays by their fields."""
    return hasattr(v, "_fields") and set(v._fields) == {"q", "s"}


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if _is_int8_leaf(v):
            q = np.asarray(v.q)
            # the port keeps a linear's q [out, in]: K contiguous
            out[f"{name}.q"] = q.T if type(v).__name__ == "QuantizedLinear" else q
            out[f"{name}.s"] = np.asarray(v.s)
        elif isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _load(skeleton: ParamTree, tree, device) -> ParamTree:
    """Every leaf in the skeleton's dtype for its name: int8 as int8, the
    rest through float32 (numpy has no bfloat16 of its own: jax's comes
    from ml_dtypes; bf16 -> f32 -> bf16 is exact)."""
    want = skeleton.state_dict()
    state = {}
    for name, a in _flatten(tree).items():
        dtype = want[name].dtype if name in want else torch.float32
        if dtype == torch.int8:
            t = torch.from_numpy(np.array(a, np.int8))
        else:
            t = torch.from_numpy(np.array(a, np.float32))
        state[name] = t.to(device, dtype)
    skeleton.load_state_dict(state, strict=True, assign=True)
    return skeleton


def bert_params_from_jax(
    tree: dict, cfg: BertConfig, *, device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> ParamTree:
    skel = init_bert_params(cfg, generator=None, dtype=dtype, device="meta")
    if _is_int8_leaf(tree["pooler"]["w"]):
        skel = quantize_bert_params(skel)
    return _load(skel, tree, device)


def qwen_params_from_jax(
    tree: dict, cfg: QwenConfig, *, device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> ParamTree:
    skel = init_qwen_params(cfg, generator=None, dtype=dtype, device="meta",
                            quantize=_is_int8_leaf(tree["embed"]))
    return _load(skel, tree, device)


# ---------------------------------------------------------------------------
# HF safetensors checkpoints
# ---------------------------------------------------------------------------


def resolve_model_dir(weights_dir: Optional[str], model_name: str) -> Optional[str]:
    """`<weights_dir>/<model_name with / -> __>` when that directory exists."""
    if not weights_dir:
        return None
    cand = os.path.join(weights_dir, model_name.replace("/", "__"))
    return cand if os.path.isdir(cand) else None


class _T:
    """HF names looked up under each prefix in turn, each leaf copied to the
    device in the param dtype. `raw` is a `SafetensorsDict` (each leaf read
    from its file onto the device) or a plain dict of CPU tensors or numpy
    arrays."""

    def __init__(self, raw: Mapping, device, dtype: torch.dtype) -> None:
        self.raw = raw
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.dtype = dtype

    def key(self, name: str) -> str:
        for p in _PREFIXES:
            if p + name in self.raw:
                return p + name
        raise KeyError(
            f"weight {name!r} not found (tried prefixes {_PREFIXES}); "
            f"sample keys: {list(self.raw)[:5]}"
        )

    def has(self, name: str) -> bool:
        return any(p + name in self.raw for p in _PREFIXES)

    def shape(self, name: str) -> tuple:
        key = self.key(name)
        if isinstance(self.raw, SafetensorsDict):
            return self.raw.shape(key)
        return tuple(self.raw[key].shape)

    def fetch(self, key: str, rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """The leaf (or its rows [a, b)) on the device in its stored dtype."""
        if isinstance(self.raw, SafetensorsDict):
            return self.raw.load(key, self.device, rows)
        t = self.raw[key]
        t = torch.from_numpy(np.array(t)) if isinstance(t, np.ndarray) else t
        return (t[rows[0] : rows[1]] if rows else t).to(self.device, copy=True)

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        """The leaf on the device in the param dtype; `transpose` takes an
        HF linear weight [out, in] to the port's [in, out]."""
        x = self.fetch(self.key(name))
        if transpose:
            x = x.t()
        return x.to(self.dtype).contiguous()

    def quantized(self, name: str, embed: bool = False):
        """The leaf quantized as it loads, a block of rows at a time: each
        block goes to the device, is cast to the param dtype (the reference
        casts, then quantizes) and quantized by `quantize_linear` (an HF
        weight's row is an output column of the [in, out] weight) or
        `quantize_embed` (a row of the table); the scales are per row
        either way, so the blocks give the whole leaf's bits. Neither the
        float tree nor a whole float leaf is ever on the device."""
        key = self.key(name)
        rows, cols = self.shape(name)
        q = torch.empty((rows, cols), dtype=torch.int8, device=self.device)
        s = torch.empty(rows, dtype=torch.float32, device=self.device)
        step = max(1, _QUANT_BLOCK // max(cols, 1))
        for a in range(0, rows, step):
            b = min(a + step, rows)
            blk = self.fetch(key, (a, b)).to(self.dtype)
            qb = quantize_embed(blk) if embed else quantize_linear(blk.t())
            q[a:b] = qb.q
            s[a:b] = qb.s
        return QuantizedEmbed(q, s) if embed else QuantizedLinear(q, s)


def _float_shapes(params: ParamTree) -> dict[str, tuple]:
    """Each leaf's shape as a float tree holds it: a `QuantizedLinear` as
    its [in, out] weight, a `QuantizedEmbed` as its table."""
    out = {k: tuple(v.shape) for k, v in params.named_parameters()}
    for k, m in params.named_modules():
        if isinstance(m, QuantizedLinear):
            out[k] = tuple(m.q.shape[::-1])
        elif isinstance(m, QuantizedEmbed):
            out[k] = tuple(m.q.shape)
    return out


def _check_shapes(tree: dict, skeleton: ParamTree, what: str) -> ParamTree:
    """The mapped tree as a `ParamTree`, its names and shapes those of the
    model's float skeleton (a checkpoint of another model raises here, by
    leaf)."""
    params = ParamTree(tree)
    got, want = _float_shapes(params), _float_shapes(skeleton)
    for k in sorted(set(got) | set(want)):
        if got.get(k) != want.get(k):
            raise ValueError(
                f"{what}: leaf {k!r} has shape {got.get(k)}, the config wants {want.get(k)}"
            )
    return params


def bert_params_from_hf(
    raw: Mapping, cfg: BertConfig, *, device=None, dtype: torch.dtype = torch.float32,
) -> ParamTree:
    """HF BERT / RoBERTa names -> the port's BERT tree
    (`weights.py:82-150`): token types are zeros when absent, the pooler
    the identity when absent; a classifier takes `classifier.*`, or the
    RoBERTa head, whose `classifier.dense` becomes the pooler."""
    t = _T(raw, device, dtype)
    h = cfg.hidden

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=t.device)

    params = {"embeddings": {}, "layers": []}
    for k, hf in BERT_EMBED_HF.items():
        name = "embeddings." + hf
        params["embeddings"][k] = (
            t.get(name) if k != "token_type" or t.has(name) else zeros(cfg.type_vocab, h)
        )
    for i in range(cfg.layers):
        pre = f"encoder.layer.{i}."
        params["layers"].append({
            k: t.get(pre + hf, transpose=len(t.shape(pre + hf)) == 2)
            for k, hf in BERT_LAYER_HF.items()
        })
    if t.has("pooler.dense.weight"):
        params["pooler"] = {
            "w": t.get("pooler.dense.weight", transpose=True),
            "b": t.get("pooler.dense.bias"),
        }
    else:
        params["pooler"] = {
            "w": torch.eye(h, dtype=dtype, device=t.device), "b": zeros(h),
        }
    if cfg.num_labels:
        if t.has("classifier.weight"):
            params["classifier"] = {
                "w": t.get("classifier.weight", transpose=True),
                "b": t.get("classifier.bias"),
            }
        elif t.has("classifier.out_proj.weight"):  # the RoBERTa head
            params["classifier"] = {
                "w": t.get("classifier.out_proj.weight", transpose=True),
                "b": t.get("classifier.out_proj.bias"),
            }
            params["pooler"] = {
                "w": t.get("classifier.dense.weight", transpose=True),
                "b": t.get("classifier.dense.bias"),
            }
        else:
            raise KeyError("no classifier head found in checkpoint")
    skel = init_bert_params(cfg, generator=None, dtype=dtype, device="meta")
    return _check_shapes(params, skel, "bert checkpoint")


def qwen_params_from_hf(
    raw: Mapping, cfg: QwenConfig, *, device=None,
    dtype: torch.dtype = torch.bfloat16, quantize: bool = False,
) -> ParamTree:
    """HF decoder names -> the port's decoder tree (`weights.py:153-200`;
    Qwen2.5 and Llama-3.x share the layout, Llama without qkv biases). No
    `lm_head` under `tie_embeddings`. `quantize` quantizes each matmul leaf
    and the embedding as it loads (`_T.quantized`): leaf for leaf equal to
    `quantize_qwen_params(qwen_params_from_hf(raw, ...))`."""
    t = _T(raw, device, dtype)

    def w(name):
        return t.quantized(name) if quantize else t.get(name, transpose=True)

    params = {
        "embed": (
            t.quantized("embed_tokens.weight", embed=True) if quantize
            else t.get("embed_tokens.weight")
        ),
        "final_ln": t.get("norm.weight"),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w("lm_head.weight")
    for i in range(cfg.layers):
        pre = f"layers.{i}."
        params["layers"].append({
            k: w(pre + hf) if len(t.shape(pre + hf)) == 2 else t.get(pre + hf)
            for k, hf in QWEN_LAYER_HF.items() if cfg.qkv_bias or k not in _QKV_BIAS
        })
    skel = init_qwen_params(cfg, generator=None, dtype=dtype, device="meta")
    return _check_shapes(params, skel, "decoder checkpoint")
