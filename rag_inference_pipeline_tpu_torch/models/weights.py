"""Carry the JAX package's parameter trees into the port's modules.

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

from typing import Optional

import numpy as np
import torch

from .bert import BertConfig, init_bert_params, quantize_bert_params
from .layers import ParamTree
from .qwen import QwenConfig, init_qwen_params, quantize_qwen_params


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
