"""Carry the JAX package's parameter trees into the port's modules.

`bert_params_from_jax` / `qwen_params_from_jax` take a tree as the JAX
package builds it (`init_bert_params`, `init_qwen_params`: dicts and lists
of arrays, fetched to numpy with `jax.device_get`) and load it name for
name into the port's `ParamTree`, on the port's device and in its dtype.
Names and shapes are checked against the model's own skeleton
(`load_state_dict(strict=True)`), so a missing, extra or misshapen leaf
raises. Importing this module does not import jax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bert import BertConfig, init_bert_params
from .layers import ParamTree
from .qwen import QwenConfig, init_qwen_params


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _load(skeleton: ParamTree, tree, device, dtype) -> ParamTree:
    state = {
        # float32 first: numpy has no bfloat16 of its own (jax's comes from
        # ml_dtypes), and bf16 -> f32 -> bf16 is exact
        name: torch.from_numpy(np.array(a, np.float32)).to(device, dtype)
        for name, a in _flatten(tree).items()
    }
    skeleton.load_state_dict(state, strict=True, assign=True)
    return skeleton


def bert_params_from_jax(
    tree: dict, cfg: BertConfig, *, device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> ParamTree:
    skel = init_bert_params(cfg, generator=None, dtype=dtype, device="meta")
    return _load(skel, tree, device, dtype)


def qwen_params_from_jax(
    tree: dict, cfg: QwenConfig, *, device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> ParamTree:
    skel = init_qwen_params(cfg, generator=None, dtype=dtype, device="meta")
    return _load(skel, tree, device, dtype)
