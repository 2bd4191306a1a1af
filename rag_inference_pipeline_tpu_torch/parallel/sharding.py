"""Parameter and activation placements over the dp x tp mesh.

Port of `rag_inference_pipeline_tpu/parallel/sharding.py`. Megatron tensor
parallelism for the transformer blocks:

- attention q/k/v column-parallel (the heads split over tp), the output
  projection o row-parallel;
- MLP gate/up (BERT's ffn_in) column-parallel, down (ffn_out)
  row-parallel;
- embeddings, norms, the pooler and the classifiers replicated; an untied
  `lm_head` column-parallel (the vocabulary split);
- activations batch-over-dp.

The reference declares `NamedSharding`s and lets XLA insert the psums. Here
a placement is a name: `COL` and `ROW` split an [in, out] weight's output
or input features, `VEC_TP` splits a vector, `REPL` keeps a leaf whole; a
`QSpec` gives a quantized leaf's int8 block and scales each their own (the
int8 block follows the weight's split, its per-column scales ride a column
split and stay whole across a row split, where they multiply after the
int32 sum). The names always describe the reference's [in, out] layout;
`shard_params` cuts the port's transposed `QuantizedLinear.q` ([out, in])
along the matching axis. The model functions take the `TPTree` it builds
and run each shard's local heads, summing the row-parallel partials over
the group (`models/layers.py::row_dense`).

Deliberate difference from the reference: a tp that would split a head
(it does not divide `heads` or `kv_heads`), the MLP width or an untied
head's vocabulary raises `ValueError` naming the dimension
(`check_tp`). The reference shards on whatever boundary its `device_put`
accepts; its decode engine states the GQA bound tp <= kv_heads
(`engine/decode_engine.py:355-359`) without checking it.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch

from ..core.mesh import MeshContext
from ..models.layers import (
    ParamTree,
    QuantizedEmbed,
    QuantizedLinear,
    TPTree,
)

COL = "col"  # [in, out]: the output features split over tp
ROW = "row"  # [in, out]: the input features split over tp
VEC_TP = "vec_tp"  # a vector split over tp
REPL = "repl"  # whole on every position


class QSpec(NamedTuple):
    """The placement of a quantized leaf: its int8 block `q` and its scales
    `s` (the reference's `QuantizedLinear(q=..., s=...)` of shardings)."""

    q: str
    s: str


def check_tp(cfg, tp: int) -> None:
    """Raise `ValueError` naming the dimension when tp does not divide the
    heads, the kv heads, the MLP width or (an untied decoder head) the
    vocabulary: a shard would hold part of a head."""
    dims = [("heads", cfg.heads), ("intermediate", cfg.intermediate)]
    if hasattr(cfg, "kv_heads"):
        dims.insert(1, ("kv_heads", cfg.kv_heads))
        if not cfg.tie_embeddings:
            dims.append(("vocab_size", cfg.vocab_size))
    for name, n in dims:
        if n % tp:
            bound = " (GQA: tp <= kv_heads)" if name == "kv_heads" else ""
            raise ValueError(f"tp={tp} does not divide {name}={n}: a shard would split "
                             f"a head or a row of the weights{bound}")


def _wq(p, base: str):
    """The placement of a maybe-quantized weight leaf."""
    if isinstance(p, QuantizedLinear):
        return QSpec(q=base, s=VEC_TP if base == COL else REPL)
    return base


def qwen_param_sharding(mesh_ctx: MeshContext, params, cfg=None) -> dict:
    """The placement tree of `models/qwen.py::init_qwen_params`'s layout,
    leaf for leaf as the reference's `qwen_param_sharding`; with `cfg`, tp
    is checked against its heads first (`check_tp`)."""
    if cfg is not None:
        check_tp(cfg, mesh_ctx.tp)
    tree = params.to_tree() if isinstance(params, ParamTree) else params
    out: dict[str, Any] = {
        "embed": QSpec(REPL, REPL) if isinstance(tree["embed"], QuantizedEmbed) else REPL,
        "final_ln": REPL,
        "layers": [],
    }
    if "lm_head" in tree:
        out["lm_head"] = _wq(tree["lm_head"], COL)
    for lp in tree["layers"]:
        ls = {
            "in_ln": REPL,
            "q_w": _wq(lp["q_w"], COL),
            "k_w": _wq(lp["k_w"], COL),
            "v_w": _wq(lp["v_w"], COL),
            "o_w": _wq(lp["o_w"], ROW),
            "post_ln": REPL,
            "gate_w": _wq(lp["gate_w"], COL),
            "up_w": _wq(lp["up_w"], COL),
            "down_w": _wq(lp["down_w"], ROW),
        }
        if "q_b" in lp:
            ls["q_b"] = ls["k_b"] = ls["v_b"] = VEC_TP
        out["layers"].append(ls)
    return out


def bert_param_sharding(mesh_ctx: MeshContext, params, cfg=None) -> dict:
    """The Megatron placements of the BERT encoder tree, leaf for leaf as
    the reference's `bert_param_sharding` (quantized leaves as in
    `qwen_param_sharding`); with `cfg`, tp is checked first."""
    if cfg is not None:
        check_tp(cfg, mesh_ctx.tp)
    tree = params.to_tree() if isinstance(params, ParamTree) else params
    out: dict[str, Any] = {
        "embeddings": {k: REPL for k in tree["embeddings"]},
        "layers": [],
        "pooler": {"w": _wq(tree["pooler"]["w"], REPL), "b": REPL},
    }
    if "classifier" in tree:
        out["classifier"] = {"w": _wq(tree["classifier"]["w"], REPL), "b": REPL}
    for lp in tree["layers"]:
        ls = {}
        for k in lp:
            if k in ("q_w", "k_w", "v_w", "ffn_in_w"):
                ls[k] = _wq(lp[k], COL)
            elif k in ("o_w", "ffn_out_w"):
                ls[k] = _wq(lp[k], ROW)
            elif k in ("q_b", "k_b", "v_b", "ffn_in_b"):
                ls[k] = VEC_TP
            else:
                ls[k] = REPL
        out["layers"].append(ls)
    return out


class _Cutter:
    """Cuts leaves for one (tp position, device): a split leaf's slice is a
    contiguous copy (so the whole tree can be freed); a whole leaf is
    copied once a distinct device, shared by every shard there."""

    def __init__(self, tp: int) -> None:
        self.tp = tp
        self._whole: dict = {}  # (id(leaf), device) -> the leaf there

    def whole(self, x, dev: torch.device):
        key = (id(x), dev)
        if key not in self._whole:
            self._whole[key] = (x, x if _device_of(x) == dev else _moved(x, dev))
        return self._whole[key][1]

    def cut(self, t: torch.Tensor, dim: int, j: int, dev: torch.device, name: str):
        n = t.shape[dim]
        if n % self.tp:
            raise ValueError(f"tp={self.tp} does not divide {name}'s dim {dim} ({n})")
        w = n // self.tp
        return t.narrow(dim, j * w, w).to(dev).clone()

    def leaf(self, x, spec, j: int, dev: torch.device, name: str):
        if isinstance(spec, QSpec):
            if spec == QSpec(REPL, REPL):
                return self.whole(x, dev)
            # QuantizedLinear.q is [out, in]: COL cuts dim 0, ROW dim 1
            q = self.cut(x.q, 0 if spec.q == COL else 1, j, dev, name + ".q")
            s = (self.cut(x.s, 0, j, dev, name + ".s") if spec.s == VEC_TP
                 else self.whole(x.s, dev))
            return type(x)(q, s)
        if spec == REPL:
            return self.whole(x, dev)
        if spec == COL:
            return self.cut(x, x.dim() - 1, j, dev, name)
        if spec in (ROW, VEC_TP):
            return self.cut(x, 0, j, dev, name)
        raise ValueError(f"unknown placement {spec!r} at {name}")


def _device_of(x) -> torch.device:
    if isinstance(x, torch.nn.Module):
        return next(iter(x.state_dict().values())).device
    return x.device


def _moved(x, dev: torch.device):
    if isinstance(x, torch.nn.Module):
        return type(x)(x.q.to(dev), x.s.to(dev))
    return x.to(dev)


def _build(tree, spec, cutter: _Cutter, j: int, dev: torch.device, path: str):
    if isinstance(tree, dict):
        if not isinstance(spec, dict) or set(spec) != set(tree):
            raise ValueError(f"placements do not mirror the tree at {path or 'the root'}")
        return {k: _build(tree[k], spec[k], cutter, j, dev, f"{path}{k}.")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_build(x, s, cutter, j, dev, f"{path}{i}.")
                for i, (x, s) in enumerate(zip(tree, spec))]
    return cutter.leaf(tree, spec, j, dev, path.rstrip("."))


def shard_params(mesh_ctx: MeshContext, params, shardings: dict) -> list:
    """`params` placed on the mesh by `shardings` -> one tree a dp position:
    a `TPTree` over the position's tp group (one `ParamTree` a tp position,
    each split leaf a contiguous slice on that position's device), or with
    tp = 1 the tree itself. Shards of the same tp position on the same
    device (dp positions that repeat a device) are one object, and a whole
    leaf is one copy a distinct device, as `engine/device_pipeline.py`
    replicates a tree."""
    tree = params.to_tree()
    home = _device_of(next(iter(params.state_dict().values())))
    cutter = _Cutter(mesh_ctx.tp)
    built: dict = {}
    groups = []
    for i in range(mesh_ctx.dp):
        devs = mesh_ctx.group(i)
        shards = []
        for j, dev in enumerate(devs):
            if mesh_ctx.tp == 1 and dev == home:
                built.setdefault((j, dev), params)
            if (j, dev) not in built:
                built[(j, dev)] = ParamTree(_build(tree, shardings, cutter, j, dev, ""))
            shards.append(built[(j, dev)])
        groups.append(TPTree(shards, devs) if mesh_ctx.tp > 1 else shards[0])
    return groups


def place_params(mesh_ctx: MeshContext, params, cfg) -> list:
    """`params` on every dp position of the mesh -> one tree a position:
    whole (tp = 1), or its Megatron shards over the position's tp group,
    with the placements of `qwen_param_sharding` (a `QwenConfig`) or
    `bert_param_sharding` (a `BertConfig`) after `check_tp`. A tree already
    split over a tp group (a component's) is regrouped: its shards are
    reused where the devices match and copied where they do not."""
    if isinstance(params, TPTree):
        if params.tp != mesh_ctx.tp:
            raise ValueError(f"a tree split over tp={params.tp} on a mesh of tp={mesh_ctx.tp}")
        moved: dict = {}
        groups = []
        for i in range(mesh_ctx.dp):
            devs = mesh_ctx.group(i)
            shards = []
            for j, dev in enumerate(devs):
                if dev == params.devices[j]:
                    shards.append(params.shards[j])
                else:
                    if (j, dev) not in moved:
                        moved[(j, dev)] = copy.deepcopy(params.shards[j]).to(dev)
                    shards.append(moved[(j, dev)])
            groups.append(TPTree(shards, devs))
        return groups
    spec = qwen_param_sharding if hasattr(cfg, "kv_heads") else bert_param_sharding
    return shard_params(mesh_ctx, params, spec(mesh_ctx, params, cfg))


def batch_sharding(mesh_ctx: MeshContext) -> str:
    """Activations: the batch (dim 0) over dp, everything else whole."""
    return mesh_ctx.rows_dp


def kv_cache_sharding(mesh_ctx: MeshContext) -> tuple:
    """The KV cache's placement, the reference's PartitionSpec(None, dp,
    None, tp, None) of [L, B, S, Hkv, Dh]: lanes over dp, kv heads over tp
    (the layout `models/qwen.py::KVCache.zeros(grid=mesh.grid)` builds)."""
    return (None, "dp", None, "tp", None)
