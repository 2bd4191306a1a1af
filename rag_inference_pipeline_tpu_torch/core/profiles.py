"""Role profiles: which components and routes a node hosts.

Port of `rag_inference_pipeline_tpu/core/profiles.py` with the profiles as
Python data (the GPU machine has no yaml): all 22 `configs/*.yaml`, with
the same names, descriptions, components, per-component config, routes and
`batch_overrides`; the built-in `single_node_full` (`profiles.py:117-139`);
and the built-in role profiles `gateway_default`, `retrieval_default` and
`generation_default` (`profiles.py:82-115`). A profile is checked as the
reference's validators check it (`profiles.py:48-76`): known routes, no
route twice, no alias twice, and each route's required component placed.

Selection, as in `profiles.py:156-176`: ROLE_PROFILE_OVERRIDE_PATH, a
YAML file, comes first (`load_profile_file`: read with `yaml.safe_load`
where `yaml` imports, refused by name where it does not, since the GPU
machine need not have it); else PIPELINE_ROLE_PROFILE names a profile;
else TOTAL_NODES=1 means `single_node_full`; else the node's role
(NODE_NUMBER 0, 1, 2) picks its built-in profile.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

from .enums import ComponentType, NodeRole

ROUTES = ("gateway", "retrieval", "generation")

_ROUTE_REQUIRES: dict[str, set[ComponentType]] = {
    "gateway": {ComponentType.ORCHESTRATOR},
    "retrieval": {ComponentType.INDEX},
    "generation": {ComponentType.LLM},
}


@dataclass(frozen=True)
class ComponentSpec:
    type: ComponentType
    alias: Optional[str] = None
    config: dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.alias or self.type.value


@dataclass(frozen=True)
class Profile:
    name: str
    components: tuple[ComponentSpec, ...]
    routes: tuple[str, ...]
    description: str = ""
    batch_overrides: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        bad = [r for r in self.routes if r not in ROUTES]
        if bad:
            raise ValueError(f"unknown routes {bad}; allowed: {sorted(ROUTES)}")
        if len(set(self.routes)) != len(self.routes):
            raise ValueError("duplicate routes in profile")
        names = [c.name for c in self.components]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate component aliases: {dupes}")
        placed = {c.type for c in self.components}
        for route in self.routes:
            missing = _ROUTE_REQUIRES[route] - placed
            if missing:
                raise ValueError(
                    f"route '{route}' requires components "
                    f"{sorted(t.value for t in missing)} not placed by profile "
                    f"'{self.name}'"
                )

    def has(self, ctype: ComponentType) -> bool:
        return any(c.type is ctype for c in self.components)


def _profile(
    name: str, description: str, types: str, routes: str,
    index: Optional[dict] = None,
) -> Profile:
    """A profile from space-separated component types and routes; `index`
    is the index component's config."""
    return Profile(
        name=name,
        description=description,
        components=tuple(
            ComponentSpec(
                ComponentType(t), config=dict(index or {}) if t == "index" else {}
            )
            for t in types.split()
        ),
        routes=tuple(routes.split()),
    )


_NAMED = {p.name: p for p in (
    _profile("gateway_default",
             "Node 0 baseline — orchestration only, all stages remote",
             "orchestrator", "gateway"),
    _profile("gateway_fat",
             "Gateway hosts embedder + reranker (reference gateway_fat.yaml)",
             "mesh embedder reranker orchestrator", "gateway"),
    _profile("gateway_postproc",
             "Gateway + embedder + sentiment/toxicity postproc local "
             "(reference gateway_postproc.yaml)",
             "mesh embedder sentiment toxicity orchestrator", "gateway"),
    _profile("gateway_with_embedding",
             "Gateway + embedder, downstream retrieval skips encoding "
             "(reference gateway_with_embedding.yaml)",
             "mesh embedder orchestrator", "gateway"),
    _profile("generation_default", "Node 2 baseline — rerank + LLM + postproc",
             "mesh reranker llm sentiment toxicity doc_store", "generation"),
    _profile("generation_fetch_rerank",
             "Generation node with doc store + reranker feeding the LLM, no "
             "sentiment/toxicity (reference generation_fetch_rerank.yaml)",
             "mesh doc_store reranker llm", "generation"),
    _profile("generation_fetch_rerank_full",
             "Generation node with doc store, reranker, LLM, sentiment and "
             "toxicity (reference generation_fetch_rerank_full.yaml)",
             "mesh doc_store reranker llm sentiment toxicity", "generation"),
    _profile("generation_full_postproc",
             "Generation with rerank + classifiers + doc store (id_only capable)",
             "mesh reranker llm sentiment toxicity doc_store", "generation"),
    _profile("generation_llm_only",
             "LLM-only generation node — rerank/postproc upstream",
             "mesh llm", "generation"),
    _profile("rerank_upstream",
             "Gateway-side rerank (reference rerank_upstream, best-p50 config)",
             "mesh embedder reranker orchestrator", "gateway"),
    _profile("retrieval_default", "Node 1 baseline — embedder + index + docs",
             "mesh embedder index doc_store", "retrieval"),
    _profile("retrieval_embedder_faiss_ids",
             "Embedder + index, id_only payloads — generation fetches bodies",
             "mesh embedder index", "retrieval"),
    _profile("retrieval_faiss_only",
             "Index-only retrieval — expects embeddings in the request",
             "mesh index", "retrieval"),
    _profile("retrieval_ivf", "IVF-Flat index retrieval node",
             "mesh embedder index doc_store", "retrieval", {"kind": "ivf_flat"}),
    _profile("retrieval_ivfpq", "IVF-PQ compressed index retrieval node",
             "mesh embedder index doc_store", "retrieval", {"kind": "ivf_pq"}),
    _profile("retrieval_postproc_hub",
             "Retrieval hub with rerank co-located (reference retrieval_postproc_hub)",
             "mesh embedder index doc_store reranker", "retrieval"),
    _profile("retrieval_postproc_no_embedding",
             "Retrieval node with index, doc store, reranker and postproc but "
             "NO embedder — callers ship embeddings "
             "(reference retrieval_postproc_no_embedding.yaml)",
             "mesh index doc_store reranker sentiment toxicity", "retrieval"),
    _profile("retrieval_pq4",
             "PQ4 compressed retrieval node: 4-bit residual IVF-PQ codes "
             "scanned by the one-hot MXU ADC dedup kernel with exact bf16 "
             "re-score. The >=10M-row capacity profile (codes are ~32x smaller "
             "than bf16 vectors). Set INDEX_PQ_BITS=4 and double INDEX_PQ_M "
             "(e.g. 192 at 768d) for bits/row parity with the PQ8 profile.\n",
             "mesh embedder index doc_store", "retrieval",
             {"kind": "ivf_pq", "pq_bits": 4}),
    _profile("retrieval_pq_host_refine",
             "The >=30M single-chip capacity profile: 4-bit residual IVF-PQ "
             "codes in HBM shortlist on the one-hot MXU ADC kernel; the exact "
             "int8 refine store lives in HOST RAM (faiss refine-from-storage "
             "shape — 23 GB at 30M x 768 fits host RAM, never HBM). Device "
             "returns the shortlist ids (KBs), the host gathers + exactly "
             "re-scores. Recall-floor play where no exact rescore copy fits "
             "on-chip; see PERF_NOTES \">=30M regime\".\n",
             "mesh embedder index doc_store", "retrieval",
             {"kind": "ivf_pq", "pq_bits": 4, "pq_rescore_kind": "host_int8"}),
    _profile("retrieval_rerank_no_embedding",
             "Retrieval node with index + doc store + reranker, no embedder "
             "(reference retrieval_rerank_no_embedding.yaml)",
             "mesh index doc_store reranker", "retrieval"),
    _profile("retrieval_with_rerank",
             "Rerank on the retrieval node — best-throughput reference config",
             "mesh embedder index doc_store reranker", "retrieval"),
    _profile("single_node_full",
             "Full RAG pipeline on one mesh — the TPU-native default topology",
             "mesh embedder index doc_store reranker llm sentiment toxicity "
             "orchestrator", "gateway retrieval generation"),
)}

_SINGLE_NODE = _profile(
    "single_node_full", "full RAG pipeline on one mesh",
    "mesh embedder index doc_store reranker llm sentiment toxicity orchestrator",
    "gateway retrieval generation",
)

_BUILTIN = {
    NodeRole.GATEWAY: _profile("gateway_default", "", "orchestrator", "gateway"),
    NodeRole.RETRIEVAL: _profile(
        "retrieval_default", "", "mesh embedder index doc_store", "retrieval"
    ),
    NodeRole.GENERATION: _profile(
        "generation_default", "",
        "mesh reranker llm sentiment toxicity doc_store", "generation",
    ),
}


def profile_names() -> list[str]:
    """The named profiles the port carries (the reference's configs/*.yaml)."""
    return sorted(_NAMED)


def named_profile(name: str) -> Profile:
    try:
        return _NAMED[name]
    except KeyError:
        raise ValueError(
            f"PIPELINE_ROLE_PROFILE={name!r}: the port carries {profile_names()}"
        ) from None


def builtin_profile(role: NodeRole) -> Profile:
    """The default profile of a node's role on a multi-node deployment."""
    return _BUILTIN[role]


_PROFILE_KEYS = ("name", "description", "components", "routes", "batch_overrides")
_COMPONENT_KEYS = ("type", "alias", "config")


def _expect(value, kind, what: str, path: str):
    if not isinstance(value, kind):
        raise ValueError(f"profile file {path}: {what} must be a {kind.__name__}")
    return value


def profile_from_mapping(data: dict, path: str) -> Profile:
    """A parsed profile file as the reference's pydantic `Profile`
    validates it: typed fields with their defaults, keys it does not know
    ignored, each component's type one of `ComponentType`, then the
    routes, aliases and required components checked."""
    name = _expect(data.get("name"), str, "name", path)
    description = data.get("description", "")
    _expect(description, str, "description", path)
    components = []
    for i, c in enumerate(_expect(data.get("components", []), list, "components", path)):
        _expect(c, dict, f"components[{i}]", path)
        try:
            ctype = ComponentType(c.get("type"))
        except ValueError:
            raise ValueError(
                f"profile file {path}: components[{i}].type {c.get('type')!r} is "
                f"not one of {[t.value for t in ComponentType]}"
            ) from None
        alias = c.get("alias")
        if alias is not None:
            _expect(alias, str, f"components[{i}].alias", path)
        config = c.get("config", {})
        _expect(config, dict, f"components[{i}].config", path)
        components.append(ComponentSpec(ctype, alias=alias, config=dict(config)))
    routes = _expect(data.get("routes", []), list, "routes", path)
    for r in routes:
        _expect(r, str, "each route", path)
    overrides = _expect(data.get("batch_overrides", {}), dict, "batch_overrides", path)
    return Profile(
        name=name, description=description, components=tuple(components),
        routes=tuple(routes), batch_overrides=dict(overrides),
    )


def load_profile_file(path: str) -> Profile:
    """A YAML profile file (the reference's `load_profile_file`): it must
    parse to a mapping; `name` defaults to the file's stem."""
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            f"ROLE_PROFILE_OVERRIDE_PATH={path!r}: reading a profile file needs "
            "the yaml package (PyYAML), which does not import here; name one "
            f"of the port's profiles with PIPELINE_ROLE_PROFILE: {profile_names()}"
        ) from None
    with open(path, "r", encoding="utf-8") as fh:
        data = yaml.safe_load(fh)
    if not isinstance(data, dict):
        raise ValueError(f"profile file {path} did not parse to a mapping")
    data.setdefault("name", os.path.splitext(os.path.basename(path))[0])
    return profile_from_mapping(data, path)


def load_role_profile(settings) -> Profile:
    """ROLE_PROFILE_OVERRIDE_PATH's file, else PIPELINE_ROLE_PROFILE by
    name, else `single_node_full` on one node, else the built-in profile of
    the node's role."""
    if settings.role_profile_override_path:
        return load_profile_file(settings.role_profile_override_path)
    if settings.pipeline_role_profile:
        return named_profile(settings.pipeline_role_profile)
    if settings.total_nodes == 1:
        return _SINGLE_NODE
    return builtin_profile(settings.node_role)
