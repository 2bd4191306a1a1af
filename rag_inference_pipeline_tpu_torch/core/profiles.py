"""Role profiles: which components and routes a node hosts.

Port of the part of `rag_inference_pipeline_tpu/core/profiles.py` that the
one-node staged path needs, as Python data (the GPU machine has no yaml):
the built-in `single_node_full` (`profiles.py:117-139`) and the named
profiles `retrieval_default`, `retrieval_ivf`, `retrieval_ivfpq`,
`retrieval_pq4` and `retrieval_pq_host_refine`, with the same components,
per-component config and routes as `configs/<name>.yaml`. Selection, as in
`profiles.py:159`: PIPELINE_ROLE_PROFILE names a profile; else
TOTAL_NODES=1 means `single_node_full`. A multi-node deployment needs the
RPC hop, which is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .enums import ComponentType

ROUTES = ("gateway", "retrieval", "generation")


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

    def has(self, ctype: ComponentType) -> bool:
        return any(c.type is ctype for c in self.components)


def _specs(*types: str, config: Optional[dict] = None) -> tuple[ComponentSpec, ...]:
    """Component specs by type name; `config` maps a type name to its
    per-component config."""
    config = config or {}
    return tuple(
        ComponentSpec(ComponentType(t), config=dict(config.get(t, {}))) for t in types
    )


_PROFILES = {
    "single_node_full": Profile(
        name="single_node_full",
        description="full RAG pipeline on one mesh",
        components=_specs(
            "mesh", "embedder", "index", "doc_store", "reranker", "llm",
            "sentiment", "toxicity", "orchestrator",
        ),
        routes=ROUTES,
    ),
    "retrieval_default": Profile(
        name="retrieval_default",
        description="Node 1 baseline — embedder + index + docs",
        components=_specs("mesh", "embedder", "index", "doc_store"),
        routes=("retrieval",),
    ),
    "retrieval_ivf": Profile(
        name="retrieval_ivf",
        description="IVF-Flat index retrieval node",
        components=_specs(
            "mesh", "embedder", "index", "doc_store",
            config={"index": {"kind": "ivf_flat"}},
        ),
        routes=("retrieval",),
    ),
    "retrieval_ivfpq": Profile(
        name="retrieval_ivfpq",
        description="IVF-PQ compressed index retrieval node",
        components=_specs(
            "mesh", "embedder", "index", "doc_store",
            config={"index": {"kind": "ivf_pq"}},
        ),
        routes=("retrieval",),
    ),
    "retrieval_pq4": Profile(
        name="retrieval_pq4",
        description="PQ4 residual IVF-PQ codes (kernel K6) with exact bf16 "
        "re-score; set INDEX_PQ_M=192 at 768d",
        components=_specs(
            "mesh", "embedder", "index", "doc_store",
            config={"index": {"kind": "ivf_pq", "pq_bits": 4}},
        ),
        routes=("retrieval",),
    ),
    "retrieval_pq_host_refine": Profile(
        name="retrieval_pq_host_refine",
        description="PQ4 shortlist on the device, int8 refine store in host RAM",
        components=_specs(
            "mesh", "embedder", "index", "doc_store",
            config={"index": {
                "kind": "ivf_pq", "pq_bits": 4, "pq_rescore_kind": "host_int8",
            }},
        ),
        routes=("retrieval",),
    ),
}


def load_role_profile(settings) -> Profile:
    """PIPELINE_ROLE_PROFILE by name, else `single_node_full` on one node."""
    if settings.pipeline_role_profile:
        try:
            return _PROFILES[settings.pipeline_role_profile]
        except KeyError:
            raise ValueError(
                f"PIPELINE_ROLE_PROFILE={settings.pipeline_role_profile!r}: the "
                f"port carries {sorted(_PROFILES)}"
            ) from None
    if settings.total_nodes == 1:
        return _PROFILES["single_node_full"]
    raise NotImplementedError(
        f"TOTAL_NODES={settings.total_nodes}: a multi-node deployment needs "
        "the RPC hop of the serving stack, which is not ported yet (ROADMAP.md)"
    )
