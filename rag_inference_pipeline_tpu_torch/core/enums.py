"""Enums of the settings and role profiles, as
`rag_inference_pipeline_tpu/core/enums.py` names them (str-valued, so a
member equals its string), and the node-number -> role derivation."""

from __future__ import annotations

import enum


class NodeRole(str, enum.Enum):
    GATEWAY = "gateway"
    RETRIEVAL = "retrieval"
    GENERATION = "generation"


class IndexKind(str, enum.Enum):
    FLAT = "flat"
    IVF_FLAT = "ivf_flat"
    IVF_PQ = "ivf_pq"


class PayloadMode(str, enum.Enum):
    """What document payloads a retrieval result carries: full bodies, ids
    only, or a compressed blob."""

    FULL = "full"
    ID_ONLY = "id_only"
    COMPRESSED = "compressed"


class ComponentType(str, enum.Enum):
    """Kinds of components a role profile may place on a node."""

    MESH = "mesh"
    EMBEDDER = "embedder"
    INDEX = "index"
    DOC_STORE = "doc_store"
    RERANKER = "reranker"
    LLM = "llm"
    SENTIMENT = "sentiment"
    TOXICITY = "toxicity"
    ORCHESTRATOR = "orchestrator"


def derive_node_role(node_number: int) -> NodeRole:
    """Node number -> default role: 0 gateway, 1 retrieval, 2 generation."""
    mapping = {0: NodeRole.GATEWAY, 1: NodeRole.RETRIEVAL, 2: NodeRole.GENERATION}
    try:
        return mapping[node_number]
    except KeyError:
        raise ValueError(
            f"node_number must be 0, 1, or 2; got {node_number}"
        ) from None
