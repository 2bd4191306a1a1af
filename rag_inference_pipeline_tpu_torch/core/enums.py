"""Enums of the settings and role profiles, as
`rag_inference_pipeline_tpu/core/enums.py` names them (str-valued, so a
member equals its string)."""

from __future__ import annotations

import enum


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
