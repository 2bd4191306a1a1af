"""Settings: environment variables -> a `Settings` dataclass.

Reads the same environment names, with the same defaults, as the JAX
package's `core/config.py::Settings`, for the fields the ported serving
paths read. Plain stdlib: the GPU machine has no pydantic.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import typing
from dataclasses import dataclass
from typing import Optional

from .enums import IndexKind, NodeRole, PayloadMode, derive_node_role

_BOOL_TRUE = {"1", "true", "yes", "on"}


@dataclass(frozen=True)
class Settings:
    """Field names upper-cased are the environment variable names."""

    # --- node topology ---
    node_number: int = 0
    total_nodes: int = 1
    node_0_ip: str = "127.0.0.1"
    node_1_ip: str = "127.0.0.1"
    node_2_ip: str = "127.0.0.1"
    base_port: int = 8000
    pipeline_role_profile: Optional[str] = None
    # refused by name (core/profiles.py): the card does not guarantee yaml
    role_profile_override_path: Optional[str] = None

    # --- device ---
    device_platform: Optional[str] = None  # None = cuda (core/device.py)
    param_dtype: str = "bfloat16"

    # --- batching ---
    gateway_batch_size: int = 8
    gateway_batch_timeout_ms: float = 50.0
    retrieval_batch_size: int = 32
    retrieval_batch_timeout_ms: float = 20.0
    generation_batch_size: int = 8
    generation_batch_timeout_ms: float = 50.0
    gateway_pipeline_chunks: int = 4
    adaptive_batching: bool = True
    adaptive_min_delay_ms: float = 5.0
    batch_flush_on_ready: bool = True
    batch_shape_buckets: str = "1,2,4,8,16,32,64"

    # --- caches ---
    query_cache_capacity: int = 1024
    query_cache_ttl_s: float = 300.0
    query_cache_fuzzy: bool = False
    embedding_cache_capacity: int = 10000
    search_cache_capacity: int = 4096
    document_cache_capacity: int = 8192
    document_cache_ttl_s: float = 600.0

    # --- index ---
    index_kind: IndexKind = IndexKind.FLAT
    index_path: Optional[str] = None
    index_dim: int = 768
    index_metric: str = "ip"
    index_nlist: int = 4096
    index_nprobe: int = 64
    index_pq_m: int = 96  # subspaces (768/8)
    index_pq_bits: int = 8  # 4 = PQ4 (ksub=16, kernel K6), 8 = PQ8
    index_dtype: str = "bfloat16"
    index_search_oversample: int = 4
    index_rescore_k: int = 64
    index_rescore_store: str = "device"  # "host" is refused (not ported)
    index_pq_rescore_k: int = 256  # IVF-PQ shortlist re-score depth
    # exact | int4 | pq8 | host_int8 | host_f16 (index/ivf_pq.py)
    index_pq_rescore_kind: str = "exact"
    index_cap_factor: float = 2.5

    # --- retrieval / generation semantics ---
    retrieval_k: int = 10
    rerank_top_n: int = 3
    max_tokens: int = 128
    truncate_length: int = 512
    llm_context_docs: int = 3
    llm_doc_chars: int = 200
    # n-gram (prompt-lookup) speculation: token-identical to greedy
    # (models/qwen.py::ngram_speculative_generate)
    use_speculative_decoding: bool = False
    speculative_gamma: int = 8
    # benchmark-only Bernoulli(p) draft acceptance; the text is then no
    # longer greedy's. Never set it for serving.
    speculative_inject_p: Optional[float] = None
    # verify rounds per engine segment when the engine and speculation are
    # both on (engine/decode_engine.py)
    speculative_rounds: int = 2
    # W8A8-dynamic int8 weights: none | int8 (the decoder quantized at the
    # source, the four encoders after load; ops/w8a8.py)
    llm_weight_quant: str = "none"
    encoder_weight_quant: str = "none"

    # --- payload / compression (serve/compression.py) ---
    documents_payload_mode: PayloadMode = PayloadMode.FULL
    compression_algorithm: str = "zstd"  # zstd | none
    compression_level: int = 3
    compression_min_bytes: int = 512

    # --- model names ---
    embedding_model: str = "BAAI/bge-base-en-v1.5"
    reranker_model: str = "BAAI/bge-reranker-base"
    llm_model: str = "Qwen/Qwen2.5-0.5B-Instruct"
    sentiment_model: str = "nlptown/bert-base-multilingual-uncased-sentiment"
    toxicity_model: str = "unitary/toxic-bert"
    model_weights_dir: Optional[str] = None
    allow_random_weights: bool = True

    # --- doc store ---
    document_db_path: Optional[str] = None
    doc_store_backend: str = "native"  # sqlite | memory; native is refused
    doc_store_in_memory: bool = False

    # --- serving / rpc (serve/rpc.py) ---
    request_timeout_s: float = 120.0
    rpc_retries: int = 3
    rpc_backoff_base_s: float = 0.1
    http_max_connections: int = 100

    # --- telemetry ---
    log_level: str = "INFO"

    # --- fused device pipeline ---
    use_fused_pipeline: bool = False
    doc_tokens_path: Optional[str] = None
    fused_chunk_lanes: int = 8

    # --- generation decode engine (engine/decode_engine.py) ---
    use_continuous_batching: bool = False
    decode_segment_steps: int = 8
    decode_max_concurrency: int = 32  # engine lanes
    # dispatch segment N+1 before reading segment N's done flags
    decode_pipeline_segments: bool = True
    prefill_buckets: str = "128,256,512"
    kv_cache_max_len: int = 1024

    def __post_init__(self) -> None:
        """The reference's `_check_total_nodes`, `_check_node_number`,
        `_check_weight_quant` and `_check_pq` validators."""
        if not 1 <= self.total_nodes <= 3:
            raise ValueError("total_nodes must be 1..3 (1 = single-process mode)")
        if self.node_number not in (0, 1, 2):
            raise ValueError("node_number must be 0, 1 or 2")
        if self.compression_algorithm not in ("zstd", "none"):
            raise ValueError("compression_algorithm must be 'zstd' or 'none'")
        for name in ("llm_weight_quant", "encoder_weight_quant"):
            if getattr(self, name) not in ("none", "int8"):
                raise ValueError(f"{name} must be 'none' or 'int8'")
        if self.index_dim % self.index_pq_m != 0:
            raise ValueError(
                f"index_dim ({self.index_dim}) must be divisible by "
                f"index_pq_m ({self.index_pq_m})"
            )
        if self.index_pq_bits not in (4, 8):
            raise ValueError(
                "index_pq_bits must be 4 (PQ4, ksub=16 — double index_pq_m "
                "for equal bits/row) or 8 (PQ8, ksub=256)"
            )
        if self.index_cap_factor < 1.0:
            raise ValueError(
                "index_cap_factor must be >= 1.0 (bucket capacity as a "
                "multiple of the mean list size)"
            )
        if self.index_rescore_store not in ("device", "host"):
            raise ValueError("index_rescore_store must be 'device' or 'host'")
        if self.index_pq_rescore_kind not in (
            "exact", "int4", "pq8", "host_int8", "host_f16"
        ):
            raise ValueError(
                "index_pq_rescore_kind must be 'exact', 'int4', 'pq8', "
                "'host_int8' or 'host_f16'"
            )

    @property
    def node_role(self) -> NodeRole:
        return derive_node_role(self.node_number)

    def node_url(self, node: int) -> str:
        ip = getattr(self, f"node_{node}_ip")
        return f"http://{ip}:{self.base_port + node}"

    @property
    def retrieval_url(self) -> str:
        return self.node_url(1 if self.total_nodes > 1 else 0)

    @property
    def generation_url(self) -> str:
        """Node 2 with three nodes; with two, generation stays on node 0."""
        return self.node_url(2 if self.total_nodes > 2 else 0)

    @property
    def listen_port(self) -> int:
        return self.base_port + self.node_number

    @property
    def listen_host(self) -> str:
        return "0.0.0.0"

    @property
    def shape_buckets(self) -> tuple[int, ...]:
        return tuple(int(x) for x in self.batch_shape_buckets.split(",") if x)

    @property
    def prefill_bucket_list(self) -> tuple[int, ...]:
        return tuple(int(x) for x in self.prefill_buckets.split(",") if x)


def _coerce(hint, raw: str):
    args = typing.get_args(hint)
    if typing.get_origin(hint) is typing.Union and type(None) in args:
        hint = next(a for a in args if a is not type(None))  # Optional[X]
    if hint is bool:
        return raw.lower() in _BOOL_TRUE
    if hint is int:
        return int(raw)
    if hint is float:
        return float(raw)
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return hint(raw)
    return raw  # str and Optional[str]


def replace_settings(settings: Settings, **raw) -> Settings:
    """`settings` with fields replaced; each value is coerced from its
    string form as an environment variable would be."""
    hints = typing.get_type_hints(Settings)
    return dataclasses.replace(
        settings, **{k: _coerce(hints[k], str(v)) for k, v in raw.items()}
    )


def load_settings(env: Optional[dict[str, str]] = None) -> Settings:
    """Build Settings from the process environment, overridden by `env`."""
    merged = dict(os.environ)
    if env:
        merged.update(env)
    hints = typing.get_type_hints(Settings)
    kwargs = {}
    for f in dataclasses.fields(Settings):
        raw = merged.get(f.name.upper())
        if raw is not None:
            kwargs[f.name] = _coerce(hints[f.name], raw)
    return Settings(**kwargs)
