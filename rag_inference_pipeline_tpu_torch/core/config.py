"""Settings: environment variables -> a `Settings` dataclass.

Reads the same environment names, with the same defaults, as the JAX
package's `core/config.py::Settings`, for the fields the ported serving
slice reads. Plain stdlib: the GPU machine has no pydantic.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass
from typing import Optional

_BOOL_TRUE = {"1", "true", "yes", "on"}


@dataclass(frozen=True)
class Settings:
    """Field names upper-cased are the environment variable names."""

    # --- node topology ---
    node_number: int = 0
    base_port: int = 8000

    # --- device ---
    device_platform: Optional[str] = None  # None = cuda (core/device.py)
    param_dtype: str = "bfloat16"

    # --- batching ---
    batch_shape_buckets: str = "1,2,4,8,16,32,64"

    # --- index ---
    index_path: Optional[str] = None
    index_dtype: str = "bfloat16"

    # --- retrieval / generation semantics ---
    retrieval_k: int = 10
    max_tokens: int = 128
    truncate_length: int = 512
    llm_context_docs: int = 3
    # refused at load until the port carries them (W8A8, speculation)
    use_speculative_decoding: bool = False
    llm_weight_quant: str = "none"
    encoder_weight_quant: str = "none"

    # --- model names ---
    embedding_model: str = "BAAI/bge-base-en-v1.5"
    llm_model: str = "Qwen/Qwen2.5-0.5B-Instruct"
    sentiment_model: str = "nlptown/bert-base-multilingual-uncased-sentiment"
    toxicity_model: str = "unitary/toxic-bert"
    model_weights_dir: Optional[str] = None
    allow_random_weights: bool = True

    # --- telemetry ---
    log_level: str = "INFO"

    # --- fused device pipeline ---
    use_fused_pipeline: bool = False
    doc_tokens_path: Optional[str] = None
    fused_chunk_lanes: int = 8

    @property
    def listen_port(self) -> int:
        return self.base_port + self.node_number

    @property
    def listen_host(self) -> str:
        return "0.0.0.0"

    @property
    def shape_buckets(self) -> tuple[int, ...]:
        return tuple(int(x) for x in self.batch_shape_buckets.split(",") if x)


def _coerce(hint, raw: str):
    if hint is bool:
        return raw.lower() in _BOOL_TRUE
    if hint is int:
        return int(raw)
    if hint is float:
        return float(raw)
    return raw  # str and Optional[str]


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
