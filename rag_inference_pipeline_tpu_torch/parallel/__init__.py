"""Tensor and sequence parallelism: the Megatron tp splits of the encoder
and decoder weights (`sharding.py`) and the sequence-parallel encoder
(`sequence.py`). Port of `rag_inference_pipeline_tpu/parallel/`."""

from .sequence import bert_encode_sp
from .sharding import (
    batch_sharding,
    bert_param_sharding,
    kv_cache_sharding,
    qwen_param_sharding,
    shard_params,
)

__all__ = [
    "bert_encode_sp",
    "batch_sharding",
    "bert_param_sharding",
    "kv_cache_sharding",
    "qwen_param_sharding",
    "shard_params",
]
