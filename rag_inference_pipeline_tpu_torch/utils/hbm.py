"""The LLM's batch-bucket ladder clamped to the card's free memory.

Port of the clamp in `rag_inference_pipeline_tpu/utils/hbm.py:103-158`
(`llm_lane_bytes`, `derive_llm_bucket_ladder`), which the reference's
`LLMComponent.load` applies (`models/components.py:400-411`). The
reference's TPU reports no free memory, so it keeps an analytic ledger of
what each component parked and subtracts it from `HBM_BUDGET_GB`; CUDA
reports free memory itself, so the port takes the free bytes of the card
once the weights are loaded (`free_device_bytes`) in place of that budget,
with the same bytes a lane and the same 0.85 margin. The ledger and
`HBM_BUDGET_GB` are not ported.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

logger = logging.getLogger(__name__)

# the share of the free bytes the lanes may take (the reference's margin)
MARGIN = 0.85


def llm_lane_bytes(cfg, prompt_len: int, cache_len: int) -> int:
    """Device bytes one batch lane of the generate path costs: its bf16 KV
    cache, the prefill's [heads, P, P] f32 scores (two live) and ~4 live
    [P, intermediate] bf16 MLP buffers, as the reference counts them."""
    kv = 2 * cfg.layers * cache_len * cfg.kv_heads * cfg.head_dim * 2
    attn = 2 * cfg.heads * prompt_len * prompt_len * 4
    mlp = 4 * prompt_len * cfg.intermediate * 2
    return kv + attn + mlp


def free_device_bytes(device: torch.device) -> Optional[int]:
    """The bytes this process can still allocate on `device`: what the card
    reports free (`torch.cuda.mem_get_info`) plus what PyTorch's caching
    allocator holds unused there. None off the card."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device)
               - torch.cuda.memory_allocated(device))


def derive_llm_bucket_ladder(cfg, settings, free_bytes: Optional[int],
                             ladder: Sequence[int]) -> tuple[int, ...]:
    """The configured ladder cut to the buckets whose lanes fit
    `free_bytes * MARGIN`, the lane costed at the longest prompt and its
    cache (`truncate_length` within the model's context, plus
    `max_tokens`). Never empty: the smallest configured bucket stays, so a
    crowded card serves one lane rather than refusing. `free_bytes` None
    (no card) keeps the ladder. A clamp is logged, as the reference logs
    it."""
    ladder = tuple(ladder)
    if free_bytes is None:
        return ladder
    prompt_len = min(settings.truncate_length, cfg.max_len - settings.max_tokens)
    lane = llm_lane_bytes(cfg, prompt_len, prompt_len + settings.max_tokens)
    cap = int(free_bytes * MARGIN // lane) if lane > 0 else max(ladder)
    clamped = tuple(b for b in ladder if b <= cap) or ladder[:1]
    if clamped != ladder:
        logger.warning("llm bucket ladder clamped %s -> %s: %.2f GB free on the card "
                       "after the weights, %.1f MB/lane", list(ladder), list(clamped),
                       free_bytes / 2**30, lane / 2**20)
    return clamped
