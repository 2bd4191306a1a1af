"""Model components of the fused serving path: embedder, LLM, sentiment
and toxicity classifiers — load (random init when no weights are given),
tokenizer and params on the port's device.

Port of the load side of `rag_inference_pipeline_tpu/models/components.py`.
PyTorch runs eagerly, so there is no per-bucket compile warmup to port.
Loading safetensors checkpoints comes with a later port of the weights
converter; until then a checkpoint under `MODEL_WEIGHTS_DIR` raises rather
than being ignored.
"""

from __future__ import annotations

import logging
import os
import torch

from ..core.config import Settings
from ..core.device import torch_dtype
from .bert import BertConfig, init_bert_params
from .qwen import QwenConfig, init_qwen_params
from .tokenizer import make_tokenizer

logger = logging.getLogger(__name__)

_SENTIMENT_LABELS = [
    "very negative", "negative", "neutral", "positive", "very positive",
]

_BERT_CONFIGS = {
    "BAAI/bge-base-en-v1.5": BertConfig.bge_base,
    "nlptown/bert-base-multilingual-uncased-sentiment": BertConfig.sentiment,
    "unitary/toxic-bert": BertConfig.toxicity,
}


def _bert_config_for(name: str, num_labels: int = 0) -> BertConfig:
    if name in _BERT_CONFIGS:
        return _BERT_CONFIGS[name]()
    if name.startswith("tiny"):
        return BertConfig.tiny(num_labels=num_labels)
    raise ValueError(f"unknown bert model {name!r}")


def _qwen_config_for(name: str) -> QwenConfig:
    lname = name.lower()
    if lname.startswith("tiny"):
        return QwenConfig.tiny()
    if lname == "qwen/qwen2.5-0.5b-instruct":
        return QwenConfig.qwen25_05b()
    if lname in ("meta-llama/llama-3.2-1b-instruct", "meta-llama/llama-3.2-1b"):
        return QwenConfig.llama32_1b()
    if lname in ("meta-llama/llama-3.1-8b-instruct", "meta-llama/llama-3.1-8b"):
        return QwenConfig.llama31_8b()
    raise ValueError(f"unknown llm model {name!r}")


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _check_no_checkpoint(settings: Settings, model_name: str) -> None:
    wdir = settings.model_weights_dir
    if wdir and os.path.isdir(os.path.join(wdir, model_name.replace("/", "__"))):
        raise NotImplementedError(
            f"{model_name}: checkpoint loading is not ported yet; unset "
            "MODEL_WEIGHTS_DIR to serve random weights"
        )
    if not settings.allow_random_weights:
        raise FileNotFoundError(f"no weights for {model_name} under {wdir}")


class _BertBase:
    """Shared load for BERT-backed components."""

    def __init__(
        self, settings: Settings, model_name: str, device: torch.device,
        num_labels: int = 0,
    ) -> None:
        self.settings = settings
        self.model_name = model_name
        self.device = device
        self.cfg = _bert_config_for(model_name, num_labels)
        self.max_len = min(settings.truncate_length, self.cfg.max_positions)
        self.params = None
        self.tokenizer = None
        self.random_weights = False

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        s = self.settings
        if s.encoder_weight_quant != "none":
            raise NotImplementedError("ENCODER_WEIGHT_QUANT is not ported yet")
        _check_no_checkpoint(s, self.model_name)
        logger.warning(
            "%s: no local weights for %s — random init",
            type(self).__name__, self.model_name,
        )
        self.params = init_bert_params(
            self.cfg, generator=_generator(self.device),
            dtype=torch_dtype(s.param_dtype), device=self.device,
        )
        self.random_weights = True
        self.tokenizer = make_tokenizer(
            self.model_name, s.model_weights_dir,
            vocab_size=self.cfg.vocab_size, pad_id=self.cfg.pad_token_id,
        )


class EmbedderComponent(_BertBase):
    """Query embedding model (BGE); the fused step runs its forward."""

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.embedding_model, device)

    @property
    def dim(self) -> int:
        return self.cfg.hidden


class SentimentComponent(_BertBase):
    """5-star sentiment head; labels in `_SENTIMENT_LABELS`."""

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.sentiment_model, device, num_labels=5)


class ToxicityComponent(_BertBase):
    """Multi-label toxicity head: toxic when the largest sigmoid >= 0.5."""

    THRESHOLD = 0.5

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.toxicity_model, device, num_labels=6)


class LLMComponent:
    """Causal LM (Qwen2 / Llama family) for greedy decode."""

    def __init__(self, settings: Settings, device: torch.device):
        self.settings = settings
        self.device = device
        self.model_name = settings.llm_model
        self.cfg = _qwen_config_for(self.model_name)
        lname = self.model_name.lower()
        # base checkpoints stop at end-of-text, instruct ones at the chat
        # turn delimiter
        self.is_instruct = "instruct" in lname or lname.startswith("tiny")
        self.params = None
        self.tokenizer = None
        self.random_weights = False

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        s = self.settings
        if s.llm_weight_quant != "none":
            raise NotImplementedError("LLM_WEIGHT_QUANT is not ported yet")
        _check_no_checkpoint(s, self.model_name)
        logger.warning("LLM: no local weights for %s — random init", self.model_name)
        self.params = init_qwen_params(
            self.cfg, generator=_generator(self.device),
            dtype=torch_dtype(s.param_dtype), device=self.device,
        )
        self.random_weights = True
        fam_llama = self.model_name.lower().startswith("meta-llama")
        if self.is_instruct:
            eos_token = "<|eot_id|>" if fam_llama else "<|im_end|>"
        else:
            eos_token = "<|end_of_text|>" if fam_llama else "<|endoftext|>"
        self.tokenizer = make_tokenizer(
            self.model_name, s.model_weights_dir,
            vocab_size=self.cfg.vocab_size, pad_id=0, eos_id=2,
            eos_token=eos_token,
        )
