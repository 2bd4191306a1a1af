"""Model components: embedder, reranker, LLM, sentiment and toxicity —
load (an HF safetensors checkpoint under `MODEL_WEIGHTS_DIR/<org__name>/`,
else random init when `ALLOW_RANDOM_WEIGHTS` allows it), tokenizer, params
on the port's device, and the batch APIs of the staged path.

Port of `rag_inference_pipeline_tpu/models/components.py`: the embedder's
SHA-256-keyed cache, the reranker's sigmoid relevance sorted descending,
the LLM's chat prompt from the top docs (`llm_doc_chars` each) with
prefill buckets, the 5-star sentiment labels and the 0.5 toxicity
threshold. Every forward runs over row chunks padded to the shape buckets,
as the reference pads them. The LLM's batch ladder is the configured one
cut, once its weights are loaded, to the lanes the card's free memory
holds (`utils/hbm.py`, the reference's `:400-411`); the generation path,
its warm-up and the decode engine's admission take that ladder.

Warm-up (`warmup_buckets`, reference `:175-183`, `:228-236`, `:412-430`):
the four encoders run one forward of each shape bucket (eager: nothing is
captured, but the first forward of a shape pays cuBLAS's set-up; the
classifiers not under the fused pipeline, whose executor warms them), the
embedder straight through its forward, so that no warm-up text lands in
the embedding cache. The LLM runs its per-chunk decode over dummy prompts
of each (batch bucket, prefill bucket) it can be handed, so that each
decode graph a request will replay (the greedy step graph, or
speculation's verify round) is captured before the first request. Its
batch buckets are the ladder up to the one that holds
GENERATION_BATCH_SIZE rows, the most its scheduler hands it: {1, 2, 4, 8}
x {128, 256, 512} by default, 12 graphs, where the reference warms its
whole (memory-clamped) ladder. Under USE_CONTINUOUS_BATCHING the engine
captures its segment graph when it starts, so the warm-up runs the eager
prefill only; with the fused pipeline the LLM warms nothing (the fused
executor warms its own buckets).

Every component takes the serving mesh (`core/mesh.py`, the reference's
`MeshContext` argument) and holds its weights on the mesh's front device,
which must be the `device` it is given. The staged forwards run the whole
batch there; the fused step splits its batch over dp itself
(`engine/device_pipeline.py`), with the weights once per distinct device.
On a mesh of tp > 1 each model's weights are its Megatron shards over the
front tp group (`parallel/sharding.py::place_params`, the reference's
`:123-135` and `:369-383`), and every forward, the decode loops and the
engine run them sharded; the warm-up captures the sharded step graphs.
Where the group spans distinct cards the decode steps run eagerly
(`decode_graph.uses_graphs`), which the LLM logs once at load.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import Settings
from ..core.device import torch_dtype
from ..core.mesh import MeshContext
from ..utils.cache import LRUCache
from ..utils.hbm import derive_llm_bucket_ladder, free_device_bytes
from ..utils.shapes import chunk_spans, pad_rows, pick_bucket
from . import decode_graph
from .bert import (
    BertConfig,
    bert_classify,
    bert_embed,
    init_bert_params,
    quantize_bert_params,
)
from .qwen import (
    KVCache,
    QwenConfig,
    cache_grid,
    greedy_generate,
    init_qwen_params,
    ngram_speculative_generate,
    qwen_prefill,
    tree_all_devices,
)
from .safetensors import load_safetensors_dict
from .tokenizer import make_tokenizer
from .weights import bert_params_from_hf, qwen_params_from_hf, resolve_model_dir

logger = logging.getLogger(__name__)

_SENTIMENT_LABELS = [
    "very negative", "negative", "neutral", "positive", "very positive",
]

_BERT_CONFIGS = {
    "BAAI/bge-base-en-v1.5": BertConfig.bge_base,
    "BAAI/bge-reranker-base": BertConfig.bge_reranker,
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


@torch.inference_mode()
def _bucketed_dispatch(fwd, arrays: Sequence[np.ndarray], buckets, device) -> list:
    """`fwd` launched over row chunks of at most the largest bucket, each
    padded to its bucket -> [(output on the device, real rows)]."""
    n = arrays[0].shape[0]
    outs = []
    for s, e in chunk_spans(n, max(buckets)):
        bucket = pick_bucket(e - s, buckets)
        padded = [torch.from_numpy(pad_rows(a[s:e], bucket)).to(device) for a in arrays]
        outs.append((fwd(*padded), e - s))
    return outs


@torch.inference_mode()
def _gather(pending: list) -> np.ndarray:
    """The real rows of dispatched chunks as float32 numpy."""
    return np.concatenate([out[:n].float().cpu().numpy() for out, n in pending])


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _checkpoint_dir(settings: Settings, model_name: str) -> Optional[str]:
    """The model's checkpoint directory, or None for random weights; with
    neither a checkpoint nor `allow_random_weights`, FileNotFoundError."""
    mdir = resolve_model_dir(settings.model_weights_dir, model_name)
    if mdir is None and not settings.allow_random_weights:
        raise FileNotFoundError(
            f"no weights for {model_name} under {settings.model_weights_dir}"
        )
    return mdir


def _front(device: torch.device, mesh: Optional[MeshContext]) -> torch.device:
    """The component's device: `device`, which must be the mesh's front."""
    if mesh is not None and torch.device(device) != mesh.front:
        raise ValueError(f"device {device} is not the mesh's front device {mesh.front}")
    return device


def _on_mesh(params, cfg, mesh: Optional[MeshContext]):
    """A loaded tree as the component serves it: on a mesh of tp > 1 its
    Megatron shards over the front tp group, else as it is."""
    if mesh is None or mesh.tp == 1:
        return params
    from ..parallel.sharding import place_params

    return place_params(mesh, params, cfg)[0]


class _BertBase:
    """Shared load for BERT-backed components."""

    CLASSIFIER = False

    def __init__(
        self, settings: Settings, model_name: str, device: torch.device,
        num_labels: int = 0, mesh: Optional[MeshContext] = None,
    ) -> None:
        self.settings = settings
        self.model_name = model_name
        self.device = _front(device, mesh)
        self.mesh = mesh
        self.cfg = _bert_config_for(model_name, num_labels)
        self.max_len = min(settings.truncate_length, self.cfg.max_positions)
        self.params = None
        self.tokenizer = None
        self.random_weights = False
        self.checkpoint_dir: Optional[str] = None
        self.warmed_buckets: tuple[int, ...] = ()

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        self._load()
        s = self.settings
        # the fused executor runs (and warms) the classifiers itself
        if s.warmup_buckets and not (s.use_fused_pipeline and self.CLASSIFIER):
            self.warmup()

    def warmup(self) -> None:
        """One forward of each shape bucket, outputs discarded."""
        for b in self.settings.shape_buckets:
            self._warm(b)
        self.warmed_buckets = tuple(self.settings.shape_buckets)
        logger.info("%s warmup: buckets %s done", type(self).__name__,
                    list(self.warmed_buckets))

    def _warm(self, b: int) -> None:
        raise NotImplementedError

    def _load(self) -> None:
        s = self.settings
        mdir = _checkpoint_dir(s, self.model_name)
        dtype = torch_dtype(s.param_dtype)
        if mdir:
            with load_safetensors_dict(mdir) as raw:
                self.params = bert_params_from_hf(
                    raw, self.cfg, device=self.device, dtype=dtype,
                )
        else:
            logger.warning(
                "%s: no local weights for %s — random init",
                type(self).__name__, self.model_name,
            )
            self.params = init_bert_params(
                self.cfg, generator=_generator(self.device), dtype=dtype,
                device=self.device,
            )
        if s.encoder_weight_quant == "int8":
            # W8A8-dynamic encoder, quantized after load as the reference's
            # components do
            self.params = quantize_bert_params(self.params)
        self.params = _on_mesh(self.params, self.cfg, self.mesh)
        self.random_weights = mdir is None
        self.checkpoint_dir = mdir
        self.tokenizer = make_tokenizer(
            self.model_name, s.model_weights_dir,
            vocab_size=self.cfg.vocab_size, pad_id=self.cfg.pad_token_id,
        )

    def _dispatch(self, fwd, arrays: Sequence[np.ndarray]) -> list:
        return _bucketed_dispatch(
            lambda *t: fwd(self.params, self.cfg, *t), arrays,
            self.settings.shape_buckets, self.device,
        )

    def _forward(self, fwd, arrays: Sequence[np.ndarray]) -> np.ndarray:
        return _gather(self._dispatch(fwd, arrays))


class EmbedderComponent(_BertBase):
    """Query embedding (BGE): `encode` returns L2-normalized float32 [B,
    dim], cached by the SHA-256 of the text; the fused step runs its
    forward itself."""

    def __init__(self, settings: Settings, device: torch.device,
                 mesh: Optional[MeshContext] = None):
        super().__init__(settings, settings.embedding_model, device, mesh=mesh)
        self.cache = LRUCache(
            settings.embedding_cache_capacity, name="embedding",
            run_id=settings.run_id, node=str(settings.node_number),
        )

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def _warm(self, b: int) -> None:
        ids, mask = self.tokenizer.encode_batch([f"warmup {i}" for i in range(b)], self.max_len)
        self._forward(bert_embed, (ids, mask))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not self.is_loaded:
            raise RuntimeError("embedder not loaded")
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        keys = [hashlib.sha256(t.encode()).hexdigest() for t in texts]
        out: dict[int, np.ndarray] = {}
        misses: list[int] = []
        for i, k in enumerate(keys):
            hit = self.cache.get(k)
            if hit is not None:
                out[i] = hit
            else:
                misses.append(i)
        if misses:
            ids, mask = self.tokenizer.encode_batch(
                [texts[i] for i in misses], self.max_len
            )
            emb = self._forward(bert_embed, (ids, mask))
            for j, i in enumerate(misses):
                out[i] = emb[j]
                self.cache.put(keys[i], emb[j])
        return np.stack([out[i] for i in range(len(texts))])


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class RerankerComponent(_BertBase):
    """Cross-encoder rerank: (query, doc) pairs -> sigmoid relevance,
    sorted descending, with `rerank_score` added to each doc."""

    def __init__(self, settings: Settings, device: torch.device,
                 mesh: Optional[MeshContext] = None):
        super().__init__(settings, settings.reranker_model, device, num_labels=1, mesh=mesh)
        self.max_len = min(settings.truncate_length, self.cfg.max_positions - 2)

    def _warm(self, b: int) -> None:
        self.score_pairs([("warmup", f"doc {i}") for i in range(b)])

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        if not self.is_loaded:
            raise RuntimeError("reranker not loaded")
        if not pairs:
            return np.zeros((0,), np.float32)
        ids, mask, tt = self.tokenizer.encode_pair_batch(pairs, self.max_len)
        if self.cfg.type_vocab == 1:
            # XLM-RoBERTa has one token type and its tokenizer gives all 0;
            # the hash tokenizer's second segment (type 1) has no row, where
            # the reference gathers NaN (ROADMAP.md Queue 3)
            tt = np.zeros_like(tt)
        logits = self._forward(bert_classify, (ids, mask, tt))[:, 0]
        return _sigmoid(logits)

    def _top(self, docs: Sequence[dict], scores: np.ndarray, top_n) -> list[dict]:
        order = np.argsort(-scores)
        top_n = top_n or self.settings.rerank_top_n
        return [{**docs[i], "rerank_score": float(scores[i])} for i in order[:top_n]]

    def rerank(
        self, query: str, docs: Sequence[dict], top_n: Optional[int] = None
    ) -> list[dict]:
        """docs: [{id, content, ...}] -> the top_n docs with 'rerank_score'."""
        if not docs:
            return []
        scores = self.score_pairs([(query, d.get("content", "")) for d in docs])
        return self._top(docs, scores, top_n)

    def rerank_batch(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        top_n: Optional[int] = None,
    ) -> list[list[dict]]:
        """Every query's pairs scored in one bucketed batch."""
        pairs, spans = [], []
        for q, docs in zip(queries, docs_batch):
            start = len(pairs)
            pairs.extend((q, d.get("content", "")) for d in docs)
            spans.append((start, len(pairs)))
        if not pairs:
            return [[] for _ in queries]
        scores = self.score_pairs(pairs)
        return [
            self._top(docs, scores[a:b], top_n)
            for (a, b), docs in zip(spans, docs_batch)
        ]


class SentimentComponent(_BertBase):
    """5-star sentiment head; labels in `_SENTIMENT_LABELS`."""

    CLASSIFIER = True

    def __init__(self, settings: Settings, device: torch.device,
                 mesh: Optional[MeshContext] = None):
        super().__init__(settings, settings.sentiment_model, device, num_labels=5, mesh=mesh)

    def _warm(self, b: int) -> None:
        self.analyze_batch([f"warmup {i}" for i in range(b)])

    def dispatch(self, texts: Sequence[str]) -> list:
        """The head launched over `texts`; `labels` reads it back."""
        if not self.is_loaded:
            raise RuntimeError("sentiment not loaded")
        if not texts:
            return []
        ids, mask = self.tokenizer.encode_batch([t[:512] for t in texts], self.max_len)
        return self._dispatch(bert_classify, (ids, mask))

    @staticmethod
    def labels(pending: list) -> list[str]:
        if not pending:
            return []
        return [_SENTIMENT_LABELS[int(i)] for i in _gather(pending).argmax(axis=1)]

    def analyze_batch(self, texts: Sequence[str]) -> list[str]:
        return self.labels(self.dispatch(texts))


class ToxicityComponent(_BertBase):
    """Multi-label toxicity head: toxic when the largest sigmoid >= 0.5."""

    CLASSIFIER = True
    THRESHOLD = 0.5

    def __init__(self, settings: Settings, device: torch.device,
                 mesh: Optional[MeshContext] = None):
        super().__init__(settings, settings.toxicity_model, device, num_labels=6, mesh=mesh)

    def _warm(self, b: int) -> None:
        self.check_batch([f"warmup {i}" for i in range(b)])

    def dispatch(self, texts: Sequence[str]) -> list:
        """The head launched over `texts`; `verdicts` reads it back."""
        if not self.is_loaded:
            raise RuntimeError("toxicity not loaded")
        if not texts:
            return []
        ids, mask = self.tokenizer.encode_batch([t[:512] for t in texts], self.max_len)
        return self._dispatch(bert_classify, (ids, mask))

    def verdicts(self, pending: list) -> list[tuple[bool, float]]:
        if not pending:
            return []
        worst = _sigmoid(_gather(pending)).max(axis=1)
        return [(bool(w >= self.THRESHOLD), float(w)) for w in worst]

    def check_batch(self, texts: Sequence[str]) -> list[tuple[bool, float]]:
        return self.verdicts(self.dispatch(texts))


class LLMComponent:
    """Causal LM (Qwen2 / Llama family): greedy decode, or n-gram
    speculation (`use_speculative_decoding`), per bucketed batch; or,
    with `use_continuous_batching`, one request at a time through the
    decode engine that `start()` runs."""

    def __init__(self, settings: Settings, device: torch.device,
                 mesh: Optional[MeshContext] = None):
        self.settings = settings
        self.device = _front(device, mesh)
        self.mesh = mesh
        self.model_name = settings.llm_model
        self.cfg = _qwen_config_for(self.model_name)
        lname = self.model_name.lower()
        # base checkpoints stop at end-of-text, instruct ones at the chat
        # turn delimiter
        self.is_instruct = "instruct" in lname or lname.startswith("tiny")
        # the batch buckets the card's memory holds: set at load
        self.ladder: tuple[int, ...] = settings.shape_buckets
        self.params = None
        self.tokenizer = None
        self.random_weights = False
        self.checkpoint_dir: Optional[str] = None
        self.engine = None
        self.warmed: tuple[tuple[int, int], ...] = ()

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        self._load()
        if self.settings.warmup_buckets:
            self.warmup()

    def _load(self) -> None:
        s = self.settings
        mdir = _checkpoint_dir(s, self.model_name)
        dtype = torch_dtype(s.param_dtype)
        # W8A8-dynamic int8 at the source: each matmul leaf is quantized as
        # it is read (or drawn), so the full-precision tree never exists
        quantize = s.llm_weight_quant == "int8"
        if mdir:
            with load_safetensors_dict(mdir) as raw:
                self.params = qwen_params_from_hf(
                    raw, self.cfg, device=self.device, dtype=dtype, quantize=quantize,
                )
        else:
            logger.warning("LLM: no local weights for %s — random init", self.model_name)
            self.params = init_qwen_params(
                self.cfg, generator=_generator(self.device), dtype=dtype,
                device=self.device, quantize=quantize,
            )
        self.params = _on_mesh(self.params, self.cfg, self.mesh)
        devs = tree_all_devices(self.params)
        if len(devs) > 1 and not decode_graph.uses_graphs(devs):
            logger.warning("LLM: the tp group spans %s: the decode steps run eagerly "
                           "(one CUDA graph cannot hold them)", [str(d) for d in devs])
        self.random_weights = mdir is None
        self.checkpoint_dir = mdir
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
        # the lanes that fit beside the weights and whatever the node loaded
        # before them (on a mesh, the front device's share)
        self.ladder = derive_llm_bucket_ladder(self.cfg, s, free_device_bytes(self.device),
                                               s.shape_buckets)

    def build_prompt(self, query: str, docs: Sequence[dict]) -> str:
        """Chat-template prompt from the top `llm_context_docs` docs, each
        cut to `llm_doc_chars`, per model family."""
        s = self.settings
        ctx = "\n\n".join(
            f"Document {i + 1}: {d.get('content', '')[: s.llm_doc_chars]}"
            for i, d in enumerate(docs[: s.llm_context_docs])
        )
        sys_msg = (
            "You are a helpful assistant. Use the provided "
            "context to answer the question."
        )
        user_msg = f"Context:\n{ctx}\n\nQuestion: {query}"
        if not self.is_instruct:
            return f"{sys_msg}\n\n{user_msg}\n\nAnswer:"
        if self.model_name.lower().startswith("meta-llama"):
            return (
                "<|begin_of_text|><|start_header_id|>system"
                f"<|end_header_id|>\n\n{sys_msg}<|eot_id|>"
                "<|start_header_id|>user"
                f"<|end_header_id|>\n\n{user_msg}<|eot_id|>"
                "<|start_header_id|>assistant<|end_header_id|>\n\n"
            )
        return (
            f"<|im_start|>system\n{sys_msg}<|im_end|>\n"
            f"<|im_start|>user\n{user_msg}<|im_end|>\n"
            "<|im_start|>assistant\n"
        )

    def generate_batch(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        max_new_tokens: Optional[int] = None,
    ) -> list[str]:
        """Greedy answers, one per query: prompts cut to a prefill bucket
        that covers the longest, rows padded to a shape bucket (a padded
        row keeps one live token), each answer cut at the first eos."""
        if not self.is_loaded:
            raise RuntimeError("llm not loaded")
        if not queries:
            return []
        s = self.settings
        max_new = max_new_tokens or s.max_tokens
        prompts = [self.build_prompt(q, d) for q, d in zip(queries, docs_batch)]
        plen_cap = self._prompt_cap(max_new)
        all_ids, all_mask = self.tokenizer.encode_batch(prompts, plen_cap)
        ladder = self.ladder
        out: list[str] = []
        for cs, ce in chunk_spans(len(prompts), max(ladder)):
            ids, mask = all_ids[cs:ce], all_mask[cs:ce]
            longest = int(mask.sum(axis=1).max())
            plen = min(pick_bucket(longest, s.prefill_bucket_list + (plen_cap,)), plen_cap)
            bucket = pick_bucket(ce - cs, ladder)
            ids = pad_rows(ids[:, :plen], bucket)
            mask = pad_rows(mask[:, :plen], bucket)
            mask[ce - cs :, 0] = 1
            out.extend(self._decode(ids, mask, ce - cs, max_new))
        return out

    def _prompt_cap(self, max_new: int) -> int:
        return min(self.settings.truncate_length, self.cfg.max_len - max_new)

    def _decode(self, ids: np.ndarray, mask: np.ndarray, n: int, max_new: int) -> list[str]:
        """One padded chunk through the decode loop: the answers of its
        first `n` rows, each cut at the first eos."""
        s = self.settings
        eos = self.tokenizer.eos_id
        args = (self.params, self.cfg, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), max_new)
        kw = dict(eos_token_id=eos, cache_len=ids.shape[1] + max_new)
        if s.use_speculative_decoding:
            toks, _ = ngram_speculative_generate(
                *args, gamma=s.speculative_gamma,
                inject_accept_p=s.speculative_inject_p, **kw,
            )
        else:
            toks = greedy_generate(*args, **kw)
        out = []
        for row in toks[:n].cpu().numpy():
            stop = np.where(row == eos)[0]
            end = int(stop[0]) if len(stop) else len(row)
            out.append(self.tokenizer.decode(row[:end]))
        return out

    def dispatched_buckets(self) -> tuple[int, ...]:
        """The batch buckets the generation scheduler can hand this LLM:
        the ladder up to the one that holds GENERATION_BATCH_SIZE rows."""
        ladder = self.ladder
        top = pick_bucket(self.settings.generation_batch_size, ladder)
        return tuple(b for b in sorted(ladder) if b <= top)

    def prefill_lengths(self, max_new: int) -> tuple[int, ...]:
        """Every prompt length `generate_batch` can pad a chunk to."""
        cap = self._prompt_cap(max_new)
        return tuple(sorted({min(p, cap) for p in self.settings.prefill_bucket_list + (cap,)}))

    def warmup(self) -> None:
        """Each (dispatched batch bucket, prefill length) once over dummy
        prompts: the decode loop (greedy or speculative, capturing its
        graph), or under USE_CONTINUOUS_BATCHING the eager prefill only."""
        s = self.settings
        if s.use_fused_pipeline:
            logger.info("llm warmup skipped: the fused pipeline owns decode")
            return
        max_new = s.max_tokens
        warmed = []
        for b in self.dispatched_buckets():
            for p in self.prefill_lengths(max_new):
                ids = np.ones((b, p), np.int32)
                if s.use_continuous_batching:
                    self._prefill(ids)
                else:
                    self._decode(ids, ids.copy(), b, max_new)
                warmed.append((b, p))
                logger.info("llm warmup: bucket=%d prefill=%d done", b, p)
        self.warmed = tuple(warmed)

    @torch.inference_mode()
    def _prefill(self, ids: np.ndarray) -> None:
        """The decode engine's admission prefill over `ids`, discarded."""
        s, cfg = self.settings, self.cfg
        dtype = torch.bfloat16 if self.params.final_ln.dtype == torch.bfloat16 else torch.float32
        s_alloc = s.kv_cache_max_len + (s.speculative_gamma + 1 if s.use_speculative_decoding else 0)
        cache = KVCache.zeros(cfg.layers, ids.shape[0], s_alloc, cfg.kv_heads, cfg.head_dim,
                              dtype=dtype, device=self.device, grid=cache_grid(self.params))
        t = torch.from_numpy(ids).to(self.device)
        logits, _ = qwen_prefill(self.params, cfg, t, t, cache)
        logits.cpu()

    # -- continuous-batching engine mode ------------------------------------
    async def start(self) -> None:
        """Start the persistent-lane decode engine when
        `use_continuous_batching` is set (engine/decode_engine.py); with
        speculation on too, its segments are verify rounds."""
        s = self.settings
        if not s.use_continuous_batching or not self.is_loaded or self.engine:
            return
        from ..engine.decode_engine import DecodeEngine

        self.engine = DecodeEngine(
            self.params, self.cfg,
            lanes=s.decode_max_concurrency,
            cache_len=s.kv_cache_max_len,
            segment_steps=s.decode_segment_steps,
            eos_token_id=self.tokenizer.eos_id,
            admit_buckets=self.ladder,
            prefill_buckets=s.prefill_bucket_list,
            pipeline_segments=s.decode_pipeline_segments,
            speculative=s.use_speculative_decoding,
            gamma=s.speculative_gamma,
            spec_rounds=s.speculative_rounds,
            inject_accept_p=s.speculative_inject_p,
            mesh=self.mesh,  # the lane pool over the mesh, as the weights
            run_id=s.run_id,
            node=str(s.node_number),
        )
        await self.engine.start()

    async def stop(self) -> None:
        if self.engine is not None:
            await self.engine.stop()
            self.engine = None

    async def generate_batch_engine(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        max_new_tokens: Optional[int] = None,
    ) -> list[str]:
        """One engine submission per request: a short answer returns as soon
        as its lane finishes, whatever the rest of the batch does."""
        if self.engine is None:
            raise RuntimeError("generation not ready: the decode engine is not running")
        s = self.settings
        max_new = max_new_tokens or s.max_tokens
        cap = min(s.truncate_length, self.cfg.max_len - max_new)
        subs = []
        for q, d in zip(queries, docs_batch):
            ids, mask = self.tokenizer.encode(self.build_prompt(q, d), cap)
            subs.append(self.engine.submit(ids[: int(mask.sum())], max_new))
        return [self.tokenizer.decode(t) for t in await asyncio.gather(*subs)]
