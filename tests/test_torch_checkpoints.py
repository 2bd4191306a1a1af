"""Port parity for checkpoint loading: the port's numpy safetensors reader
and writer against the `safetensors` package, the port's HF mappers against
the JAX package's (every leaf bit for bit, f32, bf16 and int8), the
components and both /query paths on the committed tiny checkpoints
(tests/fixtures/weights) against the JAX package, the tokenizer refusal,
and the two checkpoint tools. No test needs `transformers`.

The JAX package's reader (`load_safetensors_dict`) returns BF16 tensors only
with jax imported (ml_dtypes registers the dtype); this file imports jax.
"""

import asyncio
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from rag_inference_pipeline_tpu.core import make_mesh
from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.engine.fused_executor import (
    FusedExecutor as JFusedExecutor,
)
from rag_inference_pipeline_tpu.engine.orchestrator import Orchestrator as JOrchestrator
from rag_inference_pipeline_tpu.index.base import BaseIndex as JBaseIndex
from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.models import components as jcomp
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu.models import weights as jweights
from rag_inference_pipeline_tpu.models.tokenizer import make_tokenizer as j_make_tokenizer
from rag_inference_pipeline_tpu.serve.services import (
    GenerationService as JGenerationService,
)
from rag_inference_pipeline_tpu.serve.services import (
    RetrievalExecutor as JRetrievalExecutor,
)
from rag_inference_pipeline_tpu.utils.docstore import DocumentStore as JDocumentStore
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import weights as tweights
from rag_inference_pipeline_tpu_torch.models.bert import BertConfig
from rag_inference_pipeline_tpu_torch.models.layers import QuantizedEmbed, QuantizedLinear
from rag_inference_pipeline_tpu_torch.models.qwen import (
    KVCache,
    QwenConfig,
    greedy_generate,
    qwen_prefill,
    quantize_qwen_params,
)
from rag_inference_pipeline_tpu_torch.models.safetensors import (
    load_safetensors_dict,
    save_safetensors,
)
from rag_inference_pipeline_tpu_torch.models.tokenizer import HFTokenizer, make_tokenizer
from rag_inference_pipeline_tpu_torch.models.weights import (
    BERT_EMBED_HF,
    BERT_LAYER_HF,
    QWEN_LAYER_HF,
    bert_params_from_hf,
    bert_params_from_jax,
    qwen_params_from_hf,
    qwen_params_from_jax,
    resolve_model_dir,
)
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.tools import convert_hf_checkpoint, create_test_docs
from rag_inference_pipeline_tpu_torch.utils.docstore import DocumentStore

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "weights")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixture -> classifier labels (0: the embedder, no head)
LABELS = {"tiny-bert": 0, "tiny-rerank": 1, "tiny-sent": 5, "tiny-tox": 6}
FIXTURES = ["tiny-qwen", *LABELS]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """A tensor's or array's bytes, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def assert_trees_bitwise(a, b) -> None:
    """Two `ParamTree`s: the same names, dtypes, shapes and bits."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        np.testing.assert_array_equal(_bits(sa[k]), _bits(sb[k]), err_msg=k)


def _configs(name: str):
    if name == "tiny-qwen":
        return jqwen.QwenConfig.tiny(), QwenConfig.tiny()
    return (jbert.BertConfig.tiny(num_labels=LABELS[name]),
            BertConfig.tiny(num_labels=LABELS[name]))


def _map_both(model_dir: str, name: str, dtype: str, quantize: bool = False):
    """(port tree, JAX tree carried across) from one checkpoint directory."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _configs(name)
    jraw = jweights.load_safetensors_dict(model_dir)
    with load_safetensors_dict(model_dir) as raw:
        if isinstance(tcfg, QwenConfig):
            t = qwen_params_from_hf(raw, tcfg, dtype=tdt, quantize=quantize)
            j = jweights.qwen_params_from_hf(jraw, jcfg, jdt, quantize=quantize)
            return t, qwen_params_from_jax(jax.device_get(j), tcfg, dtype=tdt)
        t = bert_params_from_hf(raw, tcfg, dtype=tdt)
        j = jweights.bert_params_from_hf(jraw, jcfg, jdt)
        return t, bert_params_from_jax(jax.device_get(j), tcfg, dtype=tdt)


def _fixture_tensors(name: str) -> dict:
    with safe_open(os.path.join(FIXTURE, name, "model.safetensors"), "pt") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


# ---------------------------------------------------------------------------
# The reader and the writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_reader_matches_safetensors_on_fixtures(name):
    ref = _fixture_tensors(name)
    with load_safetensors_dict(os.path.join(FIXTURE, name)) as raw:
        assert sorted(raw) == sorted(ref) and len(raw) == len(ref)
        for k, v in ref.items():
            assert raw.files[0].entries[k][0] == "F32"
            assert raw[k].dtype == v.dtype and torch.equal(raw[k], v), k
        assert raw.nbytes == sum(v.numel() * v.element_size() for v in ref.values())


_ALL = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _sample(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    return torch.randint(lo, hi, shape, generator=g).to(dtype)


@pytest.mark.parametrize("fmt", list(_ALL))
def test_reader_reads_every_dtype(tmp_path, fmt):
    """A file the `safetensors` package wrote, and one laid out by hand with
    the tensor after 3 bytes (the format does not align offsets)."""
    tensors = {"w": _sample(_ALL[fmt], (5, 3), 1), "after": _sample(_ALL[fmt], (7,), 2),
               "scalar": _sample(_ALL[fmt], (), 3), "odd": torch.ones(3, dtype=torch.uint8)}
    save_file(tensors, str(tmp_path / "m.safetensors"))
    w = _bits(tensors["w"]).tobytes()
    header = (f'{{"odd":{{"dtype":"U8","shape":[3],"data_offsets":[0,3]}},'
              f'"w":{{"dtype":"{fmt}","shape":[5,3],"data_offsets":[3,{3 + len(w)}]}}}}')
    os.makedirs(tmp_path / "unaligned")
    _header_file(str(tmp_path / "unaligned" / "m.safetensors"), header.encode(),
                 b"\x01\x01\x01" + w)
    with load_safetensors_dict(str(tmp_path)) as raw, \
            load_safetensors_dict(str(tmp_path / "unaligned")) as odd:
        for k, v in tensors.items():
            assert raw[k].dtype == v.dtype and raw[k].shape == v.shape
            np.testing.assert_array_equal(_bits(raw[k]), _bits(v), err_msg=k)
        assert raw.files[0].entries["w"][0] == fmt
        np.testing.assert_array_equal(_bits(odd["w"]), _bits(tensors["w"]))
        assert odd["w"].dtype == tensors["w"].dtype and torch.equal(odd["odd"], tensors["odd"])
        if fmt == "BF16":  # the stored bits, as 16-bit integers
            np.testing.assert_array_equal(raw["w"].view(torch.int16).numpy(),
                                          tensors["w"].view(torch.int16).numpy())


def test_writer_round_trips(tmp_path):
    """The port's writer: the `safetensors` package and the port's reader
    read back every tensor, bf16 from torch and from jax (ml_dtypes) alike,
    and the metadata."""
    tensors = {f"t_{fmt}": _sample(dt, (4, 6), i) for i, (fmt, dt) in enumerate(_ALL.items())}
    tensors["scalar"] = torch.tensor(2.5)
    tensors["empty"] = torch.zeros((0, 3), dtype=torch.bfloat16)
    tensors["transposed"] = _sample(torch.float32, (3, 5), 9).t()
    jbf16 = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32), jnp.bfloat16))
    path = str(tmp_path / "model.safetensors")
    n = save_safetensors({**tensors, "jax_bf16": jbf16}, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
        for k, v in tensors.items():
            assert torch.equal(f.get_tensor(k), v), k
        np.testing.assert_array_equal(_bits(f.get_tensor("jax_bf16")), _bits(jbf16))
    with load_safetensors_dict(str(tmp_path)) as raw:
        for k, v in tensors.items():
            assert torch.equal(raw[k], v), k
        assert raw.files[0].entries["jax_bf16"][0] == "BF16"
        assert raw.files[0].metadata == {"format": "pt"}


def test_sharded_checkpoint(tmp_path):
    """Every `*.safetensors` of a directory, in sorted order; the same
    tensors as the JAX package's reader (BF16 included: jax is imported)."""
    full = {k: v.to(torch.bfloat16) for k, v in _fixture_tensors("tiny-qwen").items()}
    names = sorted(full)
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2 :])):
        save_file({k: full[k] for k in part},
                  str(tmp_path / f"model-{i + 1:05d}-of-00002.safetensors"))
    jraw = jweights.load_safetensors_dict(str(tmp_path))
    with load_safetensors_dict(str(tmp_path)) as raw:
        assert [os.path.basename(f.path) for f in raw.files] == [
            "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
        assert sorted(raw) == names == sorted(jraw)
        for k in names:
            assert torch.equal(raw[k], full[k])
            np.testing.assert_array_equal(_bits(raw[k]), _bits(jraw[k]))


def _header_file(path, header: bytes, data: bytes = b"", length=None) -> None:
    n = len(header) if length is None else length
    with open(path, "wb") as f:
        f.write(n.to_bytes(8, "little") + header + data)


@pytest.mark.parametrize("case,match", [
    ("unknown_dtype", "unknown dtype 'F8_E4M3'"),
    ("truncated_header", "runs past the file's end"),
    ("short_file", "shorter than the header length"),
    ("overlapping", "overlapping offsets"),
    ("out_of_range", "out of range"),
    ("wrong_size", "needs 16"),
    ("in_two_shards", "appears in both"),
])
def test_reader_refuses_by_name(tmp_path, case, match):
    p = str(tmp_path / "a.safetensors")
    data = bytes(32)
    if case == "unknown_dtype":
        _header_file(p, b'{"x":{"dtype":"F8_E4M3","shape":[2],"data_offsets":[0,2]}}', data)
    elif case == "truncated_header":
        _header_file(p, b'{"x":{"dtype":"F32","shape":[2]', length=4096)
    elif case == "short_file":
        with open(p, "wb") as f:
            f.write(b"\x10\x00")
    elif case == "overlapping":
        _header_file(p, b'{"x":{"dtype":"F32","shape":[4],"data_offsets":[0,16]},'
                        b'"y":{"dtype":"F32","shape":[4],"data_offsets":[8,24]}}', data)
    elif case == "out_of_range":
        _header_file(p, b'{"x":{"dtype":"F32","shape":[4],"data_offsets":[24,40]}}', data)
    elif case == "wrong_size":
        _header_file(p, b'{"x":{"dtype":"F32","shape":[4],"data_offsets":[0,12]}}', data)
    else:
        save_file({"x": torch.ones(2)}, p)
        save_file({"x": torch.zeros(2)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match=match):
        load_safetensors_dict(str(tmp_path))


@pytest.mark.parametrize("fmt", ["BF16", "F32", "BOOL"])
def test_streaming_reader(tmp_path, fmt):
    """The reader a CUDA load uses (`read_into`: the file read through a
    staging buffer a buffer at a time), here into CPU tensors through an
    unpinned 7-byte buffer: whole tensors, blocks of rows, a scalar."""
    tensors = {"w": _sample(_ALL[fmt], (9, 5), 4), "s": _sample(_ALL[fmt], (), 5)}
    save_file(tensors, str(tmp_path / "m.safetensors"))
    staging = torch.empty(7, dtype=torch.uint8)
    with load_safetensors_dict(str(tmp_path)) as raw:
        f = raw.files[0]
        for k, v in tensors.items():
            out = torch.empty_like(v)
            f.read_into(k, out, staging)
            np.testing.assert_array_equal(_bits(out), _bits(v))
        rows = torch.empty((4, 5), dtype=_ALL[fmt])
        f.read_into("w", rows, staging, start=3 * 5 * rows.element_size())
        np.testing.assert_array_equal(_bits(rows), _bits(tensors["w"][3:7]))
        np.testing.assert_array_equal(_bits(raw.load("w", "cpu", (3, 7))), _bits(rows))
        with pytest.raises(ValueError, match="read past the end"):
            f.read_into("w", rows, staging, start=6 * 5 * rows.element_size())


def test_header_queries_and_missing_files(tmp_path, monkeypatch):
    """`in` and `shape` answer from the headers and read no tensor; a
    tensor is read anew from its file each time; a directory without
    safetensors raises."""
    big = torch.randn(300, 1000)
    save_file({"big": big, "b": torch.arange(5)}, str(tmp_path / "m.safetensors"))
    with load_safetensors_dict(str(tmp_path)) as raw:
        first = raw["big"]
        first.zero_()
        assert torch.equal(raw["big"], big) and torch.equal(raw["b"], torch.arange(5))

        def no_read(*a):
            raise AssertionError("a tensor was read")

        monkeypatch.setattr(os, "preadv", no_read)
        assert "big" in raw and "model.big" not in raw and 3 not in raw
        assert raw.shape("big") == (300, 1000) and raw.shape("b") == (5,)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        load_safetensors_dict(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# The mappers, leaf for leaf against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", FIXTURES)
def test_mappers_match_jax_on_fixtures(name, dtype):
    t, j = _map_both(os.path.join(FIXTURE, name), name, dtype)
    assert_trees_bitwise(t, j)
    if name == "tiny-qwen":  # the fixture's lm_head is not read: tied
        assert t.get("lm_head") is None


@pytest.mark.parametrize("fmt", ["BF16", "F16"])
@pytest.mark.parametrize("name", ["tiny-qwen", "tiny-tox"])
def test_mappers_match_jax_on_half_checkpoints(tmp_path, name, fmt):
    """Checkpoints stored in BF16 (as Qwen2.5 and Llama ship) and F16,
    mapped to f32 and bf16 trees."""
    save_file({k: v.to(_ALL[fmt]) for k, v in _fixture_tensors(name).items()},
              str(tmp_path / "model.safetensors"))
    for dtype in DTYPES:
        assert_trees_bitwise(*_map_both(str(tmp_path), name, dtype))


@pytest.mark.parametrize("ckpt", ["F32", "BF16"])
def test_quantize_on_load_matches_jax(tmp_path, monkeypatch, ckpt):
    """int8 quantize-on-load: the JAX package's `qwen_params_from_hf(...,
    quantize=True)` and `quantize_qwen_params` of the port's bf16 load,
    leaf for leaf, with the rows quantized in blocks of 3 to 64 rows."""
    save_file({k: v.to(_ALL[ckpt]) for k, v in _fixture_tensors("tiny-qwen").items()},
              str(tmp_path / "model.safetensors"))
    monkeypatch.setattr(tweights, "_QUANT_BLOCK", 200)
    t, j = _map_both(str(tmp_path), "tiny-qwen", "bfloat16", quantize=True)
    assert_trees_bitwise(t, j)
    assert isinstance(t.embed, QuantizedEmbed) and isinstance(t.layers[0].q_w, QuantizedLinear)
    with load_safetensors_dict(str(tmp_path)) as raw:
        bf16 = qwen_params_from_hf(raw, QwenConfig.tiny(), dtype=torch.bfloat16)
    assert_trees_bitwise(t, quantize_qwen_params(bf16))


def _llama_cfgs():
    kw = dict(qkv_bias=False, tie_embeddings=False, rope_scaling=(8.0, 1.0, 4.0, 64))
    return (dataclasses.replace(jqwen.QwenConfig.tiny(), **kw),
            dataclasses.replace(QwenConfig.tiny(), **kw))


def _hf_leaf(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.t().contiguous() if t.dim() == 2 else t


def test_llama_checkpoint(tmp_path):
    """A Llama-shaped decoder (no qkv bias, an untied `lm_head`, llama3
    rope), written from a JAX init tree under HF names: the port's tree
    equals the JAX mapper's and the init tree itself, in f32 and int8."""
    jcfg, tcfg = _llama_cfgs()
    tree = jax.device_get(jqwen.init_qwen_params(jax.random.key(5), jcfg))
    hf = {"model.embed_tokens.weight": torch.from_numpy(np.array(tree["embed"])),
          "model.norm.weight": _hf_leaf(tree["final_ln"]),
          "lm_head.weight": _hf_leaf(tree["lm_head"])}
    for i, lp in enumerate(tree["layers"]):
        assert "q_b" not in lp
        hf.update({f"model.layers.{i}.{QWEN_LAYER_HF[k]}": _hf_leaf(v) for k, v in lp.items()})
    save_file(hf, str(tmp_path / "model.safetensors"))
    jraw = jweights.load_safetensors_dict(str(tmp_path))
    with load_safetensors_dict(str(tmp_path)) as raw:
        t = qwen_params_from_hf(raw, tcfg, dtype=torch.float32)
        tq = qwen_params_from_hf(raw, tcfg, dtype=torch.bfloat16, quantize=True)
    assert t.lm_head.shape == (64, 512) and t.layers[0].get("q_b") is None
    assert_trees_bitwise(t, qwen_params_from_jax(tree, tcfg))
    j = jweights.qwen_params_from_hf(jraw, jcfg, jnp.float32)
    assert_trees_bitwise(t, qwen_params_from_jax(jax.device_get(j), tcfg))
    jq = jweights.qwen_params_from_hf(jraw, jcfg, jnp.bfloat16, quantize=True)
    assert_trees_bitwise(tq, qwen_params_from_jax(jax.device_get(jq), tcfg, dtype=torch.bfloat16))
    assert isinstance(tq.lm_head, QuantizedLinear)


def test_roberta_classifier_checkpoint(tmp_path):
    """A RoBERTa-headed classifier from a JAX init tree: the `roberta.`
    prefix, `classifier.dense` (which becomes the pooler) and
    `classifier.out_proj`, no token types (zeros) and no pooler of its own."""
    jcfg, tcfg = jbert.BertConfig.tiny(num_labels=2), BertConfig.tiny(num_labels=2)
    tree = jax.device_get(jbert.init_bert_params(jax.random.key(6), jcfg))
    emb = tree["embeddings"]
    hf = {f"roberta.embeddings.{BERT_EMBED_HF[k]}": torch.from_numpy(np.array(v))
          for k, v in emb.items() if k != "token_type"}
    hf.update({"classifier.dense.weight": _hf_leaf(tree["pooler"]["w"]),
               "classifier.dense.bias": _hf_leaf(tree["pooler"]["b"]),
               "classifier.out_proj.weight": _hf_leaf(tree["classifier"]["w"]),
               "classifier.out_proj.bias": _hf_leaf(tree["classifier"]["b"])})
    for i, lp in enumerate(tree["layers"]):
        hf.update({f"roberta.encoder.layer.{i}.{BERT_LAYER_HF[k]}": _hf_leaf(v)
                   for k, v in lp.items()})
    save_file({k: v.contiguous() for k, v in hf.items()}, str(tmp_path / "model.safetensors"))
    jraw = jweights.load_safetensors_dict(str(tmp_path))
    with load_safetensors_dict(str(tmp_path)) as raw:
        t = bert_params_from_hf(raw, tcfg)
    j = jweights.bert_params_from_hf(jraw, jcfg, jnp.float32)
    assert_trees_bitwise(t, bert_params_from_jax(jax.device_get(j), tcfg))
    assert not t.embeddings.token_type.any()
    np.testing.assert_array_equal(t.pooler.w.numpy(), np.asarray(tree["pooler"]["w"]))
    np.testing.assert_array_equal(t.classifier.w.numpy(), np.asarray(tree["classifier"]["w"]))


def test_mapper_refusals(tmp_path):
    """A missing leaf names itself; a leaf of another shape names itself; a
    classifier config needs a head; the identity pooler when there is none."""
    full = _fixture_tensors("tiny-bert")
    raw = dict(full)
    del raw["encoder.layer.1.output.dense.weight"]
    with pytest.raises(KeyError, match="'encoder.layer.1.output.dense.weight' not found"):
        bert_params_from_hf(raw, BertConfig.tiny())
    with pytest.raises(KeyError, match="no classifier head"):
        bert_params_from_hf(full, BertConfig.tiny(num_labels=2))
    wide = dataclasses.replace(BertConfig.tiny(), intermediate=256)
    with pytest.raises(ValueError, match=r"'layers\.0\.ffn_in_b' has shape \(128,\), "
                                         r"the config wants \(256,\)"):
        bert_params_from_hf(full, wide)
    nopool = {k: v.numpy() for k, v in full.items() if not k.startswith("pooler.")}
    t = bert_params_from_hf(nopool, BertConfig.tiny())  # numpy leaves too
    assert torch.equal(t.pooler.w, torch.eye(64)) and not t.pooler.b.any()


# ---------------------------------------------------------------------------
# The components and both /query paths on the fixtures
# ---------------------------------------------------------------------------

_FIX = dict(
    model_weights_dir=FIXTURE, embedding_model="tiny-bert",
    reranker_model="tiny-rerank", llm_model="tiny-qwen",
    sentiment_model="tiny-sent", toxicity_model="tiny-tox",
    allow_random_weights=False, param_dtype="float32",
    batch_shape_buckets="1,2,4", prefill_buckets="64,128", max_tokens=6,
    truncate_length=128, retrieval_k=4, llm_context_docs=2, llm_doc_chars=60,
    index_dim=64, index_pq_m=16,
)
_QUERIES = ["what does the climate report say?", "finance data summary",
            "a survey of space results", "history notes and facts"]
_DOCS = [{"content": "A climate document. data analysis report."},
         {"content": "A finance document. summary notes review."}]


@pytest.fixture(scope="module")
def parts():
    """The five components loaded from the fixtures, in both packages."""
    js, ts = JSettings(**_FIX), Settings(**_FIX, device_platform="cpu")
    names = ("EmbedderComponent", "RerankerComponent", "LLMComponent",
             "SentimentComponent", "ToxicityComponent")
    out = {}
    for n in names:
        jc, tc = getattr(jcomp, n)(js), getattr(tcomp, n)(ts, CPU)
        jc.load()
        tc.load()
        out[n[: -len("Component")].lower()] = (jc, tc)
    return out


def test_components_load_the_fixtures(parts):
    for name, (jc, tc) in parts.items():
        assert not tc.random_weights and not jc.random_weights
        assert tc.checkpoint_dir == os.path.join(FIXTURE, tc.model_name)
        assert isinstance(tc.tokenizer, HFTokenizer)
    llm = parts["llm"][1]
    assert llm.tokenizer.eos_id == llm.tokenizer.tk.token_to_id("<|im_end|>") != 0
    assert llm.tokenizer.eos_id == parts["llm"][0].tokenizer.eos_id
    assert resolve_model_dir(FIXTURE, "tiny-qwen") == os.path.join(FIXTURE, "tiny-qwen")
    assert resolve_model_dir(FIXTURE, "org/absent") is None and resolve_model_dir("", "x") is None


def test_llm_greedy_tokens_match_jax(parts):
    """Greedy tokens and the answers of generate_batch are the JAX
    package's. The fixture's random decoder answers `<unk>` (decoded: ""),
    so the prompt's next-token logits over the whole vocabulary are held to
    the JAX forward's too (f32)."""
    jc, tc = parts["llm"]
    prompt = tc.build_prompt(_QUERIES[0], _DOCS)
    ids, mask = tc.tokenizer.encode(prompt, 96)
    n = int(mask.sum())
    eos = tc.tokenizer.eos_id
    jlogits = jqwen.qwen_forward(jc.params, jc.cfg, jnp.asarray(ids[:n][None]),
                                 jnp.ones((1, n), jnp.int32))
    cache = KVCache.zeros(tc.cfg.layers, 1, n, tc.cfg.kv_heads, tc.cfg.head_dim,
                          dtype=torch.float32)
    tlogits, _ = qwen_prefill(tc.params, tc.cfg, torch.from_numpy(ids[:n][None]),
                              torch.ones((1, n), dtype=torch.int32), cache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits)[:, -1],
                               rtol=1e-4, atol=1e-4)
    ref = np.asarray(jqwen.greedy_generate(jc.params, jc.cfg, jnp.asarray(ids[:n][None]),
                                           jnp.ones((1, n), jnp.int32), 12, eos_token_id=eos))
    got = greedy_generate(tc.params, tc.cfg, torch.from_numpy(ids[:n][None]),
                          torch.ones((1, n), dtype=torch.int32), 12, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), ref)
    docs = [_DOCS] * 3
    assert tc.generate_batch(_QUERIES[:3], docs) == jc.generate_batch(_QUERIES[:3], docs)


def test_encoders_match_jax(parts):
    (je, te), (jr, tr) = parts["embedder"], parts["reranker"]
    np.testing.assert_allclose(te.encode(_QUERIES), je.encode(_QUERIES), rtol=1e-5, atol=1e-5)
    docs = [{"id": i, "content": d} for i, d in enumerate(
        ["climate data report", "finance notes", "space survey results",
         "cooking method review", "history facts"])]
    tout, jout = tr.rerank(_QUERIES[0], docs, top_n=5), jr.rerank(_QUERIES[0], docs, top_n=5)
    assert [d["id"] for d in tout] == [d["id"] for d in jout]
    np.testing.assert_allclose([d["rerank_score"] for d in tout],
                               [d["rerank_score"] for d in jout], rtol=1e-5, atol=1e-6)
    (js_, ts_), (jt, tt) = parts["sentiment"], parts["toxicity"]
    assert ts_.analyze_batch(_QUERIES) == js_.analyze_batch(_QUERIES)
    assert [f for f, _ in tt.check_batch(_QUERIES)] == [f for f, _ in jt.check_batch(_QUERIES)]


def test_int8_llm_from_checkpoint():
    """LLM_WEIGHT_QUANT=int8 quantizes on load: the tree of
    quantize_qwen_params over the bf16 load; the encoders after load."""
    kw = dict(_FIX, param_dtype="bfloat16", device_platform="cpu")
    q = tcomp.LLMComponent(Settings(**kw, llm_weight_quant="int8"), CPU)
    q.load()
    ref = tcomp.LLMComponent(Settings(**kw), CPU)
    ref.load()
    assert_trees_bitwise(q.params, quantize_qwen_params(ref.params))
    e = tcomp.SentimentComponent(Settings(**kw, encoder_weight_quant="int8"), CPU)
    e.load()
    assert isinstance(e.params.classifier.w, QuantizedLinear) and not e.random_weights


def test_missing_weights_are_refused(tmp_path):
    s = Settings(**dict(_FIX, model_weights_dir=str(tmp_path)), device_platform="cpu")
    with pytest.raises(FileNotFoundError, match="no weights for tiny-qwen"):
        tcomp.LLMComponent(s, CPU).load()
    os.makedirs(tmp_path / "tiny-bert")  # the model's directory, but no files
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        tcomp.EmbedderComponent(s, CPU).load()
    ok = dataclasses.replace(s, allow_random_weights=True)
    c = tcomp.SentimentComponent(ok, CPU)
    c.load()
    assert c.random_weights and c.checkpoint_dir is None


def test_tokenizer_json_without_tokenizers_is_refused(monkeypatch):
    """A tokenizer.json with no `tokenizers` package raises, naming the file
    and the package; it never falls back to the hash tokenizer."""
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    path = os.path.join(FIXTURE, "tiny-qwen", "tokenizer.json")
    with pytest.raises(ImportError, match="tokenizers") as e:
        make_tokenizer("tiny-qwen", FIXTURE, vocab_size=512, pad_id=0, eos_id=2)
    assert path in str(e.value) and "hash tokenizer" in str(e.value)
    with pytest.raises(ImportError, match="tokenizers"):
        tcomp.LLMComponent(Settings(**_FIX, device_platform="cpu"), CPU).load()


def _tool_env(**over):
    env = {k.upper(): str(v) for k, v in _FIX.items()}
    env.update(DEVICE_PLATFORM="cpu", **over)
    return env


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's create_test_docs at tiny size: an embedded int8 flat index
    with doc tokens (the fused path) and an embedded IVF-Flat index (the
    staged path) over the same documents."""
    out = tmp_path_factory.mktemp("corpus")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in _tool_env().items():
            mp.setenv(k, v)
        # the sqlite store, which the JAX package's DocumentStore reads here
        common = ["--num-docs", "96", "--embed", "--backend", "sqlite"]
        create_test_docs.main(["--out-dir", str(out / "flat"), "--kind", "flat",
                               "--dtype", "int8", "--tokens", "--doc-tok-len", "24",
                               *common])
        create_test_docs.main(["--out-dir", str(out / "ivf"), "--kind", "ivf_flat",
                               "--nlist", "4", *common])
    return out


def test_staged_query_matches_jax(corpus, parts):
    """StagedApp (single_node_full over the IVF-Flat artifact, the sqlite
    store) against the JAX orchestrator on the same fixtures and files."""
    env = _tool_env(DOC_STORE_BACKEND="sqlite", INDEX_KIND="ivf_flat", INDEX_NPROBE="2",
                    DOCUMENT_DB_PATH=str(corpus / "ivf" / "documents.db"),
                    INDEX_PATH=str(corpus / "ivf" / "index.npz"))
    app = runtime.StagedApp(load_settings(env))
    try:
        tout = [app.query({"query": q, "request_id": f"r{i}"}) for i, q in enumerate(_QUERIES)]
        health = app.health()[1]
    finally:
        app.close()
    assert health["random_weights"] == []
    assert health["weights"]["llm"] == {
        "random_weights": False, "checkpoint_dir": os.path.join(FIXTURE, "tiny-qwen")}
    js = JSettings(**dict(_FIX, doc_store_backend="sqlite", index_nprobe=2,
                          document_db_path=str(corpus / "ivf" / "documents.db")))
    store = JDocumentStore(js)
    store.load()
    jidx = JBaseIndex.load(str(corpus / "ivf" / "index.npz"))
    jidx.nprobe = 2
    p = {k: v[0] for k, v in parts.items()}
    jex = JRetrievalExecutor(js, index=jidx, embedder=p["embedder"], doc_store=store,
                             reranker=p["reranker"])
    jgen = JGenerationService(js, doc_store=store, llm=p["llm"], reranker=p["reranker"],
                              sentiment=p["sentiment"], toxicity=p["toxicity"])

    async def drive():
        orch = JOrchestrator(js, retrieval_executor=jex, generation_service=jgen)
        await orch.start()
        try:
            return [await orch.process_query(q, f"r{i}") for i, q in enumerate(_QUERIES)]
        finally:
            await orch.stop()

    assert tout == asyncio.run(drive())


def test_fused_query_matches_jax(corpus, parts):
    """FusedApp over the int8 flat artifact and the doc tokens that the
    port's tool wrote with the fixture's BPE tokenizer, against the JAX
    fused executor."""
    flat = corpus / "flat"
    toks = np.load(flat / "doc_tokens.npy")
    jtok = j_make_tokenizer("tiny-qwen", FIXTURE, vocab_size=512, pad_id=0, eos_id=2)
    docs = create_test_docs.synth_doc
    rng = np.random.default_rng(0)
    ref, _ = jtok.encode_batch([docs(i, rng)[2] for i in range(96)], 24)
    np.testing.assert_array_equal(toks, ref)  # the BPE ids, as the JAX script writes them
    env = _tool_env(USE_FUSED_PIPELINE="1", INDEX_DTYPE="int8",
                    INDEX_PATH=str(flat / "index.npz"),
                    DOC_TOKENS_PATH=str(flat / "doc_tokens.npy"))
    app = runtime.FusedApp(runtime.build_executor(load_settings(env)))
    tout = [app.query({"query": q, "request_id": f"r{i}"}) for i, q in enumerate(_QUERIES)]
    health = app.health()[1]
    assert {k: w["random_weights"] for k, w in health["weights"].items()} == {
        "embedder": False, "llm": False, "sentiment": False, "toxicity": False}
    js = JSettings(**dict(_FIX, use_fused_pipeline=True, index_dtype="int8",
                          doc_tokens_path=str(flat / "doc_tokens.npy")))
    p = {k: v[0] for k, v in parts.items()}
    jex = JFusedExecutor(js, mesh_ctx=make_mesh(dp=1, tp=1), embedder=p["embedder"],
                         index=JBaseIndex.load(str(flat / "index.npz")), llm=p["llm"],
                         sentiment=p["sentiment"], toxicity=p["toxicity"])
    jex.load()
    jout = [{"request_id": f"r{i}", **jex.process_batch([{"query": q}])[0]}
            for i, q in enumerate(_QUERIES)]
    assert tout == jout


# ---------------------------------------------------------------------------
# The tools and the import rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf_pq"])
def test_create_test_docs_files_load_in_both(tmp_path, monkeypatch, kind):
    """The tool's files, random vectors from the seed: the JAX package's
    index and sqlite doc store read them; the default native store holds
    the same documents for the port's DocumentStore."""
    for k, v in _tool_env(MODEL_WEIGHTS_DIR="", LLM_MODEL="tiny-llm").items():
        monkeypatch.setenv(k, v)
    args = ["--out-dir", str(tmp_path), "--num-docs", "300", "--dim", "32", "--kind", kind,
            "--nlist", "4", "--pq-m", "8", "--tokens", "--doc-tok-len", "8"]
    assert create_test_docs.main([*args, "--backend", "sqlite"]) == 0
    jidx = JBaseIndex.load(str(tmp_path / "index.npz"))
    tidx = load_index(str(tmp_path / "index.npz"), CPU)
    assert jidx.ntotal == tidx.ntotal == 300 and tidx.kind == kind
    rng = np.random.default_rng(0)
    [create_test_docs.synth_doc(i, rng) for i in range(300)]
    v = rng.standard_normal((300, 32)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if kind == "flat":  # bf16 storage: the seed's vectors
        np.testing.assert_array_equal(
            tidx._db[:300].float().numpy(), torch.from_numpy(v).to(torch.bfloat16).float().numpy())
    store = JDocumentStore(JSettings(doc_store_backend="sqlite",
                                     document_db_path=str(tmp_path / "documents.db")))
    store.load()
    assert store.fetch_documents([7])[0]["title"] == "Cooking document 7"
    assert np.load(tmp_path / "doc_tokens.npy").shape == (300, 8)
    assert np.load(tmp_path / "doc_tokens_mask.npy").dtype == np.uint8
    assert create_test_docs.main(args) == 0  # --backend native, the default
    native = DocumentStore(Settings(doc_store_backend="native",
                                    document_db_path=str(tmp_path / "documents.ragdoc")))
    native.load()
    ids = [7, 0, 299, 300]
    assert native.fetch_documents_batch(ids) == store.fetch_documents_batch(ids)


def test_convert_hf_checkpoint(tmp_path, capsys):
    """A safetensors snapshot is copied with its tokenizer; a `.bin`-only
    one is re-serialized by the port's writer; both validate on the CPU."""
    out = tmp_path / "weights"
    assert convert_hf_checkpoint.main([os.path.join(FIXTURE, "tiny-qwen"), "tiny-qwen",
                                       "--weights-dir", str(out), "--arch", "qwen",
                                       "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "copied 2 files" in text and "logits (1, 512)" in text
    assert sorted(os.listdir(out / "tiny-qwen")) == ["model.safetensors", "tokenizer.json"]
    src = tmp_path / "bin_snapshot"
    os.makedirs(src)
    state = _fixture_tensors("tiny-tox")
    torch.save(state, str(src / "pytorch_model.bin"))
    assert convert_hf_checkpoint.main([str(src), "tiny/tox", "--weights-dir", str(out),
                                       "--arch", "bert", "--device", "cpu"]) == 0
    assert "embedding (1, 64)" in capsys.readouterr().out
    with safe_open(str(out / "tiny__tox" / "model.safetensors"), "pt") as f:
        assert sorted(f.keys()) == sorted(state)
        for k in state:
            assert torch.equal(f.get_tensor(k), state[k])
    os.makedirs(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError, match="no safetensors or .bin"):
        convert_hf_checkpoint.main([str(tmp_path / "nothing"), "x",
                                    "--weights-dir", str(tmp_path / "w2"), "--arch", "bert",
                                    "--device", "cpu"])


def test_port_imports_none_of_the_hf_stack():
    """Every module of the port imports without `safetensors`,
    `transformers` or `ml_dtypes` (nor jax: test_torch_topk.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rag_inference_pipeline_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in ('safetensors', 'transformers', 'ml_dtypes', 'jax')\n"
        "       if k in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run leaves the main thread's event loop policy with its loop
    set to None; a later file on the same xdist worker whose
    asyncio.get_event_loop() expects a loop then raises
    (tests/test_core.py::TestRegistry::test_lifecycle). Hand the next file
    a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
