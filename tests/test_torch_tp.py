"""Tensor parallelism in the port on the CPU, against the JAX package.

The reference runs on the 8 fake CPU devices of `tests/conftest.py`; the
port's tp positions repeat the CPU (`core/mesh.py::force_host_devices`).
Weights are drawn by the reference and carried across with
`models/weights.py`'s converter; inputs come from numpy with a seed. Held
here:

- the placements: for every leaf, the split `qwen_param_sharding` and
  `bert_param_sharding` name is the reference's `NamedSharding` spec
  (bf16 and W8A8 trees, tied and untied heads);
- `qwen_forward` at tp = 2 against the JAX tp = 2 forward (f32, atol 2e-4,
  the reference's own bound), and the encoders at tp = 2;
- greedy tokens of the tiny llama (untied head, llama3 rope) at dp = 4, tp
  = 2: identical to the JAX sharded run and to the port's tp = 1;
- W8A8 at tp = 2: the row-parallel products bit for bit the unsplit ones,
  the tokens identical to tp = 1 and to the JAX sharded run;
- the fused step at dp = 2, tp = 2 against the JAX step on the same mesh;
- the refusals: a tp that splits a head, tp > kv_heads.

Speculation, the decode engine, the components and the server at tp = 2
are in tests/test_torch_tp_serving.py.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rag_inference_pipeline_tpu.core import make_mesh as j_make_mesh
from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu.parallel import sharding as jsharding
from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.models import bert as tbert
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.layers import (
    MeshTree,
    QuantizedLinear,
    TPTree,
    dense,
    row_dense,
)
from rag_inference_pipeline_tpu_torch.models.weights import (
    bert_params_from_jax,
    qwen_params_from_jax,
)
from rag_inference_pipeline_tpu_torch.parallel import sharding as tsharding

TP_SPEC = {tsharding.COL: P(None, "tp"), tsharding.ROW: P("tp", None),
           tsharding.VEC_TP: P("tp"), tsharding.REPL: P()}


def _tmesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=force_host_devices(dp * tp))


def _llama_cfgs(tie: bool):
    """The tiny llama of tests/test_llama_family.py (no qkv bias, llama3
    rope), on both sides."""
    kw = dict(vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, head_dim=16,
              intermediate=128, rope_theta=10000.0, eps=1e-5, qkv_bias=False,
              tie_embeddings=tie, max_len=256, rope_scaling=(4.0, 1.0, 2.0, 16))
    return jqwen.QwenConfig(**kw), tqwen.QwenConfig(**kw)


def _qwen_pair(jcfg, tcfg, seed, quantize=False):
    jp = jax.jit(partial(jqwen.init_qwen_params, cfg=jcfg))(jax.random.key(seed))
    if quantize:
        jp = jqwen.quantize_qwen_params(jp)
    return jp, qwen_params_from_jax(jax.device_get(jp), tcfg)


def _bert_pair(seed, quantize=False):
    jcfg, tcfg = jbert.BertConfig.tiny(num_labels=3), tbert.BertConfig.tiny(num_labels=3)
    jp = jax.jit(partial(jbert.init_bert_params, cfg=jcfg))(jax.random.key(seed))
    if quantize:
        jp = jbert.quantize_bert_params(jp)
    return jcfg, jp, tcfg, bert_params_from_jax(jax.device_get(jp), tcfg)


def _jshard(jmesh, params, spec_fn):
    return jsharding.shard_params(jmesh, params, spec_fn(jmesh, params))


def _ids(rng, b, t, vocab, lengths=None):
    ids = rng.integers(1, vocab, (b, t)).astype(np.int32)
    lengths = lengths if lengths is not None else [t] * b
    mask = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def _same_specs(jspec, tspec, path=""):
    """Walk the reference's NamedSharding tree beside the port's names."""
    if isinstance(jspec, dict):
        assert set(jspec) == set(tspec), path
        for k in jspec:
            _same_specs(jspec[k], tspec[k], f"{path}.{k}")
    elif isinstance(jspec, list):
        assert len(jspec) == len(tspec), path
        for i, (a, b) in enumerate(zip(jspec, tspec)):
            _same_specs(a, b, f"{path}.{i}")
    elif isinstance(jspec, (jlayers.QuantizedLinear, jlayers.QuantizedEmbed)):
        assert isinstance(tspec, tsharding.QSpec), path
        assert jspec.q.spec == TP_SPEC[tspec.q], f"{path}.q"
        assert jspec.s.spec == TP_SPEC[tspec.s], f"{path}.s"
    else:
        assert isinstance(tspec, str), path
        assert jspec.spec == TP_SPEC[tspec], f"{path}: {jspec.spec} vs {tspec}"


@pytest.mark.parametrize("model", ["qwen_tied", "llama_untied", "bert"])
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "w8a8"])
def test_placements_match_the_reference(model, quantize):
    jm, tm = j_make_mesh(dp=1, tp=2), _tmesh(1, 2)
    if model == "bert":
        jcfg, jp, tcfg, tp = _bert_pair(0, quantize)
        jspec = jsharding.bert_param_sharding(jm, jp)
        tspec = tsharding.bert_param_sharding(tm, tp, tcfg)
    else:
        jcfg, tcfg = ((jqwen.QwenConfig.tiny(), tqwen.QwenConfig.tiny()) if model == "qwen_tied"
                      else _llama_cfgs(False))
        jp, tp = _qwen_pair(jcfg, tcfg, 0, quantize)
        jspec = jsharding.qwen_param_sharding(jm, jp)
        tspec = tsharding.qwen_param_sharding(tm, tp, tcfg)
        assert ("lm_head" in tspec) == (model == "llama_untied")
    _same_specs(jspec, tspec)
    assert tsharding.kv_cache_sharding(tm) == tuple(
        jsharding.kv_cache_sharding(jm).spec)
    assert tsharding.batch_sharding(tm) == tm.rows_dp


def test_shards_are_contiguous_slices_and_whole_leaves_shared():
    """Each split leaf is a contiguous 1/tp copy; a whole leaf is one
    tensor on a repeated device; the shards hold what the tree holds."""
    tcfg = tqwen.QwenConfig.tiny()
    tp = tqwen.init_qwen_params(tcfg, generator=torch.Generator().manual_seed(0))
    (tree,) = tsharding.place_params(_tmesh(1, 2), tp, tcfg)
    assert isinstance(tree, TPTree) and tree.tp == 2
    a, b = tree.shards
    assert a.embed.data_ptr() == b.embed.data_ptr() == tp.embed.data_ptr()
    lp = tp.layers[0]
    assert torch.equal(torch.cat([a.layers[0].q_w, b.layers[0].q_w], 1), lp.q_w)
    assert torch.equal(torch.cat([a.layers[0].down_w, b.layers[0].down_w], 0), lp.down_w)
    assert torch.equal(torch.cat([a.layers[0].q_b, b.layers[0].q_b]), lp.q_b)
    assert all(t.is_contiguous() for t in a.state_dict().values())
    split = sum(t.numel() for k, t in a.state_dict().items()
                if k.startswith("layers") and not k.endswith("_ln"))
    whole = sum(t.numel() for k, t in tp.state_dict().items()
                if k.startswith("layers") and not k.endswith("_ln"))
    assert 2 * split == whole


# ---------------------------------------------------------------------------
# The decoder at tp = 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_qwen_forward_tp2_matches_jax_sharded(tie):
    """The reference's own tp test (tests/test_device_pipeline.py:49-67)
    with the port beside it."""
    jcfg, tcfg = ((jqwen.QwenConfig.tiny(), tqwen.QwenConfig.tiny()) if tie
                  else _llama_cfgs(False))
    jp, tp = _qwen_pair(jcfg, tcfg, 1)
    rng = np.random.default_rng(5)
    ids, mask = _ids(rng, 4, 8, 400, [8, 5, 8, 3])
    jm = j_make_mesh(dp=1, tp=2)
    ref = np.asarray(jqwen.qwen_forward(_jshard(jm, jp, jsharding.qwen_param_sharding),
                                        jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    (tree,) = tsharding.place_params(_tmesh(1, 2), tp, tcfg)
    out = tqwen.qwen_forward(tree, tcfg, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    solo = tqwen.qwen_forward(tp, tcfg, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(out, solo, atol=2e-5, rtol=0)


def test_llama_greedy_dp4_tp2_matches_jax_and_tp1():
    """Greedy tokens of the tiny llama on a dp = 4 x tp = 2 mesh: the port's
    batch split over dp (a `MeshTree` of tp groups) and its tp = 2 group
    alone, against the reference's sharded run and the port's tp = 1."""
    jcfg, tcfg = _llama_cfgs(False)
    jp, tp = _qwen_pair(jcfg, tcfg, 13)
    rng = np.random.default_rng(17)
    ids, mask = _ids(rng, 4, 8, 512, [8, 6, 8, 4])
    jm = j_make_mesh(dp=4, tp=2)
    ref = np.asarray(jqwen.greedy_generate(_jshard(jm, jp, jsharding.qwen_param_sharding),
                                           jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                           max_new_tokens=6, cache_len=16))
    tm = _tmesh(4, 2)
    groups = tsharding.place_params(tm, tp, tcfg)
    assert all(g is groups[0] or g.shards == groups[0].shards for g in groups)
    kw = dict(cache_len=16)
    solo = tqwen.greedy_generate(tp, tcfg, _t(ids), _t(mask), 6, **kw).numpy()
    grp = tqwen.greedy_generate(groups[0], tcfg, _t(ids), _t(mask), 6, **kw).numpy()
    over = tqwen.greedy_generate(MeshTree(groups), tcfg, _t(ids), _t(mask), 6, **kw).numpy()
    np.testing.assert_array_equal(solo, ref)
    np.testing.assert_array_equal(grp, ref)
    np.testing.assert_array_equal(over, ref)


def test_w8a8_row_parallel_bit_identical_and_tokens():
    """The s32 row-parallel product (the whole row quantized once, exact
    int32 partials summed, the epilogue after) is the unsplit W8A8 dense
    bit for bit, in f32 and bf16; so the W8A8 tokens at tp = 2 equal tp =
    1's and the reference's sharded run."""
    tcfg = tqwen.QwenConfig.tiny()
    jcfg = jqwen.QwenConfig.tiny()
    jp, tp = _qwen_pair(jcfg, tcfg, 3, quantize=True)
    (tree,) = tsharding.place_params(_tmesh(1, 2), tp, tcfg)
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for key, k in (("o_w", tcfg.heads * tcfg.head_dim), ("down_w", tcfg.intermediate)):
            w = getattr(tp.layers[1], key)
            assert isinstance(w, QuantizedLinear)
            x = (torch.randn(6, k, generator=g) * 3).to(dtype)
            half = k // 2
            shards = [getattr(sh.layers[1], key) for sh in tree.shards]
            got = row_dense([x[:, :half], x[:, half:]], shards)
            assert torch.equal(got, dense(x, w)), (key, dtype)
    rng = np.random.default_rng(8)
    ids, mask = _ids(rng, 3, 10, 400, [10, 7, 4])
    solo = tqwen.greedy_generate(tp, tcfg, _t(ids), _t(mask), 8, cache_len=20).numpy()
    got = tqwen.greedy_generate(tree, tcfg, _t(ids), _t(mask), 8, cache_len=20).numpy()
    np.testing.assert_array_equal(got, solo)
    jm = j_make_mesh(dp=1, tp=2)
    ref = np.asarray(jqwen.greedy_generate(_jshard(jm, jp, jsharding.qwen_param_sharding),
                                           jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                           max_new_tokens=8, cache_len=20))
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The encoders at tp = 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "w8a8"])
def test_bert_tp2_matches_jax_sharded_and_tp1(quantize):
    jcfg, jp, tcfg, tp = _bert_pair(2, quantize)
    rng = np.random.default_rng(11)
    ids, mask = _ids(rng, 4, 16, 1000, [16, 9, 16, 2])
    (tree,) = tsharding.place_params(_tmesh(1, 2), tp, tcfg)
    jm = j_make_mesh(dp=1, tp=2)
    js = _jshard(jm, jp, jsharding.bert_param_sharding)
    ref_e = np.asarray(jbert.bert_embed(js, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    ref_c = np.asarray(jbert.bert_classify(js, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    emb = tbert.bert_embed(tree, tcfg, _t(ids), _t(mask)).numpy()
    cls = tbert.bert_classify(tree, tcfg, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(emb, ref_e, atol=2e-4, rtol=0)
    np.testing.assert_allclose(cls, ref_c, atol=2e-4, rtol=0)
    solo = tbert.bert_embed(tp, tcfg, _t(ids), _t(mask)).numpy()
    if quantize:  # the row-parallel products are exact
        np.testing.assert_array_equal(emb, solo)
    else:
        np.testing.assert_allclose(emb, solo, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# The fused step on a dp x tp mesh
# ---------------------------------------------------------------------------


def test_fused_step_dp2_tp2_matches_jax():
    """The fused step on a dp = 2 x tp = 2 mesh against the JAX pipeline on
    the same mesh: ids equal; tokens equal where the top ctx_docs ids agree
    (as tests/test_device_pipeline.py:88-111)."""
    from rag_inference_pipeline_tpu.engine.device_pipeline import DeviceRAGPipeline as JPipe
    from rag_inference_pipeline_tpu_torch.engine.device_pipeline import DeviceRAGPipeline

    bcfg, qcfg = jbert.BertConfig.tiny(), jqwen.QwenConfig.tiny()
    tbcfg, tqcfg = tbert.BertConfig.tiny(), tqwen.QwenConfig.tiny()
    jb = jax.jit(partial(jbert.init_bert_params, cfg=bcfg))(jax.random.key(1))
    jq = jax.jit(partial(jqwen.init_qwen_params, cfg=qcfg))(jax.random.key(2))
    tb = bert_params_from_jax(jax.device_get(jb), tbcfg)
    tq = qwen_params_from_jax(jax.device_get(jq), tqcfg)
    rng = np.random.default_rng(3)
    n, doc_len = 256, 8
    db = rng.standard_normal((n, bcfg.hidden)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    toks = rng.integers(1, 400, (n, doc_len)).astype(np.int32)
    kw = dict(k=5, ctx_docs=2, max_new_tokens=4, rescore_k=32)
    jpipe = JPipe(mesh=j_make_mesh(dp=2, tp=2), bert_cfg=bcfg, qwen_cfg=qcfg,
                  index_dtype="int8", doc_tok_len=doc_len, **kw)
    tm = _tmesh(2, 2)
    tpipe = DeviceRAGPipeline(device=tm.front, bert_cfg=tbcfg, qwen_cfg=tqcfg, mesh=tm, **kw)
    jpipe.build(jb, jq, db, toks)
    tpipe.build(tb, tq, db, toks)
    assert all(isinstance(p, TPTree) for p in tpipe.qwen_params + tpipe.bert_params)
    q = rng.integers(1, 400, (8, 10)).astype(np.int32)
    qm = np.ones_like(q)
    jout, tout = jpipe.step(q, qm), tpipe.step(q, qm)
    ids = tout.doc_ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jout.doc_ids))
    agree = (ids[:, :2] == np.asarray(jout.doc_ids)[:, :2]).all(axis=1)
    assert agree.all()
    np.testing.assert_array_equal(tout.tokens.numpy()[agree], np.asarray(jout.tokens)[agree])


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["kv_heads", "heads", "intermediate", "vocab"])
def test_tp_that_splits_a_head_is_refused(case):
    """A tp that does not divide a head count (tp > kv_heads among them),
    the MLP width or an untied head's vocabulary raises, naming it."""
    tcfg = tqwen.QwenConfig.tiny()  # heads 4, kv_heads 2, intermediate 128
    tp = 4
    if case == "heads":
        tcfg = dataclasses.replace(tcfg, heads=6, kv_heads=2)
        tp = 4
    elif case == "intermediate":
        tcfg = dataclasses.replace(tcfg, kv_heads=4, intermediate=130)
        tp = 4
    elif case == "vocab":
        tcfg = dataclasses.replace(tcfg, kv_heads=4, tie_embeddings=False, vocab_size=510)
        tp = 4
    params = tqwen.init_qwen_params(tcfg, generator=None, device="meta")
    with pytest.raises(ValueError, match=f"does not divide {case}"):
        tsharding.place_params(_tmesh(1, tp), params, tcfg)
    if case == "kv_heads":
        with pytest.raises(ValueError, match="GQA: tp <= kv_heads"):
            tsharding.check_tp(tcfg, 4)
        bcfg = tbert.BertConfig.tiny()  # heads 4
        with pytest.raises(ValueError, match="does not divide heads"):
            tsharding.check_tp(bcfg, 3)


def test_mesh_tp_from_settings_and_graph_rule():
    """MESH_TP reaches the mesh (a tp of 2 over the CPU's one device asks
    for two devices, where it was refused outright before), and a decode
    loop replays graphs only when every shard lies on one card."""
    from rag_inference_pipeline_tpu_torch.core.mesh import mesh_from_settings
    from rag_inference_pipeline_tpu_torch.models import decode_graph

    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_from_settings(Settings(device_platform="cpu", mesh_tp=2))
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert decode_graph.uses_graphs(c0) and decode_graph.uses_graphs((c0, c0))
    assert not decode_graph.uses_graphs((c0, c1))
    assert not decode_graph.uses_graphs(torch.device("cpu"))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "w8a8"])
def test_one_shard_is_the_unsplit_product(quantize):
    """An unsplit tree is one shard: `row_dense` over it is `dense` bit for
    bit, and `shards_of` gives the tree and its device."""
    from rag_inference_pipeline_tpu_torch.models.layers import quantize_linear, shards_of

    g = torch.Generator().manual_seed(5)
    w = torch.randn(96, 32, generator=g) * 0.02
    w = quantize_linear(w) if quantize else w.to(torch.bfloat16)
    x = torch.randn(3, 5, 96, generator=g).to(torch.bfloat16)
    b = torch.randn(32, generator=g).to(torch.bfloat16)
    assert torch.equal(row_dense([x], [w], b), dense(x, w, b))
    tcfg = tqwen.QwenConfig.tiny()
    tree = tqwen.init_qwen_params(tcfg, generator=g)
    shards, devs = shards_of(tree)
    assert shards == [tree] and devs == (torch.device("cpu"),)


def test_gqa_attention_is_the_repeated_heads_and_splits_by_kv_head():
    """The decoder's attention runs each kv head's query group as its own
    products: the reference's repeated-heads einsum to f32 rounding, and a
    tp shard's heads (half the query and kv heads) give those heads of the
    whole call bit for bit, with and without a mask."""
    from rag_inference_pipeline_tpu_torch.models.layers import attention

    g = torch.Generator().manual_seed(9)
    b, t, s, hq, hkv, dh = 2, 3, 11, 14, 2, 16
    q = torch.randn(b, t, hq, dh, generator=g)
    k, v = (torch.randn(b, s, hkv, dh, generator=g) for _ in range(2))
    mask = (torch.arange(s)[None, None, None, :] <= torch.tensor([4, 9])[:, None, None, None])
    for m in (None, mask):
        got = attention(q, k, v, m)
        kr, vr = (x.repeat_interleave(hq // hkv, dim=2) for x in (k, v))
        scores = torch.einsum("bthd,bshd->bhts", q, kr) / dh ** 0.5
        if m is not None:
            scores = scores.masked_fill(~m, -1e30)
        want = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), vr)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
        half = torch.cat([attention(q[:, :, j * 7:(j + 1) * 7], k[:, :, j:j + 1],
                                    v[:, :, j:j + 1], m) for j in range(2)], dim=2)
        assert torch.equal(got, half)


def test_over_dp_runs_each_positions_rows_in_order():
    """`over_dp` is the one dp batch split (the decoder's `MeshTree` and the
    fused step): position i gets rows [i*B/dp, (i+1)*B/dp) of every tensor
    and its own item, and the results join in position order."""
    from rag_inference_pipeline_tpu_torch.models.layers import over_dp

    x = torch.arange(12).reshape(6, 2)
    y = torch.arange(6) * 10
    devs = force_host_devices(3)
    out = over_dp(devs, lambda item, xi, yi: xi.sum(1) * item + yi, [1, 2, 3], x, y)
    assert out.tolist() == [1, 15, 38, 56, 91, 113]
