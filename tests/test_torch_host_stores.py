"""The port's native host layer on the CPU: `utils/cpuscan.py`'s scans and
re-scores against their numpy versions, the flat index's host f16 rescore
store against the JAX package's, the `.npz` artifacts both ways, the
IVF-PQ host tiers through the native re-score, and the per-process build.

The JAX package's native wrappers run `make -C native` in place, which
races under xdist: every JAX host store here runs with
`rag_inference_pipeline_tpu.utils.cpuscan.load_lib` patched to raise
OSError, so the reference takes its numpy route and builds nothing.

Conventions compared, each side against its own: the native re-score
scores a masked slot (id -1) -3.0e38, the numpy route -inf (f16) or
NEG_INF (int8); valid scores agree within TOL (f32 sums in another order);
ids agree as sets, or as lists but for near-ties within TOL.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_inference_pipeline_tpu.utils.cpuscan as j_cpuscan
from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
from rag_inference_pipeline_tpu.ops.topk import fused_topk_int8gs as j_fused_topk_int8gs
from rag_inference_pipeline_tpu_torch.core.config import load_settings
from rag_inference_pipeline_tpu_torch.index import make_index
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.index.ivf_pq import IVFPQIndex
from rag_inference_pipeline_tpu_torch.ops.topk import fused_topk_int8gs
from rag_inference_pipeline_tpu_torch.telemetry.metrics import render_metrics
from rag_inference_pipeline_tpu_torch.utils import cpuscan, native

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
MASKED = np.float32(-3.0e38)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def ref_numpy_route(monkeypatch):
    """The JAX package's host stores on their numpy route, with no build."""
    def refuse():
        raise OSError("the JAX package's native build is not run by port tests")

    monkeypatch.setattr(j_cpuscan, "load_lib", refuse)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_topk(ns, ni, ps, pi, masked_plain):
    """Native (ns, ni) against plain (ps, pi) of the same re-score: valid
    scores within TOL, masked slots each side's fill, the ids of each row
    as a multiset, and equal lists but where neighbours tie within TOL."""
    valid = ni >= 0
    np.testing.assert_array_equal(valid, pi >= 0)
    np.testing.assert_allclose(ns[valid], ps[valid], **TOL)
    assert (ns[~valid] == MASKED).all()
    assert (ps[~valid] == masked_plain).all()
    for b in range(ni.shape[0]):
        assert sorted(ni[b][valid[b]]) == sorted(pi[b][valid[b]])
        for j in np.nonzero(ni[b] != pi[b])[0]:
            assert abs(float(ns[b, j]) - float(ps[b, j])) <= 2 * TOL["atol"], (b, j)


# ---------------------------------------------------------------------------
# cpuscan: native against plain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,n", [(32, 80_000), (768, 4_000)])  # both > 4 MB of f16
def test_rescore_f16_matches_plain(d, n):
    """Masked slots, duplicate ids and rows on both sides of every 2 MB
    page boundary of the store."""
    rng = np.random.default_rng(d)
    store = _unit(rng, n, d).astype(np.float16)
    assert store.nbytes > 2 * (1 << 21)
    q = _unit(rng, 6, d)
    ids = rng.integers(0, n, (6, 96)).astype(np.int32)
    page_rows = (1 << 21) // (2 * d)
    ids[0, :8] = [page_rows - 1, page_rows, 2 * page_rows - 1, 2 * page_rows,
                  0, n - 1, page_rows - 1, page_rows]  # duplicates too
    ids[1, ::3] = -1
    ids[2, :] = -1
    ids[3, 10:20] = ids[3, 0]
    for k in (10, 96, 200):
        ns, ni = cpuscan.rescore_f16(q, store, ids, k)
        ps, pi = cpuscan.rescore_f16_plain(q, store, ids, k)
        assert ns.shape == (6, min(k, 96)) and ns.dtype == np.float32 and ni.dtype == np.int32
        _assert_topk(ns, ni, ps, pi, -np.inf)
    assert cpuscan.madvise_hugepage(store) in (True, False)
    assert cpuscan.madvise_hugepage(store[:10]) is False  # under 2 MB


def test_rescore_f16_subnormals():
    """f16 subnormals convert exactly (hardware and portable paths alike)."""
    rng = np.random.default_rng(1)
    d = 48  # 16-lane and 8-lane steps with a scalar tail
    sub = np.float16(2.0 ** -24) * rng.integers(1, 1024, (64, d)).astype(np.float16)
    assert (np.abs(sub) < np.float16(2.0 ** -14)).all() and (sub != 0).all()
    store = np.concatenate([sub, -sub]).astype(np.float16)
    q = rng.uniform(1e3, 2e3, (3, d)).astype(np.float32)
    ids = np.arange(128, dtype=np.int32)[None].repeat(3, 0)
    ns, ni = cpuscan.rescore_f16(q, store, ids, 128)
    exact = store.astype(np.float64)[ni] * q.astype(np.float64)[:, None, :]
    np.testing.assert_allclose(ns, exact.sum(-1), rtol=1e-5, atol=0)
    ps, pi = cpuscan.rescore_f16_plain(q, store, ids, 128)
    np.testing.assert_allclose(ns, ps, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [32, 768])
def test_rescore_i8_matches_plain(d):
    rng = np.random.default_rng(d + 1)
    n = 3_000 if d == 768 else 70_000  # both > 2 MB of int8
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = float(1.0 / (127 * np.sqrt(d)))  # a Python float, as the index holds it
    q = _unit(rng, 5, d)
    ids = rng.integers(0, n, (5, 80)).astype(np.int32)
    ids[1, 40:] = -1
    ids[2, :5] = ids[2, 5]
    for k in (8, 80):
        ns, ni = cpuscan.rescore_i8(q, codes, scale, ids, k)
        ps, pi = cpuscan.rescore_i8_plain(q, codes, scale, ids, k)
        _assert_topk(ns, ni, ps, pi, MASKED)


@pytest.mark.parametrize("d", [32, 768])
def test_scans_match_plain(d):
    """scan_f32 within TOL, scan_i8 bit for bit (int32 dots, one f32
    multiply); k past the row count fills (-3.0e38, -1)."""
    rng = np.random.default_rng(d + 2)
    n = 700
    db = _unit(rng, n, d)
    q = _unit(rng, 4, d)
    for k in (10, n + 5):
        ns, ni = cpuscan.scan_f32(q, db, k)
        ps, pi = cpuscan.scan_f32_plain(q, db, k)
        _assert_topk(ns, ni, ps, pi, MASKED)
    db8 = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q8 = rng.integers(-127, 128, (4, d)).astype(np.int8)
    scales = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ns, ni = cpuscan.scan_i8(q8, db8, scales, 25)
    ps, pi = cpuscan.scan_i8_plain(q8, db8, scales, 25)
    np.testing.assert_array_equal(ns, ps)
    for b in range(4):  # equal scores may come in either order
        for s in np.unique(ns[b]):
            if (ns[b] == s).sum() == 1:
                assert ni[b][ns[b] == s] == pi[b][ps[b] == s]


@pytest.mark.parametrize("d", [32, 768])
def test_scan_ivf_matches_plain(d):
    rng = np.random.default_rng(d + 3)
    n, nlist = 2_000, 16
    x = _unit(rng, n, d)
    cents = _unit(rng, nlist, d)
    assign = np.argmax(x @ cents.T, axis=1)
    order = np.argsort(assign, kind="stable")
    codes, ids = x[order], order.astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(assign, minlength=nlist))])
    q = _unit(rng, 6, d)
    for nprobe, k in ((3, 10), (nlist + 4, 20)):
        ns, ni = cpuscan.scan_ivf_f32(q, cents, codes, ids, offsets, nprobe, k)
        ps, pi = cpuscan.scan_ivf_f32_plain(q, cents, codes, ids, offsets, nprobe, k)
        _assert_topk(ns, ni, ps, pi, MASKED)
    full, _ = cpuscan.scan_f32(q, x, 20)  # every list probed: the flat scan
    np.testing.assert_allclose(ns, full, **TOL)


# ---------------------------------------------------------------------------
# The flat index's host rescore store
# ---------------------------------------------------------------------------


def test_k1_shortlist_without_rescore_is_the_references():
    """fused_topk_int8gs with no rescore copy returns K1's top s_k in the
    reference's order (its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(4)
    x = _unit(rng, 5_000, 32)
    tidx = FlatIndex(32, device=CPU)
    tidx.add(x)
    q = _unit(rng, 7, 32)
    s_k = 96
    ts, ti = fused_topk_int8gs(torch.from_numpy(q), tidx._db_i8, tidx._db_gscale, s_k,
                               nbins=tidx.nbins, ntotal=tidx.ntotal)
    js, ji = j_fused_topk_int8gs(
        jnp.asarray(q), jnp.asarray(tidx._db_i8.numpy()),
        jnp.asarray(tidx._db_gscale.numpy()), s_k, nbins=tidx.nbins,
        chunk=tidx._chunk_i8, interpret=True, ntotal=tidx.ntotal, mm_bf16=False,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n,k", [(3_000, 10), (3_000, 40), (40, 50)])
def test_flat_host_store_matches_jax(ref_numpy_route, n, k):
    """The port's FlatIndex(dtype="int8", rescore_store="host") against the
    reference's on the same rows and queries: no bf16 copy anywhere, the
    same f16 host store and codes, scores within TOL, ids equal but for
    near-ties; with k past the rows, the masked slots each side's fill."""
    rng = np.random.default_rng(n + k)
    x = _unit(rng, n, 32)
    q = _unit(rng, 9, 32)
    jidx = JFlatIndex(32, dtype="int8", rescore_store="host")
    tidx = FlatIndex(32, device=CPU, rescore_store="host")
    jidx.add(x)
    tidx.add(x)
    assert tidx._db is None and jidx._db is None
    np.testing.assert_array_equal(tidx._host_rescore, jidx._host_rescore)
    np.testing.assert_array_equal(tidx._db_i8.numpy(), np.asarray(jidx._db_i8))
    ts, ti = (a.numpy() for a in tidx.search(q, k))
    js, ji = (np.asarray(a) for a in jidx.search(q, k))
    _assert_topk(ts, ti, js, ji, -np.inf)
    if n < k:
        assert (ti == -1).any()


def test_flat_host_refine_observes_its_stage():
    rng = np.random.default_rng(5)
    tidx = FlatIndex(32, device=CPU, rescore_store="host")
    tidx.add(_unit(rng, 600, 32))
    tidx.metric_labels = ("host-test", "1")
    tidx.search(_unit(rng, 2, 32), 5)
    tidx.search(_unit(rng, 3, 32), 5)
    line = [ln for ln in render_metrics().decode().splitlines()
            if ln.startswith("pipeline_stage_duration_seconds_count")
            and 'run_id="host-test"' in ln and 'stage="host_refine"' in ln]
    assert len(line) == 1 and float(line[0].split()[-1]) == 2.0, line


def test_flat_host_store_re_add_keeps_the_f16_originals(ref_numpy_route):
    rng = np.random.default_rng(6)
    a, b = _unit(rng, 300, 16), 3 * _unit(rng, 200, 16)
    jidx = JFlatIndex(16, dtype="int8", rescore_store="host")
    tidx = FlatIndex(16, device=CPU, rescore_store="host")
    for v in (a, b):
        jidx.add(v)
        tidx.add(v)
    assert tidx.ntotal == 500
    np.testing.assert_array_equal(tidx._host_rescore, jidx._host_rescore)
    np.testing.assert_array_equal(tidx._db_i8[:500].numpy(), np.asarray(jidx._db_i8[:500]))
    assert tidx._db_gscale.item() == float(jidx._db_gscale)


def test_flat_host_npz_both_ways(ref_numpy_route, tmp_path):
    """The port's host-store artifact loads into the reference as a host
    store and back; the reference's loads into the port; a deployment's
    rescore_store overrides where the copy lands, either way."""
    rng = np.random.default_rng(7)
    x = _unit(rng, 1_200, 32)
    q = _unit(rng, 4, 32)
    tidx = FlatIndex(32, device=CPU, rescore_store="host")
    tidx.add(x)
    tpath = str(tmp_path / "t.npz")
    tidx.save(tpath)
    with np.load(tpath) as z:
        assert bytes(z["rescore_store"]) == b"host" and z["vectors_rescore"].dtype == np.float16
    jback = JFlatIndex._load(tpath)
    assert jback.rescore_store == "host" and jback._db is None
    np.testing.assert_array_equal(jback._host_rescore, tidx._host_rescore)
    np.testing.assert_array_equal(np.asarray(jback._db_i8[:1200]), tidx._db_i8[:1200].numpy())

    jidx = JFlatIndex(32, dtype="int8", rescore_store="host")
    jidx.add(x)
    jpath = str(tmp_path / "j.npz")
    jidx.save(jpath)
    tback = load_index(jpath, CPU)
    assert tback.rescore_store == "host" and tback._db is None
    np.testing.assert_array_equal(tback._host_rescore, jidx._host_rescore)
    np.testing.assert_array_equal(tback.search(q, 10)[1].numpy(), tidx.search(q, 10)[1].numpy())

    dev = load_index(jpath, CPU, rescore_store="device")
    assert dev._host_rescore is None and dev._db.dtype == torch.bfloat16
    jdev = JFlatIndex(32, dtype="int8")
    jdev.add(x)
    dpath = str(tmp_path / "d.npz")
    jdev.save(dpath)
    host = load_index(dpath, CPU, rescore_store="host")
    assert host._db is None and host._host_rescore.dtype == np.float16
    assert load_index(dpath, CPU)._host_rescore is None


def test_make_index_takes_the_host_store():
    s = load_settings({"INDEX_KIND": "flat", "INDEX_DTYPE": "int8", "INDEX_DIM": "32",
                       "INDEX_PQ_M": "16", "INDEX_RESCORE_STORE": "host"})
    idx = make_index(s, CPU)
    assert isinstance(idx, FlatIndex) and idx.rescore_store == "host"
    with pytest.raises(ValueError, match="rescore_store"):
        FlatIndex(32, device=CPU, rescore_store="disk")


def test_failed_native_library_raises_no_fallback(monkeypatch):
    tidx = FlatIndex(16, device=CPU, rescore_store="host")
    tidx.add(_unit(np.random.default_rng(8), 100, 16))

    def broken():
        raise RuntimeError("g++ failed to build native/cpuscan.cc")

    monkeypatch.setattr(cpuscan, "load_lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tidx.search(np.ones((1, 16), np.float32), 5)


# ---------------------------------------------------------------------------
# IVF-PQ host tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["host_int8", "host_f16"])
def test_ivfpq_host_tiers_go_through_native(monkeypatch, tmp_path, kind):
    """The tiers call the native re-score on the ADC shortlist; the plain
    version of that re-score agrees; the store reloads."""
    rng = np.random.default_rng(9)
    x = _unit(rng, 800, 32)
    q = _unit(rng, 5, 32)
    idx = IVFPQIndex(32, 8, 8, nprobe=1, rescore_k=200, ksub=16, rescore_kind=kind,
                     device=CPU)
    idx.train_add(x, kmeans_iters=4, pq_iters=4)
    calls = []
    name = "rescore_f16" if kind == "host_f16" else "rescore_i8"
    real = getattr(cpuscan, name)

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(cpuscan, name, spy)
    ts, ti = (a.numpy() for a in idx.search(q, 30))
    assert len(calls) == 1
    short = calls[0][-2]
    assert (short == -1).any()  # one probe, a shortlist deeper than a list
    if kind == "host_f16":
        ps, pi = cpuscan.rescore_f16_plain(q, idx._host_f16, short, 30)
        _assert_topk(ts, ti, ps, pi, -np.inf)
    else:
        ps, pi = cpuscan.rescore_i8_plain(q, idx._host_codes, idx._host_scale, short, 30)
        _assert_topk(ts, ti, ps, pi, MASKED)
    path = str(tmp_path / "pq.npz")
    idx.save(path)
    back = load_index(path, CPU)
    np.testing.assert_array_equal(back.search(q, 30)[1].numpy(), ti)


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_build_writes_build_native_only():
    """Each library under build/native/, named for this host's compiler
    and CPU, no older than its source."""
    for name in native.LIBS:
        path = native.build(name)
        assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
        assert os.path.getmtime(path) >= os.path.getmtime(
            os.path.join(ROOT, "native", native.LIBS[name][0]))
    assert native.isa()  # the host's -march=native extensions, by name


def test_per_process_build_races_itself(tmp_path):
    """Two processes build the same library into an empty directory at
    once: each compiles into its own name and renames it into place, both
    load a whole library, and no temporary file is left."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from rag_inference_pipeline_tpu_torch.utils import native, fastjson
        native.BUILD_DIR = {str(tmp_path)!r}
        while time.time() < float(sys.argv[1]):
            time.sleep(0.001)
        fastjson.load_lib()
        out = fastjson.parse_retrieve(b'{{"items": [{{"embedding": [1, 2]}}]}}', 2)
        assert out is not None and out.embeddings.tolist() == [[1.0, 2.0]]
        print("ok")
    """)
    start = str(__import__("time").time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", script, start], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    built = os.listdir(tmp_path)
    assert len(built) == 1 and built[0].startswith("libragfastjson.") and built[0].endswith(".so")


def test_failed_build_names_gxx_and_source(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "fastjson.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*fastjson\.cc"):
        native.build("fastjson")
    assert not os.listdir(tmp_path / "out")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build("fastjson")


def test_bench_rescore_host_smoke(tmp_path):
    from rag_inference_pipeline_tpu_torch.tools import bench_rescore_host

    out = bench_rescore_host.main(["--smoke", "--out", str(tmp_path / "r.json")])
    assert [(r["kind"], r["shortlist"]) for r in out["rows"]] == [
        ("f16", 64), ("i8", 64), ("f16", 512), ("i8", 512)]
    assert all(r["agree"] and r["native_ms"] > 0 and r["plain_ms"] > 0 for r in out["rows"])
    assert out["isa"] == native.isa() and (tmp_path / "r.json").exists()


def test_cpuscan_refuses_what_the_native_code_would_read_past():
    rng = np.random.default_rng(10)
    store = _unit(rng, 50, 16).astype(np.float16)
    q = _unit(rng, 2, 16)
    with pytest.raises(ValueError, match="past the store"):
        cpuscan.rescore_f16(q, store, np.array([[0, 50]], np.int32).repeat(2, 0), 2)
    with pytest.raises(ValueError, match="disagree on D"):
        cpuscan.rescore_f16(q[:, :8], store, np.zeros((2, 3), np.int32), 2)
    with pytest.raises(ValueError, match="float16"):
        cpuscan.rescore_f16(q, store.astype(np.float32), np.zeros((2, 3), np.int32), 2)
    with pytest.raises(ValueError, match="int8"):
        cpuscan.rescore_i8(q, store, 1.0, np.zeros((2, 3), np.int32), 2)
    with pytest.raises(ValueError, match="one a row"):
        cpuscan.scan_i8(np.zeros((1, 16), np.int8), np.zeros((5, 16), np.int8),
                        np.ones(4, np.float32), 2)
    with pytest.raises(ValueError, match="offsets"):
        cpuscan.scan_ivf_f32(q, q, store.astype(np.float32), np.arange(50), np.array([0, 40]), 1, 3)


def test_loading_the_libraries_keeps_subnormals():
    """cpuscan is compiled with -ffast-math, but linked without it: loading
    it must not set flush-to-zero or denormals-are-zero for the process
    (g++ links crtfastmath.o into a -ffast-math -shared link, whose
    constructor does), or every float32 on the CPU loses its subnormals."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from rag_inference_pipeline_tpu_torch.utils import cpuscan, docstore, fastjson
        cpuscan.load_lib(); docstore._load_native_lib(); fastjson.load_lib()
        tiny = np.float32(1e-38) / np.float32(100)
        assert tiny != 0 and np.finfo(np.float32).smallest_subnormal > 0, tiny
        import torch
        assert (torch.tensor([1e-38]) / 100).item() != 0
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
