"""Port parity for data parallelism, part one: the mesh and the dp-sharded
flat, IVF and IVF-PQ searches, against the JAX package on the same inputs
(`test_torch_sharded.py` holds the token gather, the fused step and the
indexes).

The JAX side runs on the 8-device fake CPU mesh of `tests/conftest.py`,
Pallas in interpret mode, as its own tests run it; the port runs on a mesh
of dp positions on the one CPU (`force_host_devices`), its kernels' plain
versions. Integer-valued inputs (entries in [-8, 8], exact in bf16 and in
every f32 sum) are held bit for bit, ties included; unit vectors sum in
another order, so their scores are held to rtol=1e-5, atol=1e-5 with ids
identical.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core import make_mesh as j_make_mesh
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.core.mesh import (
    force_host_devices,
    make_mesh,
    mesh_from_settings,
)
from rag_inference_pipeline_tpu_torch.ops import ivf as tivf
from rag_inference_pipeline_tpu_torch.ops import pq as tpq
from rag_inference_pipeline_tpu_torch.ops import topk as ttopk
from rag_inference_pipeline_tpu_torch.ops.topk import NEG_INF

jtopk = importlib.import_module("rag_inference_pipeline_tpu.ops.topk")
jivf = importlib.import_module("rag_inference_pipeline_tpu.ops.ivf")
jpq = importlib.import_module("rag_inference_pipeline_tpu.ops.pq")
TOL = dict(rtol=1e-5, atol=1e-5)


def _meshes(dp):
    return j_make_mesh(dp=dp, tp=1), make_mesh(dp=dp, devices=force_host_devices(dp))


def _int_vectors(rng, *shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


def _unit_vectors(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _gen(kind):
    return _int_vectors if kind == "int" else _unit_vectors


def _same(t_out, j_out, exact):
    ts, ti = (a.numpy() for a in t_out)
    js, ji = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti, ji)
    if exact:
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts, js, **TOL)


def _pad_rows(x, mult):
    n = x.shape[0]
    return np.concatenate([x, np.zeros((-n % mult, *x.shape[1:]), x.dtype)])


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class TestMesh:
    def test_shape_and_placement(self):
        mesh = make_mesh(dp=4, devices=force_host_devices(4))
        assert (mesh.dp, mesh.tp, mesh.n_devices) == (4, 1, 4)
        assert mesh.distinct == (torch.device("cpu"),)
        x = torch.arange(24).reshape(8, 3)
        rows = mesh.put(x, mesh.rows_dp)
        assert [r.tolist() for r in rows] == [x[2 * i : 2 * i + 2].tolist() for i in range(4)]
        # one repeated device: the row blocks are views, nothing is copied
        assert all(r.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
                   for r in rows)
        rep = mesh.put(np.ones(3, np.float32))
        assert len(rep) == 4 and all(r is rep[0] for r in rep)  # one copy a device
        assert mesh.gather_rows(rows, 5).tolist() == x[:5].tolist()
        with pytest.raises(ValueError, match="do not split"):
            mesh.put(torch.zeros(6, 2), mesh.rows_dp)
        assert make_mesh(devices=force_host_devices(3)).dp == 3  # dp = 0 infers

    @pytest.mark.parametrize("case", ["too_few", "tp", "settings_dp"])
    def test_refusals(self, case):
        if case == "too_few":
            with pytest.raises(ValueError, match="needs 4 devices, have 2"):
                make_mesh(dp=4, devices=force_host_devices(2))
        elif case == "tp":
            # tp > 1 is served; a dp x tp grid larger than the devices is not
            mesh = make_mesh(dp=2, tp=2, devices=force_host_devices(4))
            assert (mesh.dp, mesh.tp) == (2, 2) and len(mesh.group(1)) == 2
            with pytest.raises(ValueError, match="needs 4 devices, have 3"):
                make_mesh(dp=2, tp=2, devices=force_host_devices(3))
        else:
            # MESH_DP above the visible devices raises: never a quiet shrink
            s = Settings(device_platform="cpu", mesh_dp=2)
            with pytest.raises(ValueError, match="needs 2 devices, have 1"):
                mesh_from_settings(s)
            assert mesh_from_settings(Settings(device_platform="cpu")).dp == 1

    def test_settings_match_jax(self):
        from rag_inference_pipeline_tpu.core.config import Settings as JSettings

        env = {"MESH_DP": "4", "MESH_TP": "1", "DIST_NUM_PROCESSES": "2",
               "DIST_PROCESS_ID": "1", "DIST_COORDINATOR": "10.0.0.1:9000",
               "INDEX_NPROBE_LOCAL": "12", "INDEX_SHARD_AXIS": "dp"}
        t = load_settings(env)
        j = JSettings(**{k.lower(): v for k, v in env.items()})
        for name in ("mesh_dp", "mesh_tp", "dist_num_processes", "dist_process_id",
                     "dist_coordinator", "index_nprobe_local"):
            assert getattr(t, name) == getattr(j, name), name
        d = Settings()
        jd = JSettings()
        for name in ("mesh_dp", "mesh_tp", "dist_num_processes", "dist_process_id",
                     "dist_coordinator", "index_nprobe_local"):
            assert getattr(d, name) == getattr(jd, name), name


# ---------------------------------------------------------------------------
# Sharded flat scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["int", "unit"])
def test_sharded_topk_matches_jax(dp, fused, kind):
    """The exact and the fused (K2) sharded scans: 999 rows pad to a dp
    multiple; ids identical, ties (integer rows) included."""
    rng = np.random.default_rng(dp * 10 + fused)
    n, d, b, k = 999, 32, 5, 7
    db = _pad_rows(_gen(kind)(rng, n, d), dp)
    if kind == "int":
        db[50:60] = db[700]  # tied rows across shards: the lower shard wins
    q = _gen(kind)(rng, b, d)
    q[0] = db[700]
    jm, tm = _meshes(dp)
    j_out = jtopk.sharded_topk(jm, jnp.asarray(q), jm.put(jnp.asarray(db), jm.rows_dp),
                               k, use_fused=fused, nbins=128, chunk=128, ntotal=n,
                               interpret=True)
    t_out = ttopk.sharded_topk(tm, torch.from_numpy(q), tm.put(db, tm.rows_dp), k,
                               use_fused=fused, nbins=128, ntotal=n)
    _same(t_out, j_out, kind == "int")


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("n", [999, 601])
@pytest.mark.parametrize("rescore", [False, True])
def test_sharded_topk_int8gs_matches_jax(dp, n, rescore):
    """K1 once a shard with each shard's own row count (601 rows at dp = 4
    leave the last shard no row), the corpus's global scale and the
    per-shard bf16 re-score; all scores negative on one query, so a pad
    row would win a bin if it entered one."""
    rng = np.random.default_rng(n + dp + rescore)
    d, b, k, nbins, chunk = 32, 6, 5, 128, 256
    x = _unit_vectors(rng, n, d)
    q = _unit_vectors(rng, b, d)
    x -= ((x @ q[1]) + 0.3)[:, None] * q[1]  # query 1 scores -0.3 everywhere
    x_i8, gscale = jtopk.quantize_global_int8(jnp.asarray(x))
    codes = _pad_rows(np.asarray(x_i8), chunk * dp)
    rows = _pad_rows(x, chunk * dp)
    jm, tm = _meshes(dp)
    jr = jm.put(jnp.asarray(rows, jnp.bfloat16), jm.rows_dp) if rescore else None
    j_out = jtopk.sharded_topk_int8gs(
        jm, jnp.asarray(q), jm.put(jnp.asarray(codes), jm.rows_dp), gscale, k,
        rescore_db_sharded=jr, rescore_k=64 if rescore else 0, nbins=nbins,
        chunk=chunk, ntotal=n, interpret=True,
    )
    tr = tm.put(torch.from_numpy(rows).to(torch.bfloat16), tm.rows_dp) if rescore else None
    t_out = ttopk.sharded_topk_int8gs(
        tm, torch.from_numpy(q), tm.put(codes, tm.rows_dp),
        torch.tensor(float(gscale)), k, rescore_db_shards=tr,
        rescore_k=64 if rescore else 0, nbins=nbins, ntotal=n,
    )
    _same(t_out, j_out, False)
    assert (t_out[1].numpy() < n).all() and (t_out[1].numpy() >= 0).all()
    assert (t_out[0].numpy()[1] < 0).all()


# ---------------------------------------------------------------------------
# Sharded IVF-Flat
# ---------------------------------------------------------------------------


def _ivf_listing(rng, kind, nlist=32, cap=8, d=16, skew_to=None):
    """A hand-made listing: ragged lists (some empty), global ids, bf16
    buckets of integer or unit rows; with `skew_to`, the centroids of
    shard 0's lists lie near that query, so shard 0 owns all its winners."""
    sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
    sizes[3] = 0
    ids = np.full((nlist, cap), -1, np.int32)
    buckets = np.zeros((nlist, cap, d), np.float32)
    nxt = 0
    for lst in range(nlist):
        ids[lst, : sizes[lst]] = np.arange(nxt, nxt + sizes[lst])
        buckets[lst, : sizes[lst]] = _gen(kind)(rng, sizes[lst], d)
        nxt += sizes[lst]
    cent = _gen(kind)(rng, nlist, d)
    if skew_to is not None:
        cent[: nlist // 4] = skew_to + 0.01 * np.arange(nlist // 4)[:, None]
    return cent, buckets, ids, sizes


@pytest.mark.parametrize(
    "dp,case",
    [(1, "plain"), (2, "plain"), (4, "plain"), (4, "skewed"), (2, "narrow"), (4, "l2")],
)
@pytest.mark.parametrize("kind", ["int", "unit"])
def test_sharded_ivf_search_matches_jax(dp, case, kind):
    """Global probe selection, each shard's top nprobe_local lists over the
    threshold, the merge. An IP shard scores its kept lists once a batch
    (K5's plain version through `ivf_search_dedup(coarse_floor=...)`), an
    l2 shard through the plain gather. `skewed`: one shard owns every
    winner of query 0 (more than its nprobe_local slots); `narrow`:
    nprobe_local below the default; dp = 1: the floor on one whole
    listing."""
    rng = np.random.default_rng(dp * 7 + len(case))
    d, b, k, nprobe = 16, 5, 6, 8
    q = _gen(kind)(rng, b, d)
    cent, buckets, ids, sizes = _ivf_listing(
        rng, kind, d=d, skew_to=q[0] if case == "skewed" else None
    )
    metric = "l2" if case == "l2" else "ip"
    nprobe_local = 2 if case == "narrow" else 0
    jm, tm = _meshes(dp)
    jl = jivf.IVFListing(jnp.asarray(cent), jnp.asarray(buckets, jnp.bfloat16),
                         jnp.asarray(ids), jnp.asarray(sizes))
    j_out = jivf.sharded_ivf_search(
        jm, jivf.shard_ivf_listing(jm, jl), jnp.asarray(q), k, nprobe=nprobe,
        nprobe_local=nprobe_local, metric=metric,
    )
    tl = tivf.IVFListing(torch.from_numpy(cent), torch.from_numpy(buckets).to(torch.bfloat16),
                         torch.from_numpy(ids), torch.from_numpy(sizes))
    t_out = tivf.sharded_ivf_search(
        tm, tivf.shard_ivf_listing(tm, tl), torch.from_numpy(q), k, nprobe=nprobe,
        nprobe_local=nprobe_local, metric=metric,
    )
    _same(t_out, j_out, kind == "int")
    if case == "skewed":
        # query 0's winning lists all sit on shard 0, beyond its slots
        ref = tivf.ivf_search(tl, torch.from_numpy(q[:1]), k, nprobe=nprobe)
        assert not np.array_equal(ref[1].numpy(), t_out[1].numpy()[:1])


def test_shard_ivf_listing_refuses_uneven_lists():
    _, tm = _meshes(4)
    rng = np.random.default_rng(0)
    cent, buckets, ids, sizes = _ivf_listing(rng, "int", nlist=30)
    tl = tivf.IVFListing(*(torch.from_numpy(a) for a in (cent, buckets, ids, sizes)))
    with pytest.raises(ValueError, match="divisible by mesh dp"):
        tivf.shard_ivf_listing(tm, tl)


# ---------------------------------------------------------------------------
# Sharded IVF-PQ and coarse_floor
# ---------------------------------------------------------------------------


def _pq_listing(rng, kind, ksub, nlist=24, cap=128, d=32, m=8):
    """A hand-made IVF-PQ listing: ragged lists, random codes (< ksub), PQ4
    code rows lane-padded to 128 columns as the reference stores them."""
    m_store = 128 if ksub == 16 else m
    sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
    sizes[5] = 0
    ids = np.full((nlist, cap), -1, np.int32)
    codes = np.zeros((nlist, cap, m_store), np.uint8)
    nxt = 0
    for lst in range(nlist):
        ids[lst, : sizes[lst]] = np.arange(nxt, nxt + sizes[lst])
        codes[lst, : sizes[lst], :m] = rng.integers(0, ksub, (sizes[lst], m))
        nxt += sizes[lst]
    cent = _gen(kind)(rng, nlist, d)
    books = _gen(kind)(rng, m, ksub, d // m)
    return [cent, books, codes, ids, sizes]


def _j_pq(arrays):
    return jpq.IVFPQListing(*(jnp.asarray(a) for a in arrays))


def _t_pq(arrays):
    return tpq.IVFPQListing(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("ksub", [16, 256])
@pytest.mark.parametrize("kind", ["int", "unit"])
def test_coarse_floor_matches_jax(ksub, kind):
    """`coarse_floor` on both single-device searches: the PQ4 search masks
    membership before its dedup (fewer slots), the PQ8 one gives probes
    under the floor a NEG_INF coarse term. Every valid candidate, its score
    and its place are the reference's."""
    rng = np.random.default_rng(ksub + len(kind))
    arrays = _pq_listing(rng, kind, ksub)
    q = _gen(kind)(rng, 6, 32)
    coarse = q @ arrays[0].T
    top = np.sort(coarse, axis=1)
    floor = (top[:, -4:-3] + top[:, -5:-4]) / 2  # between the 4th and 5th list
    k, nprobe = 10, 8
    if ksub == 16:
        j_out = jpq.ivfpq4_search_dedup(_j_pq(arrays), jnp.asarray(q), k, nprobe=nprobe,
                                        interpret=True, coarse_floor=jnp.asarray(floor))
        t_out = tpq.ivfpq4_search_dedup(_t_pq(arrays), torch.from_numpy(q), k,
                                        nprobe=nprobe, coarse_floor=torch.from_numpy(floor))
    else:
        j_out = jpq.ivfpq_search(_j_pq(arrays), jnp.asarray(q), k, nprobe=nprobe,
                                 coarse_floor=jnp.asarray(floor))
        t_out = tpq.ivfpq_search(_t_pq(arrays), torch.from_numpy(q), k, nprobe=nprobe,
                                 coarse_floor=torch.from_numpy(floor))
    js, ji = (np.asarray(a) for a in j_out)
    ts, ti = (a.numpy() for a in t_out)
    assert ts.shape == js.shape
    valid = js > NEG_INF / 2
    assert valid.sum() > 0
    np.testing.assert_array_equal(ti[valid], ji[valid])
    np.testing.assert_allclose(ts[valid], js[valid], **TOL)
    if ksub == 16:  # the port's fill: NEG_INF and -1 only
        assert (ti[~valid] == -1).all() and (ts[~valid] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("ksub", [16, 256])
@pytest.mark.parametrize("kind", ["int", "unit"])
def test_sharded_ivfpq_search_matches_jax(dp, ksub, kind):
    """K6 (PQ4) or the gather ADC (PQ8) once a shard under the global
    coarse floor; codebooks once per distinct device."""
    rng = np.random.default_rng(dp * 3 + ksub)
    arrays = _pq_listing(rng, kind, ksub)
    q = _gen(kind)(rng, 5, 32)
    k, nprobe = 10, 8
    jm, tm = _meshes(dp)
    j_out = jpq.sharded_ivfpq_search(jm, jpq.shard_ivfpq_listing(jm, _j_pq(arrays)),
                                     jnp.asarray(q), k, nprobe=nprobe, interpret=True)
    shards = tpq.shard_ivfpq_listing(tm, _t_pq(arrays))
    assert all(s.codebooks is shards[0].codebooks for s in shards)
    t_out = tpq.sharded_ivfpq_search(tm, shards, torch.from_numpy(q), k, nprobe=nprobe)
    _same(t_out, j_out, kind == "int")
    assert (t_out[1].numpy() >= 0).all()
