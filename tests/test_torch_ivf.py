"""Port parity for IVF-Flat: k-means, the list layout, the three searches
(the exact gather path, the batch-deduplicated scan K5 and the streaming
scan K4), `dedup_probes` and the `.npz` artifacts, against the JAX
package on the same inputs.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode); the port runs its plain PyTorch versions on the CPU. Integer-valued
inputs (entries in [-8, 8], D <= 768) make every product and partial sum
exact in float32, so those cases are bit-identical; random unit vectors
sum in another order and hold scores to rtol=1e-5, atol=1e-5 with equal
ids.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
from rag_inference_pipeline_tpu.ops import ivf as jivf
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
from rag_inference_pipeline_tpu_torch.ops import ivf as tivf
from rag_inference_pipeline_tpu_torch.ops import kmeans as tkmeans
from rag_inference_pipeline_tpu_torch.ops.topk import NEG_INF

# the JAX package's ops/__init__.py exports a function named `kmeans`
jkmeans = importlib.import_module("rag_inference_pipeline_tpu.ops.kmeans")
CPU = torch.device("cpu")


def _int_vectors(rng, *shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


def _unit_vectors(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _skewed_assignments(rng, n, nlist):
    """Lists 0 and 1 take more rows than the 128-row minimum cap (overflow
    cascades), lists 2 and 3 take none, the rest are ragged."""
    a = rng.integers(4, nlist, n)
    a[:150] = 0
    a[150:290] = 1
    return a.astype(np.int32)


def _listings(x, centroids, assignments, cap_factor=1.0):
    """The same layout in both packages (the JAX builder's arrays carried
    across), so the searches are compared on identical buckets."""
    j = jivf.build_ivf_listing(x, centroids, assignments, cap_factor=cap_factor)
    t = tivf.IVFListing(
        centroids=torch.from_numpy(np.array(j.centroids)),
        buckets=torch.from_numpy(
            np.array(j.buckets.astype(jnp.float32))).to(torch.bfloat16),
        ids=torch.from_numpy(np.array(j.ids)),
        list_sizes=torch.from_numpy(np.array(j.list_sizes)),
    )
    return j, t


def _case(kind, seed, n=600, d=64, nlist=24):
    rng = np.random.default_rng(seed)
    gen = _int_vectors if kind == "int" else _unit_vectors
    x = gen(rng, n, d)
    centroids = gen(rng, nlist, d)
    # lists 2 and 3: centroids too far to be any row's nearest (they stay
    # empty through the overflow cascade), but on the top of many coarse
    # probes (+-30 per entry stays integer-valued)
    far = np.full(d, 30.0, np.float32) if kind == "int" else 5.0 * centroids[2]
    centroids[2], centroids[3] = far, -far
    return rng, x, centroids, _skewed_assignments(rng, n, nlist)


def _assert_same(t_out, j_out, exact):
    ts, ti = t_out
    js, ji = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti.numpy(), ji)
    if exact:
        np.testing.assert_array_equal(ts.numpy(), js)
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)


class TestLayout:
    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_layout_and_listing_identical(self, kind):
        """Ragged lists, empty lists and the overflow cascade: the same ids,
        sizes and bf16 buckets as the reference."""
        _, x, c, a = _case(kind, 3)
        jids, jsizes = jivf.layout_inverted_lists(x, c, a, cap_factor=1.0)
        tids, tsizes = tivf.layout_inverted_lists(x, c, a, cap_factor=1.0)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tsizes, jsizes)
        assert (jsizes[2:4] == 0).all() and jsizes.max() == jids.shape[1]
        assert sorted(jids[jids >= 0].tolist()) == list(range(len(x)))
        j = jivf.build_ivf_listing(x, c, a, cap_factor=1.0)
        t = tivf.build_ivf_listing(
            torch.from_numpy(x), c, a, cap_factor=1.0, rows_per_block=64
        )
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.list_sizes.numpy(), np.asarray(j.list_sizes))
        np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))
        assert t.buckets.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.buckets.float().numpy(), np.asarray(j.buckets.astype(jnp.float32))
        )


class TestKMeans:
    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_assign_and_lloyd_step_match_jax(self, kind):
        rng = np.random.default_rng(7)
        gen = _int_vectors if kind == "int" else _unit_vectors
        x, c = gen(rng, 700, 32), gen(rng, 20, 32)
        ja = np.asarray(jkmeans.assign_clusters(jnp.asarray(x), jnp.asarray(c), chunk=256))
        ta = tkmeans.assign_clusters(torch.from_numpy(x), torch.from_numpy(c), chunk=256)
        np.testing.assert_array_equal(ta.numpy(), ja)
        x_pad = np.pad(x, ((0, 68), (0, 0)))  # 768 rows: three 256-row chunks
        jc, jn = jkmeans._lloyd_step(
            jnp.asarray(x_pad), 700, jnp.asarray(c), chunk=256
        )
        tc, tn = tkmeans._lloyd_step(
            torch.from_numpy(x_pad), 700, torch.from_numpy(c), chunk=256
        )
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert tn.sum().item() == 700
        if kind == "int":  # integer sums are exact: same bits after the divide
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        else:
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)

    def test_kmeans_properties(self):
        """Counts sum to n; no cluster is empty on separable data; the same
        seed gives the same centroids."""
        rng = np.random.default_rng(11)
        centers = 10 * rng.standard_normal((8, 16)).astype(np.float32)
        x = centers[np.repeat(np.arange(8), 50)] + 0.1 * rng.standard_normal(
            (400, 16)).astype(np.float32)
        xt = torch.from_numpy(x)
        runs = [
            tkmeans.kmeans(xt, 8, iters=10, chunk=256,
                           generator=torch.Generator().manual_seed(5))
            for _ in range(2)
        ]
        (c, counts), (c2, counts2) = runs
        assert counts.sum().item() == 400
        assert (counts > 0).all()
        assert torch.equal(c, c2) and torch.equal(counts, counts2)
        with pytest.raises(ValueError, match="at least k"):
            tkmeans.kmeans(xt[:5], 8)


class TestDedupProbes:
    def test_slot_order_matches_jax(self):
        """Probed lists first in ascending id, then unprobed ones ascending;
        membership per query."""
        rng = np.random.default_rng(2)
        probe = rng.integers(0, 40, (5, 6)).astype(np.int32)
        probe[1] = probe[0]  # repeated probes across queries
        for n_slots in (12, 30, 40):
            js, jm = jivf.dedup_probes(jnp.asarray(probe), 40, n_slots)
            ts, tm = tivf.dedup_probes(torch.from_numpy(probe), 40, n_slots)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert ts.dtype == torch.int32


SEARCH_CASES = [  # (kind, B, nprobe, k): B not a multiple of 8; few candidates
    ("int", 5, 4, 10),
    ("int", 13, 7, 10),
    ("int", 3, 1, 300),  # fewer valid candidates than k
    ("unit", 5, 4, 10),
    ("unit", 11, 6, 16),
]


class TestSearches:
    @pytest.mark.parametrize("kind,b,nprobe,k", SEARCH_CASES)
    def test_dedup_k5_plain_matches_pallas(self, kind, b, nprobe, k):
        rng, x, c, a = _case(kind, b * 31 + nprobe)
        jl, tl = _listings(x, c, a)
        q = (_int_vectors if kind == "int" else _unit_vectors)(rng, b, x.shape[1])
        j_out = jivf.ivf_search_dedup(jl, jnp.asarray(q), k, nprobe=nprobe,
                                      interpret=True)
        t_out = tivf.ivf_search_dedup(tl, torch.from_numpy(q), k, nprobe=nprobe)
        _assert_same(t_out, j_out, kind == "int")
        if k > 128:
            # fewer valid candidates than k: NEG_INF entries carry the ids
            # the reference gives, real ids of unprobed rows among them
            filler = t_out[0].numpy() == np.float32(NEG_INF)
            assert filler.any() and (t_out[1].numpy()[filler] >= 0).any()

    @pytest.mark.parametrize("kind,b,nprobe,k", SEARCH_CASES)
    def test_scan_k4_plain_matches_pallas(self, kind, b, nprobe, k):
        rng, x, c, a = _case(kind, b * 37 + nprobe)
        jl, tl = _listings(x, c, a)
        q = (_int_vectors if kind == "int" else _unit_vectors)(rng, b, x.shape[1])
        j_out = jivf.ivf_search_pallas(jl, jnp.asarray(q), k, nprobe=nprobe,
                                       interpret=True)
        t_out = tivf.ivf_search_scan(tl, torch.from_numpy(q), k, nprobe=nprobe)
        _assert_same(t_out, j_out, kind == "int")

    @pytest.mark.parametrize("metric", ["ip", "l2"])
    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_exact_gather_path_matches_jax(self, metric, kind):
        rng, x, c, a = _case(kind, 5)
        jl, tl = _listings(x, c, a)
        q = (_int_vectors if kind == "int" else _unit_vectors)(rng, 9, x.shape[1])
        j_out = jivf.ivf_search(jl, jnp.asarray(q), 10, nprobe=5, metric=metric)
        t_out = tivf.ivf_search(tl, torch.from_numpy(q), 10, nprobe=5,
                                metric=metric, query_chunk=4)
        _assert_same(t_out, j_out, kind == "int")

    def test_k4_k5_partials_against_numpy(self):
        """The raw partial outputs: K5 scores with zeros past each list's
        size, K4's positional max with the earliest winning probe slot."""
        rng, x, c, a = _case("int", 9)
        _, tl = _listings(x, c, a)
        q = _int_vectors(rng, 3, x.shape[1])
        qt = torch.from_numpy(q).to(torch.bfloat16)
        slots = torch.tensor([0, 2, 5, 1], dtype=torch.int32)
        sc = tivf.ivf_dedup_scores(qt, tl.buckets, slots, tl.list_sizes).numpy()
        bk = tl.buckets.float().numpy()
        sizes = tl.list_sizes.numpy()
        for si, cl in enumerate(slots.tolist()):
            ref = np.einsum("cd,bd->bc", bk[cl], q)
            ref[:, sizes[cl]:] = 0.0
            np.testing.assert_array_equal(sc[si], ref)
        probe = torch.tensor([[1, 2, 0], [3, 3, 5], [2, 3, 4]], dtype=torch.int32)
        vals, win = tivf.ivf_scan_partial(qt, tl.buckets, probe, tl.list_sizes)
        for b in range(3):
            s = np.stack([np.einsum("cd,d->c", bk[p], q[b]) for p in probe[b].tolist()])
            for pi, p in enumerate(probe[b].tolist()):
                s[pi, sizes[p]:] = np.float32(NEG_INF)
            best = s.max(axis=0)
            np.testing.assert_array_equal(vals[b].numpy(), best)
            first = np.argmax(s == best[None], axis=0)
            np.testing.assert_array_equal(
                win[b].numpy(), np.where(best > np.float32(NEG_INF), first, -1)
            )
        assert (win[1].numpy() >= -1).all() and (win[1].numpy() != 1).all()


class TestK5Tiling:
    """The host side of K5's bf16 grid: the query z-tiles and the count of
    (slot, position tile) blocks that read bucket rows."""

    @pytest.mark.parametrize("b", [1, 8, 13, 32, 33, 40, 41, 64, 80, 81, 200])
    def test_query_tiles_cover_the_batch(self, b):
        z, per = tivf.dedup_query_tiles(b)
        assert 1 <= per <= tivf.K5_MAX_Q and z * per >= b
        assert (z - 1) * per < b  # no z-tile is empty
        assert z == -(-b // tivf.K5_MAX_Q)  # each bucket read once per 40 queries
        assert (b <= tivf.K5_MAX_Q) == (z == 1)

    @pytest.mark.parametrize("cap", [128, 640, 200])
    def test_filled_tiles_against_numpy(self, cap):
        rng = np.random.default_rng(cap)
        nlist = 50
        sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
        sizes[:4] = [0, cap, cap - 1, tivf.K5_ROWS]
        slots = rng.permutation(nlist)[:30].astype(np.int32)
        slots[:4] = [0, 1, 2, 3]
        want = sum(
            1
            for s in slots
            for t in range(-(-cap // tivf.K5_ROWS))
            if t * tivf.K5_ROWS < sizes[s]
        )
        got = tivf.dedup_filled_tiles(torch.from_numpy(slots), torch.from_numpy(sizes), cap)
        assert got == want


class TestIVFFlatIndex:
    def test_npz_round_trips_both_ways(self, tmp_path):
        """A JAX-built index loads in the port and searches to the same ids
        and scores; the port's own save loads back into the JAX index."""
        rng = np.random.default_rng(0)
        x = _unit_vectors(rng, 900, 32)
        q = _unit_vectors(rng, 6, 32)
        jidx = JIVFFlatIndex(32, 16, nprobe=4)
        jidx.train_add(x, iters=5)
        path = str(tmp_path / "j.npz")
        jidx.save(path)
        tidx = load_index(path, CPU)
        assert isinstance(tidx, IVFFlatIndex)
        assert (tidx.ntotal, tidx.nlist, tidx.nprobe) == (900, 16, 4)
        assert tidx.imbalance == pytest.approx(jidx.imbalance)
        _assert_same(tidx.search(q, 10), jidx.search(q, 10), False)
        path2 = str(tmp_path / "t.npz")
        tidx.save(path2)
        back = JIVFFlatIndex._load(path2)
        for name in ("centroids", "ids", "list_sizes"):
            np.testing.assert_array_equal(
                np.asarray(getattr(back._listing, name)),
                np.asarray(getattr(jidx._listing, name)),
            )
        _assert_same(tidx.search(q, 10), back.search(q, 10), False)

    def test_train_add_and_routing_on_cpu(self):
        """The port's own build: every row indexed once; the CPU takes the
        exact gather path (as the reference does there), and with every
        list probed the search is the exact top-k."""
        rng = np.random.default_rng(1)
        x = _unit_vectors(rng, 800, 24)
        idx = IVFFlatIndex(24, 8, nprobe=8, device=CPU)
        idx.train_add(x, iters=4, seed=3)
        ids = idx._listing.ids.numpy()
        assert sorted(ids[ids >= 0].tolist()) == list(range(800))
        assert idx.imbalance >= 1.0
        q = _unit_vectors(rng, 4, 24)
        s, i = idx.search(q, 5)
        qb, xb = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (q, x))
        ref = np.argsort(-(qb @ xb.T), axis=1, kind="stable")[:, :5]
        np.testing.assert_array_equal(i.numpy(), ref)
        assert IVFFlatIndex._DEDUP_BYTES_BUDGET == 1 << 30
        with pytest.raises(ValueError, match="dim"):
            idx.search(q[:, :5], 5)
