"""Port parity for IVF-PQ: the PQ primitives, codebook and OPQ training,
the IVF-PQ listing, the PQ4 ADC bucket scan K6 and the searches built on
it, the PQ8 gather search, the flat PQ scans, the re-score tiers, the
`IVFPQIndex` artifacts, the settings, profiles and `make_index`, against
the JAX package on the same inputs.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode); the port runs its plain PyTorch versions on the CPU. Integer-valued
inputs (entries in [-8, 8]) make every product and partial sum exact in
float32, so those cases are bit-identical; random unit vectors sum in
another order and hold scores to rtol=1e-5, atol=1e-5 with equal ids.

No test here runs a JAX host-tier search or build (`host_int8`,
`host_f16`): those call `utils/cpuscan.py`, which runs `make -C native`.
The port's host tiers are held to the JAX ADC shortlist and the numpy
formula instead.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.core.profiles import load_role_profile as j_profile
from rag_inference_pipeline_tpu.index import make_index as j_make_index
from rag_inference_pipeline_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.core.profiles import load_role_profile
from rag_inference_pipeline_tpu_torch.index import make_index
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.ivf_pq import IVFPQIndex
from rag_inference_pipeline_tpu_torch.ops import kmeans as tkmeans
from rag_inference_pipeline_tpu_torch.ops import pq as tpq
from rag_inference_pipeline_tpu_torch.ops.topk import NEG_INF

# the JAX package's ops/__init__.py exports functions named `kmeans`, ...
jpq = importlib.import_module("rag_inference_pipeline_tpu.ops.pq")
jkmeans = importlib.import_module("rag_inference_pipeline_tpu.ops.kmeans")
jtopk = importlib.import_module("rag_inference_pipeline_tpu.ops.topk")
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _int_vectors(rng, *shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


def _unit_vectors(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _gen(kind):
    return _int_vectors if kind == "int" else _unit_vectors


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same(t_out, j_out, exact):
    ts, ti = (_np(a) for a in t_out)
    js, ji = (_np(a) for a in j_out)
    np.testing.assert_array_equal(ti, ji)
    if exact:
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts, js, **TOL)


def _codebooks(rng, kind, m, ksub, ds):
    """Integer codebooks carry a duplicated codeword per subspace (a tie:
    the lower code must win)."""
    cb = _gen(kind)(rng, m, ksub, ds)
    cb[:, 5] = cb[:, 2]
    return cb


def _pair_listings(monkeypatch, kind, seed, ksub, n=600, d=32, nlist=24, m=8):
    """The JAX build and the port's listing over the same centroids,
    codebooks and (skewed) assignments: lists 0 and 1 overflow the 128-row
    cap and cascade, lists 2 and 3 are far from every row and stay empty.
    The JAX build's k-means, codebook training and assignment are
    replaced by those inputs for the call."""
    rng = np.random.default_rng(seed)
    gen = _gen(kind)
    x = gen(rng, n, d)
    cent = gen(rng, nlist, d)
    far = np.full(d, 30.0, np.float32) if kind == "int" else 5.0 * cent[2]
    cent[2], cent[3] = far, -far
    a = rng.integers(4, nlist, n).astype(np.int32)
    a[:150], a[150:290] = 0, 1
    cb = _codebooks(rng, kind, m, ksub, d // m)
    monkeypatch.setattr(jpq, "kmeans", lambda *_, **__: (jnp.asarray(cent), None))
    monkeypatch.setattr(jpq, "train_pq", lambda *_, **__: jnp.asarray(cb))
    monkeypatch.setattr(jkmeans, "assign_clusters", lambda *_, **__: jnp.asarray(a))
    jl = jpq.build_ivfpq(jax.random.key(0), x, nlist, m, cap_factor=1.0, ksub=ksub)
    tl = tpq.build_ivfpq_listing(
        torch.from_numpy(x), torch.from_numpy(cent), torch.from_numpy(cb), a,
        cap_factor=1.0, rows_per_block=100,
    )
    return rng, x, jl, tl


def _port_listing(jl):
    """A JAX listing's arrays carried across to the port."""
    return tpq.IVFPQListing(*(torch.from_numpy(np.array(t)) for t in jl))


def _jax_listing(tl):
    return jpq.IVFPQListing(*(jnp.asarray(t.numpy()) for t in tl))


# ---------------------------------------------------------------------------
# PQ primitives
# ---------------------------------------------------------------------------


class TestPrimitives:
    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_encode_decode_lut_adc_match_jax(self, kind):
        """Identical codes (the lower code on a tie), decodes, LUTs and ADC
        sums on the same codebooks, PQ8 and PQ4."""
        rng = np.random.default_rng(1)
        gen = _gen(kind)
        for ksub in (256, 16):
            x = gen(rng, 300, 32)
            cb = _codebooks(rng, kind, 8, ksub, 4)
            x[7] = cb[:, 2].reshape(-1)  # every subspace ties codes 2 and 5
            jc = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb), chunk=128))
            tc = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), chunk=64)
            np.testing.assert_array_equal(tc.numpy(), jc)
            assert tc.dtype == torch.uint8 and (tc[7] == 2).all()
            np.testing.assert_array_equal(
                tpq.pq_decode(tc, torch.from_numpy(cb)).numpy(),
                np.asarray(jpq.pq_decode(jnp.asarray(jc), jnp.asarray(cb))),
            )
            q = gen(rng, 5, 32)
            jlut = np.array(jpq.pq_lut(jnp.asarray(q), jnp.asarray(cb)))
            tlut = tpq.pq_lut(torch.from_numpy(q), torch.from_numpy(cb))
            _close(tlut.numpy(), jlut, kind == "int")
            codes = rng.integers(0, ksub, (4, 7, 8)).astype(np.uint8)
            ja = np.asarray(jpq.adc_lookup_sum(jnp.asarray(jlut), jnp.asarray(codes), ksub))
            ta = tpq.adc_lookup_sum(torch.from_numpy(jlut), torch.from_numpy(codes), ksub)
            assert ta.shape == (5, 4, 7)
            _close(ta.numpy(), ja, kind == "int")

    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_split_and_one_batched_lloyd_step_match_jax(self, kind):
        """The subspace split, and one Lloyd step over all subspaces at once
        against the reference's step on each subspace."""
        rng = np.random.default_rng(2)
        x = _gen(kind)(rng, 700, 32)
        xs = tpq._split_subspaces(torch.from_numpy(x), 8)
        np.testing.assert_array_equal(
            xs.numpy(), np.asarray(jpq._split_subspaces(jnp.asarray(x), 8))
        )
        xs_pad = torch.nn.functional.pad(xs, (0, 0, 0, 68))  # 3 chunks of 256
        c = xs[:, :16].clone()
        tc, tn = tkmeans._lloyd_step(xs_pad, 700, c, chunk=256)
        for i in range(8):
            jc, jn = jkmeans._lloyd_step(
                jnp.asarray(xs_pad[i].numpy()), 700, jnp.asarray(c[i].numpy()), chunk=256
            )
            np.testing.assert_array_equal(tn[i].numpy(), np.asarray(jn))
            _close(tc[i].numpy(), np.asarray(jc), kind == "int", atol=1e-6)

    def test_train_pq_properties(self):
        """Shapes; reconstruction error well below the untrained codebooks
        (the k-means init); the same seed gives the same codebooks."""
        rng = np.random.default_rng(3)
        x = torch.from_numpy(_unit_vectors(rng, 2000, 32))

        def run(iters, seed=5, ksub=16):
            return tpq.train_pq(x, 8, iters=iters, ksub=ksub,
                                generator=torch.Generator().manual_seed(seed))

        def err(cb):
            return (tpq.pq_decode(tpq.pq_encode(x, cb), cb) - x).pow(2).sum(1).mean().item()

        cb = run(10)
        assert cb.shape == (8, 16, 4) and cb.dtype == torch.float32
        assert torch.equal(cb, run(10))
        assert err(cb) < 0.8 * err(run(0))
        assert run(3, ksub=256).shape == (8, 256, 4)

    def test_train_opq_properties(self):
        """R is orthogonal, and the rotated codebooks reconstruct x R better
        than untrained ones."""
        rng = np.random.default_rng(4)
        # correlated coordinates: a rotation helps
        x = _unit_vectors(rng, 1500, 16) @ rng.standard_normal((16, 16)).astype(np.float32)
        xt = torch.from_numpy(x)
        r, cb = tpq.train_opq(xt, 4, iters=3, pq_iters=6, ksub=16,
                              generator=torch.Generator().manual_seed(1))
        assert r.shape == (16, 16) and cb.shape == (4, 16, 4)
        torch.testing.assert_close(r.T @ r, torch.eye(16), rtol=0, atol=1e-4)
        z = xt @ r
        err = (tpq.pq_decode(tpq.pq_encode(z, cb), cb) - z).pow(2).sum(1).mean()
        init = tpq.train_pq(z, 4, iters=0, ksub=16,
                            generator=torch.Generator().manual_seed(1))
        err0 = (tpq.pq_decode(tpq.pq_encode(z, init), init) - z).pow(2).sum(1).mean()
        assert err < 0.8 * err0


def _close(a, b, exact, atol=1e-5):
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# The listing and K6
# ---------------------------------------------------------------------------


class TestListing:
    @pytest.mark.parametrize("kind,ksub", [("int", 16), ("unit", 16), ("int", 256)])
    def test_build_matches_jax(self, monkeypatch, kind, ksub):
        """The same ids, list sizes and code buckets (PQ4 lane-padded to 128
        code columns, zeros past m), centroids and codebooks."""
        _, x, jl, tl = _pair_listings(monkeypatch, kind, 5, ksub)
        for name in jpq.IVFPQListing._fields:
            np.testing.assert_array_equal(
                getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), err_msg=name
            )
        m_store = tl.code_buckets.shape[2]
        assert m_store == (128 if ksub == 16 else 8)
        assert tl.code_buckets.dtype == torch.uint8
        assert not tl.code_buckets[:, :, 8:].any()
        sizes = tl.list_sizes.numpy()
        assert (sizes[2:4] == 0).all() and sizes.max() == tl.ids.shape[1] == 128
        ids = tl.ids.numpy()
        assert sorted(ids[ids >= 0].tolist()) == list(range(len(x)))

    def test_build_ivfpq_trains_and_indexes_every_row(self):
        rng = np.random.default_rng(6)
        x = torch.from_numpy(_unit_vectors(rng, 900, 32))
        lst = tpq.build_ivfpq(x, 8, 8, kmeans_iters=4, pq_iters=4, ksub=16, seed=2)
        ids = lst.ids.numpy()
        assert sorted(ids[ids >= 0].tolist()) == list(range(900))
        assert lst.codebooks.shape == (8, 16, 4) and lst.code_buckets.shape[2] == 128
        assert int(lst.code_buckets.max()) < 16
        again = tpq.build_ivfpq(x, 8, 8, kmeans_iters=4, pq_iters=4, ksub=16, seed=2)
        assert all(torch.equal(a, b) for a, b in zip(lst, again))


def _pallas_adc4(slots, lut, code_buckets, m):
    """The reference's K6 launch (ops/pq.py:530-560), in interpret mode,
    returning the raw [n_slots, b_pad, cap] scores."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n_slots = slots.shape[0]
    b_pad = lut.shape[0]
    _, cap, m_store = code_buckets.shape
    cblk = jpq._adc4_cap_chunk(cap, b_pad)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n_slots, cap // cblk),
        in_specs=[
            pl.BlockSpec((b_pad, m * 16), lambda s, c, slots: (0, 0)),
            pl.BlockSpec((1, cblk, m_store), lambda s, c, slots: (slots[s], c, 0)),
        ],
        out_specs=pl.BlockSpec((1, b_pad, cblk), lambda s, c, slots: (s, 0, c)),
    )
    return pl.pallas_call(
        functools.partial(jpq._adc4_kernel, m=m, cap=cblk),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_slots, b_pad, cap), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary"),
        ),
        interpret=True,
    )(slots, lut, code_buckets)


class TestK6:
    @pytest.mark.parametrize("kind,b_pad,m", [("int", 8, 8), ("int", 16, 24),
                                              ("unit", 8, 8), ("unit", 16, 16)])
    def test_plain_matches_pallas_on_filled_rows(self, monkeypatch, kind, b_pad, m):
        """The plain K6 against the raw Pallas output: filled rows bit for
        bit on integer-valued LUTs, within rtol/atol 1e-5 on the listing's
        own bf16 LUTs; 0 past each list's size (where Pallas scores the
        zero codes)."""
        rng, _, _, tl = _pair_listings(monkeypatch, kind, 7 + m, 16, m=m, d=2 * m * 2)
        if kind == "int":
            lut = torch.from_numpy(_int_vectors(rng, b_pad, m * 16)).to(torch.bfloat16)
        else:
            q = torch.from_numpy(_unit_vectors(rng, b_pad, 4 * m))
            lut = tpq.pq_lut(q, tl.codebooks).to(torch.bfloat16)
        slots = torch.tensor([0, 2, 5, 1, 9, 5, 23], dtype=torch.int32)  # full, empty, repeats
        plain = tpq.ivfpq4_adc_scores(lut, tl.code_buckets, slots, tl.list_sizes)
        pallas = np.asarray(_pallas_adc4(
            jnp.asarray(slots.numpy()),
            jnp.asarray(lut.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(tl.code_buckets.numpy()), m,
        ))
        cap = tl.code_buckets.shape[1]
        filled = np.arange(cap)[None, :] < tl.list_sizes.numpy()[slots.numpy()][:, None]
        assert plain.shape == pallas.shape == (7, b_pad, cap)
        mask = np.broadcast_to(filled[:, None, :], plain.shape)
        _close(plain.numpy()[mask], pallas[mask], kind == "int")
        assert not plain.numpy()[~mask].any()
        assert (pallas[~mask] != 0).any()  # Pallas scores padding rows too

    def test_plain_against_numpy_and_cpu_dispatch(self):
        """The raw scores from a per-row numpy loop; the CPU wrapper
        launches nothing and refuses tensors on two devices."""
        rng = np.random.default_rng(8)
        m, cap = 16, 128
        codes = np.zeros((5, cap, 128), np.uint8)
        codes[:, :, :m] = rng.integers(0, 16, (5, cap, m))
        sizes = np.array([0, 128, 77, 3, 128], np.int32)
        lut = _int_vectors(rng, 8, m * 16)
        slots = np.array([4, 2, 0], np.int32)
        before = tpq.ivfpq4_adc_scores.launches
        out = tpq.ivfpq4_adc_scores(
            torch.from_numpy(lut).to(torch.bfloat16), torch.from_numpy(codes),
            torch.from_numpy(slots), torch.from_numpy(sizes),
        ).numpy()
        assert tpq.ivfpq4_adc_scores.launches == before
        for si, cl in enumerate(slots):
            for r in range(cap):
                ref = sum(lut[:, j * 16 + codes[cl, r, j]] for j in range(m))
                np.testing.assert_array_equal(out[si, :, r], ref if r < sizes[cl] else 0)
        with pytest.raises(ValueError, match="CUDA"):
            tpq.ivfpq4_adc_scores(
                torch.zeros(8, 128, dtype=torch.bfloat16),
                torch.zeros(2, 128, 128, dtype=torch.uint8, device="meta"),
                torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            )


SEARCH_CASES = [  # (kind, B, nprobe, k): B not a multiple of 8; few candidates
    ("int", 5, 4, 10),
    ("int", 13, 7, 10),
    ("int", 3, 1, 300),  # fewer valid candidates than k
    ("unit", 5, 4, 10),
    ("unit", 11, 6, 16),
]


class TestSearches:
    @pytest.mark.parametrize("kind,b,nprobe,k", SEARCH_CASES)
    def test_ivfpq4_search_dedup_matches_jax(self, monkeypatch, kind, b, nprobe, k):
        rng, _, jl, _ = _pair_listings(monkeypatch, kind, b * 31 + nprobe, 16)
        tl = _port_listing(jl)
        q = _gen(kind)(rng, b, 32)
        j_out = jpq.ivfpq4_search_dedup(jl, jnp.asarray(q), k, nprobe=nprobe,
                                        interpret=True)
        t_out = tpq.ivfpq4_search_dedup(tl, torch.from_numpy(q), k, nprobe=nprobe)
        _assert_same(t_out, j_out, kind == "int")
        if k > 128:
            # fewer valid candidates than k: NEG_INF entries carry the ids
            # the reference gives, real ids of unprobed rows among them
            filler = t_out[0].numpy() == np.float32(NEG_INF)
            assert filler.any() and (t_out[1].numpy()[filler] >= 0).any()

    @pytest.mark.parametrize("kind,b,nprobe,k", SEARCH_CASES)
    def test_ivfpq_search_pq8_matches_jax(self, monkeypatch, kind, b, nprobe, k):
        rng, _, jl, _ = _pair_listings(monkeypatch, kind, b * 37 + nprobe, 256)
        tl = _port_listing(jl)
        q = _gen(kind)(rng, b, 32)
        j_out = jpq.ivfpq_search(jl, jnp.asarray(q), k, nprobe=nprobe)
        t_out = tpq.ivfpq_search(tl, torch.from_numpy(q), k, nprobe=nprobe)
        _assert_same(t_out, j_out, kind == "int")

    @pytest.mark.parametrize("ksub", [256, 16])
    @pytest.mark.parametrize("kind", ["int", "unit"])
    def test_flat_pq_scans_match_jax(self, kind, ksub):
        """pq_topk (PQ8) and pq4_topk (PQ4): chunked scans with a ragged
        last chunk and a running merge."""
        rng = np.random.default_rng(9 + ksub)
        codes = rng.integers(0, ksub, (1000, 8)).astype(np.uint8)
        codes[700] = codes[3]  # a tie: the lower row first
        cb = _codebooks(rng, kind, 8, ksub, 4)
        q = _gen(kind)(rng, 6, 32)
        jfn, tfn = (jpq.pq_topk, tpq.pq_topk) if ksub == 256 else (jpq.pq4_topk, tpq.pq4_topk)
        j_out = jfn(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb), 12, chunk=256)
        t_out = tfn(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(cb),
                    12, chunk=256)
        _assert_same(t_out, j_out, kind == "int")


# ---------------------------------------------------------------------------
# IVFPQIndex
# ---------------------------------------------------------------------------


def _corpus(seed, n=900, d=32):
    rng = np.random.default_rng(seed)
    return _unit_vectors(rng, n, d), _unit_vectors(rng, 6, d)


def _jax_index(kind="exact", ksub=16, opq=False, **kw):
    x, q = _corpus(0)
    jidx = JIVFPQIndex(32, 8, 8, nprobe=4, rescore_k=20, ksub=ksub,
                       rescore_kind=kind, opq=opq, **kw)
    jidx.train_add(x, kmeans_iters=5, pq_iters=4)
    return jidx, x, q


class TestIVFPQIndex:
    @pytest.mark.parametrize("ksub", [16, 256])
    def test_npz_round_trips_both_ways(self, tmp_path, ksub):
        """A JAX-built index loads in the port and searches to the same ids
        and scores; the port's own save loads back into the JAX index."""
        jidx, _, q = _jax_index(ksub=ksub)
        path = str(tmp_path / "j.npz")
        jidx.save(path)
        tidx = load_index(path, CPU)
        assert isinstance(tidx, IVFPQIndex)
        assert (tidx.ntotal, tidx.nlist, tidx.m, tidx.ksub, tidx.rescore_k) == (
            900, 8, 8, ksub, 20)
        _assert_same(tidx.search(q, 10), jidx.search(q, 10), False)
        tidx.rescore_k = 0  # the raw ADC route too
        jidx.rescore_k = 0
        _assert_same(tidx.search(q, 10), jidx.search(q, 10), False)
        tidx.rescore_k = jidx.rescore_k = 20
        path2 = str(tmp_path / "t.npz")
        tidx.save(path2)
        back = JIVFPQIndex._load(path2)
        for name in jpq.IVFPQListing._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(back._listing, name)),
                np.asarray(getattr(jidx._listing, name)),
            )
        np.testing.assert_array_equal(
            np.asarray(back._vectors.astype(jnp.float32)),
            np.asarray(jidx._vectors.astype(jnp.float32)),
        )
        _assert_same(tidx.search(q, 10), back.search(q, 10), False)

    @pytest.mark.parametrize("kind,opq", [("int4", False), ("pq8", False), ("exact", True)])
    def test_rescore_tiers_give_jax_ids(self, tmp_path, kind, opq):
        """The int4 and PQ8 tiers and an OPQ rotation, loaded from the JAX
        artifact, re-score to the reference's ids and scores."""
        jidx, _, q = _jax_index(kind, opq=opq)
        path = str(tmp_path / "j.npz")
        jidx.save(path)
        tidx = load_index(path, CPU)
        assert tidx.rescore_kind == kind and tidx.opq == opq
        _assert_same(tidx.search(q, 7), jidx.search(q, 7), False)
        back = str(tmp_path / "t.npz")
        tidx.save(back)
        _assert_same(load_index(back, CPU).search(q, 7), jidx.search(q, 7), False)

    @pytest.mark.parametrize("kind", ["host_int8", "host_f16"])
    def test_host_tiers_match_the_numpy_formula(self, tmp_path, kind):
        """The port's host re-score of the ADC shortlist of JAX's own PQ4
        search over the port's listing: the reference's numpy arithmetic,
        its invalid fill, scores equal and ids wherever scores differ."""
        x, q = _corpus(1)
        # one probe and a shortlist deeper than a list: padding ids (-1)
        # reach the re-score
        tidx = IVFPQIndex(32, 8, 8, nprobe=1, rescore_k=200, ksub=16,
                          rescore_kind=kind, device=CPU)
        tidx.train_add(x, kmeans_iters=4, pq_iters=4)
        _, short = jpq.ivfpq4_search_dedup(
            _jax_listing(tidx._listing), jnp.asarray(q), 200, nprobe=1, interpret=True
        )
        short = np.asarray(short)
        if kind == "host_int8":
            codes, scale = jtopk.quantize_global_int8(jnp.asarray(x))
            store, scale, fill = np.asarray(codes), float(scale), np.float32(NEG_INF)
            np.testing.assert_array_equal(tidx._host_codes, store)
            assert tidx._host_scale == scale
        else:
            store, scale, fill = x.astype(np.float16), 1.0, -np.inf
        s = np.einsum("bsd,bd->bs", store[np.clip(short, 0, None)].astype(np.float32), q)
        s = np.where(short >= 0, s * scale if scale != 1.0 else s, fill)
        order = np.argsort(-s, axis=1, kind="stable")[:, :30]
        ref_s = np.take_along_axis(s, order, axis=1)
        ref_i = np.take_along_axis(short, order, axis=1)
        for idx in (tidx, _reload(tidx, tmp_path)):
            ts, ti = (a.numpy() for a in idx.search(q, 30))
            np.testing.assert_array_equal(ts, ref_s)
            for b in range(len(q)):
                once = np.array([(ts[b] == v).sum() == 1 for v in ts[b]])
                np.testing.assert_array_equal(ti[b][once], ref_i[b][once])
        assert (short == -1).any()

    def test_port_train_add_search_and_unload(self):
        """The port's own build: exact re-score against the bf16 rows finds
        every probed query's source row; unload empties the index."""
        x, _ = _corpus(2)
        idx = IVFPQIndex(32, 8, 8, nprobe=8, rescore_k=50, ksub=16, device=CPU)
        idx.train_add(x, kmeans_iters=4, pq_iters=6)
        s, i = idx.search(x[:20], 5)
        assert (i[:, 0].numpy() == np.arange(20)).all()
        assert s.dtype == torch.float32 and i.dtype == torch.int32
        idx.unload()
        assert not idx.is_loaded and idx.ntotal == 0
        with pytest.raises(RuntimeError, match="not loaded"):
            idx.search(x[:1], 5)
        with pytest.raises(ValueError, match="divisible"):
            IVFPQIndex(30, 8, 8)
        with pytest.raises(ValueError, match="rescore_kind"):
            IVFPQIndex(32, 8, 8, rescore_kind="fp4")


def _reload(idx, tmp_path):
    path = str(tmp_path / "reload.npz")
    idx.save(path)
    return load_index(path, CPU)


# ---------------------------------------------------------------------------
# Settings, profiles, make_index
# ---------------------------------------------------------------------------


def test_pq_settings_match_jax():
    ref, port = JSettings(), Settings()
    for f in ("index_pq_m", "index_pq_bits", "index_pq_rescore_k", "index_pq_rescore_kind"):
        assert getattr(port, f) == getattr(ref, f), f
    for bad in (dict(index_dim=100), dict(index_pq_bits=6),
                dict(index_pq_rescore_kind="fp4"), dict(index_cap_factor=0.5),
                dict(index_rescore_store="disk")):
        with pytest.raises(ValueError):
            JSettings(**bad)
        with pytest.raises(ValueError):
            Settings(**bad)


@pytest.mark.parametrize("name", ["retrieval_ivfpq", "retrieval_pq4", "retrieval_pq_host_refine"])
def test_pq_profiles_match_the_jax_loader(name):
    jp = j_profile(JSettings(pipeline_role_profile=name))
    tp = load_role_profile(Settings(pipeline_role_profile=name))
    assert tp.name == jp.name
    assert list(tp.routes) == list(jp.routes)
    assert [(c.type.value, c.alias, c.config) for c in tp.components] == [
        (c.type.value, c.alias, c.config) for c in jp.components
    ]


@pytest.mark.parametrize("bits,kind", [(4, "exact"), (8, "exact"), (4, "host_int8"),
                                       (4, "host_f16"), (8, "int4"), (8, "pq8")])
def test_make_index_matches_jax(bits, kind):
    env = dict(index_kind="ivf_pq", index_pq_bits=bits, index_pq_m=192 if bits == 4 else 96,
               index_pq_rescore_kind=kind, index_nprobe=32, index_cap_factor=1.5)
    j = j_make_index(JSettings(**env))
    t = make_index(load_settings({k.upper(): str(v) for k, v in env.items()}), CPU)
    assert isinstance(t, IVFPQIndex) and not t.is_loaded
    for a in ("dim", "nlist", "m", "nprobe", "rescore_k", "ksub", "rescore_kind",
              "cap_factor", "rescore_pq_m", "opq", "kind"):
        assert getattr(t, a) == getattr(j, a), a
