"""Port parity: the flat scans (kernels K1, K2 and K3), their quantizers,
the exact scan and the fused searches, against the JAX package on the same
inputs.

The JAX side runs as its own tests run it on the CPU (Pallas in
interpret mode); the port runs its plain PyTorch versions on the CPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.ops import topk as jtopk
from rag_inference_pipeline_tpu_torch.ops import topk as ttopk

def _i8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# (B, N, ntotal, D, nbins, chunk): B not a multiple of 32; N not a multiple
# of chunk; ntotal < N; ntotal < nbins (empty bins); D small and 768
K1_CASES = [
    (5, 1000, None, 64, 128, 512),
    (37, 1000, None, 64, 128, 512),
    (5, 1300, 777, 64, 128, 512),
    (37, 700, 90, 64, 128, 512),
    (5, 1100, 1050, 768, 128, 512),
    (37, 600, None, 768, 128, 256),
]


class TestBinmaxInt8gs:
    @pytest.mark.parametrize("b,n,ntotal,d,nbins,chunk", K1_CASES)
    def test_plain_bit_identical_to_pallas(self, b, n, ntotal, d, nbins, chunk):
        rng = np.random.default_rng(b * 7919 + n)
        q, db = _i8(rng, b, d), _i8(rng, n, d)
        # equal rows in one bin exercise the earliest-row tie rule
        db[nbins + 3] = db[3]
        jv, ji = jtopk.binmax_partial_topk_int8gs(
            jnp.asarray(q), jnp.asarray(db), nbins=nbins, chunk=chunk,
            interpret=True, ntotal=ntotal,
        )
        tv, ti = ttopk.binmax_partial_topk_int8gs(
            torch.from_numpy(q), torch.from_numpy(db), nbins=nbins,
            ntotal=ntotal,
        )
        assert tv.dtype == torch.int32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if ntotal is not None and ntotal < nbins:
            assert (ti.numpy()[:, ntotal:] == -1).all()


# (B, N, ntotal, D, nbins, chunk) for K2: integer-valued bf16 inputs are
# exact in f32 (bit-identical); ntotal < N; ntotal < nbins (empty bins)
K2_CASES = [
    (5, 1000, None, 64, 128, 512),
    (13, 1300, 777, 64, 128, 512),
    (8, 700, 90, 64, 128, 256),
    (3, 1100, 1050, 768, 256, 512),
]


class TestBinmaxBf16:
    @pytest.mark.parametrize("b,n,ntotal,d,nbins,chunk", K2_CASES)
    def test_plain_bit_identical_to_pallas_on_integer_inputs(
        self, b, n, ntotal, d, nbins, chunk
    ):
        rng = np.random.default_rng(b * 7919 + n)
        q = rng.integers(-8, 9, (b, d)).astype(np.float32)
        db = rng.integers(-8, 9, (n, d)).astype(np.float32)
        db[nbins + 3] = db[3]  # a tie in bin 3: row 3 must win
        db[2 * nbins + 3] = db[3]
        jv, ji = jtopk.binmax_partial_topk(
            jnp.asarray(q), jnp.asarray(db, jnp.bfloat16), nbins=nbins,
            chunk=chunk, interpret=True, ntotal=ntotal,
        )
        tv, ti = ttopk.binmax_partial_topk(
            torch.from_numpy(q), torch.from_numpy(db).to(torch.bfloat16),
            nbins=nbins, ntotal=ntotal,
        )
        assert tv.dtype == torch.float32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if ntotal is not None and ntotal < nbins:
            assert (ti.numpy()[:, ntotal:] == -1).all()
            assert (tv.numpy()[:, ntotal:] == np.float32(ttopk.NEG_INF)).all()

    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_plain_matches_pallas_on_random_inputs(self, dtype):
        rng = np.random.default_rng(17)
        q = rng.standard_normal((6, 96)).astype(np.float32)
        db = rng.standard_normal((1500, 96)).astype(np.float32)
        jv, ji = jtopk.binmax_partial_topk(
            jnp.asarray(q), jnp.asarray(db, getattr(jnp, dtype)), nbins=128,
            chunk=512, interpret=True, ntotal=1400,
        )
        # row chunks smaller than N exercise the plain version's merge
        tv, ti = ttopk.binmax_partial_topk_plain(
            torch.from_numpy(q),
            torch.from_numpy(db).to(getattr(torch, dtype)),
            nbins=128, ntotal=1400, rows_per_chunk=256,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("ntotal", [None, 1900])
    def test_fused_topk_matches_jax(self, ntotal):
        rng = np.random.default_rng(23)
        db = rng.standard_normal((2048, 64)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        q = rng.standard_normal((7, 64)).astype(np.float32)
        js, ji = jtopk.fused_topk(
            jnp.asarray(q), jnp.asarray(db, jnp.bfloat16), 10, nbins=256,
            chunk=512, interpret=True, ntotal=ntotal,
        )
        ts, ti = ttopk.fused_topk(
            torch.from_numpy(q), torch.from_numpy(db).to(torch.bfloat16), 10,
            nbins=256, ntotal=ntotal,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="nbins"):
            ttopk.fused_topk(torch.from_numpy(q), torch.from_numpy(db), 300, nbins=256)


class TestQuantizeAndExact:
    @pytest.mark.parametrize("n", [1000, 1537])
    def test_quantize_global_int8_identical(self, n):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((n, 48)).astype(np.float32)
        x[17] *= 1e4  # an outlier row must not drag the clipped scale
        jq, js = jtopk.quantize_global_int8(jnp.asarray(x))
        tq, ts = ttopk.quantize_global_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dim() == 0
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)

    @pytest.mark.parametrize("metric", ["ip", "l2"])
    @pytest.mark.parametrize("ntotal", [None, 450])
    def test_exact_topk(self, metric, ntotal):
        rng = np.random.default_rng(11)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        db = rng.standard_normal((500, 32)).astype(np.float32)
        js, ji = jtopk.exact_topk(
            jnp.asarray(q), jnp.asarray(db), 10, chunk=128, metric=metric,
            ntotal=ntotal,
        )
        ts, ti = ttopk.exact_topk(
            torch.from_numpy(q), torch.from_numpy(db), 10, chunk=128,
            metric=metric, ntotal=ntotal,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


class TestFusedInt8gs:
    @pytest.mark.parametrize("rescore_k", [0, 64])
    @pytest.mark.parametrize("ntotal", [None, 1900])
    def test_ids_identical(self, rescore_k, ntotal):
        rng = np.random.default_rng(21)
        n, d = 2048, 64
        db = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((7, d)).astype(np.float32)
        db_i8, scale = jtopk.quantize_global_int8(jnp.asarray(db))
        rescore = jnp.asarray(db, jnp.bfloat16)
        js, ji = jtopk.fused_topk_int8gs(
            jnp.asarray(q), db_i8, scale, 10, nbins=256, chunk=512,
            interpret=True, rescore_db=rescore if rescore_k else None,
            rescore_k=rescore_k, ntotal=ntotal,
        )
        ts, ti = ttopk.fused_topk_int8gs(
            torch.from_numpy(q), torch.from_numpy(np.array(db_i8)),
            torch.tensor(float(scale)), 10, nbins=256,
            rescore_db=(
                torch.from_numpy(db).to(torch.bfloat16) if rescore_k else None
            ),
            rescore_k=rescore_k, ntotal=ntotal,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # int-domain scores x the same f32 scales: identical; the bf16
        # re-score sums in another order: f32 rounding of a <=64-term sum
        np.testing.assert_allclose(
            ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5
        )


class TestQuantizeRowsInt8:
    @pytest.mark.parametrize("n,d", [(300, 48), (1537, 768)])
    def test_identical(self, n, d):
        rng = np.random.default_rng(n + d)
        x = rng.standard_normal((n, d)).astype(np.float32)
        x[5] = 0.0  # maxabs clamps to 1e-9
        x[7] *= 1e4
        x[9, :4] = [0.5, -0.5, 1.5, -2.5]  # ties round half to even
        x[9, 4] = 127.0
        jq, js = jtopk.quantize_rows_int8(jnp.asarray(x))
        tq, ts = ttopk.quantize_rows_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# (B, N, D, nbins, chunk): B not a multiple of 32 (the reference pads to 32),
# N not a multiple of chunk; the last case has N < nbins (empty bins)
K3_CASES = [
    (3, 1300, 64, 128, 512),
    (33, 1300, 64, 128, 512),
    (3, 2500, 768, 512, 1024),
    (33, 2100, 96, 512, 1024),
    (33, 300, 64, 512, 1024),
]


class TestBinmaxInt8:
    @pytest.mark.parametrize("b,n,d,nbins,chunk", K3_CASES)
    def test_plain_bit_identical_to_pallas(self, b, n, d, nbins, chunk):
        rng = np.random.default_rng(b * 7919 + n + d)
        q, db = _i8(rng, b, d), _i8(rng, n, d)
        # f32 scales over many binades, one negative, one zero, one NaN
        scales = np.exp(rng.uniform(-20, 5, n)).astype(np.float32)
        if n > nbins + 3:  # equal rows and scales: row 3 keeps bin 3
            db[nbins + 3], scales[nbins + 3] = db[3], scales[3]
        scales[[11, 12, 13]] = [-0.25, 0.0, np.nan]
        jv, ji = jtopk.binmax_partial_topk_int8(
            jnp.asarray(q), jnp.asarray(db), jnp.asarray(scales), nbins=nbins,
            chunk=chunk, interpret=True,
        )
        # row chunks smaller than N exercise the plain version's merge
        tv, ti = ttopk.binmax_partial_topk_int8_plain(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(scales),
            nbins=nbins, rows_per_chunk=nbins,
        )
        assert tv.dtype == torch.float32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if n < nbins:
            assert (ti.numpy()[:, n:] == -1).all()
            assert (tv.numpy()[:, n:] == np.float32(ttopk.NEG_INF)).all()

    def test_wrapper_on_cpu_runs_the_plain_version(self):
        rng = np.random.default_rng(2)
        q, db = torch.from_numpy(_i8(rng, 4, 32)), torch.from_numpy(_i8(rng, 700, 32))
        scales = torch.from_numpy(rng.uniform(0.1, 2, 700).astype(np.float32))
        before = ttopk.binmax_partial_topk_int8.launches
        out = ttopk.binmax_partial_topk_int8(q, db, scales, nbins=64)
        ref = ttopk.binmax_partial_topk_int8_plain(q, db, scales, nbins=64)
        assert ttopk.binmax_partial_topk_int8.launches == before
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        # the brute-force bin max, earliest row on a tie
        s = (q.double() @ db.double().T).float() * scales
        for j in (0, 17, 63):
            col = s[:, j::64]
            best = col.max(dim=1)
            assert torch.equal(out[0][:, j], best.values)
            assert torch.equal(out[1][:, j], (j + 64 * best.indices).int())
        with pytest.raises(ValueError, match="shapes"):
            ttopk.binmax_partial_topk_int8(q, db, scales[:-1], nbins=64)


class TestFusedInt8:
    @pytest.mark.parametrize("rescore_k", [0, 64])
    @pytest.mark.parametrize("n", [2048, 100])
    def test_matches_jax(self, rescore_k, n):
        rng = np.random.default_rng(31 + n)
        d = 64
        db = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((7, d)).astype(np.float32)
        db_i8, scales = jtopk.quantize_rows_int8(jnp.asarray(db))
        js, ji = jtopk.fused_topk_int8(
            jnp.asarray(q), db_i8, scales, 10, nbins=128, chunk=512,
            interpret=True,
            rescore_db=jnp.asarray(db, jnp.bfloat16) if rescore_k else None,
            rescore_k=rescore_k,
        )
        ts, ti = ttopk.fused_topk_int8(
            torch.from_numpy(q), torch.from_numpy(np.array(db_i8)),
            torch.from_numpy(np.array(scales)), 10, nbins=128, chunk=512,
            rescore_db=(
                torch.from_numpy(db).to(torch.bfloat16) if rescore_k else None
            ),
            rescore_k=rescore_k,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # scan scores x the same f32 query scale: identical; the bf16
        # re-score sums in another order: f32 rounding of a 64-term sum
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)

    def test_empty_bins_keep_the_reference_scores(self):
        """With N < k: no re-score leaves NEG_INF * q_scale and id -1; the
        re-score leaves NEG_INF and id -1, as the reference."""
        rng = np.random.default_rng(5)
        db = rng.standard_normal((6, 32)).astype(np.float32)
        q = rng.standard_normal((2, 32)).astype(np.float32)
        db_i8, scales = jtopk.quantize_rows_int8(jnp.asarray(db))
        for rescore_k in (0, 16):
            kw = dict(nbins=64, chunk=64, rescore_k=rescore_k)
            js, ji = jtopk.fused_topk_int8(
                jnp.asarray(q), db_i8, scales, 8, interpret=True,
                rescore_db=jnp.asarray(db) if rescore_k else None, **kw,
            )
            ts, ti = ttopk.fused_topk_int8(
                torch.from_numpy(q), torch.from_numpy(np.array(db_i8)),
                torch.from_numpy(np.array(scales)), 8,
                rescore_db=torch.from_numpy(db) if rescore_k else None, **kw,
            )
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            assert (ti.numpy()[:, 6:] == -1).all()
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
        with pytest.raises(ValueError, match="multiple of nbins"):
            ttopk.fused_topk_int8(torch.from_numpy(q), torch.from_numpy(np.array(db_i8)),
                                  torch.from_numpy(np.array(scales)), 8, nbins=64, chunk=96)


def _topk_case(name):
    """[rows, n] f32 inputs for `_topk` from a numpy seed, and k."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties":  # few distinct values: long runs of equal scores
        return rng.integers(-3, 4, (6, 97)).astype(np.float32), 40
    if name == "signed_zeros":  # +0.0 and -0.0 compare equal but order apart
        x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), (6, 64))
        x[0, :7] = [-0.0, 0.0, -0.0, 0.0, 1.0, -3e38, -3e38]
        return x, 20
    if name == "nan":  # NaN first, then the rest in order
        x = rng.standard_normal((5, 50)).astype(np.float32)
        x[rng.random(x.shape) < 0.1] = np.nan
        x[:, 7] = x[:, 3]
        return x, 12
    if name == "neg_inf_fill":  # fewer valid entries than k: NEG_INF in flat order
        x = np.full((4, 300), ttopk.NEG_INF, np.float32)
        x[:, rng.integers(0, 300, 15)] = rng.integers(-5, 5, (4, 15))
        return x, 100
    x = rng.integers(-2, 3, (3, 33)).astype(np.float32)  # "k_equals_n"
    x[1] = rng.standard_normal(33)
    return x, 33


@pytest.mark.parametrize("name", ["ties", "signed_zeros", "nan", "neg_inf_fill",
                                  "k_equals_n"])
def test_topk_order_matches_lax_top_k(name):
    """`_topk` returns `lax.top_k`'s indices and values: the lower index
    first on ties, +0.0 before -0.0, NaN first, NEG_INF fill in flat order."""
    import jax

    x, k = _topk_case(name)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = ttopk._topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_port_imports_no_jax():
    """Every module of the port imports without loading jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rag_inference_pipeline_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(k == 'rag_inference_pipeline_tpu' or\n"
        "               k.startswith('rag_inference_pipeline_tpu.')\n"
        "               for k in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
