"""Port parity: the flat int8 scan (kernel K1), its quantizer, the exact
scan and the fused search, against the JAX package on the same inputs.

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
