"""The K1 wrapper (int8 bin-max scan) without the JAX package: its CPU
dispatch and plain version here, and the hand-written CUDA kernel against
that plain version on a card.

This file imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.ops import topk as ttopk


def _i8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


class TestBinmaxInt8gsPlain:
    def test_ntotal_as_tensor_and_row_chunking(self):
        """A 0-d tensor ntotal, and a plain scan whose row chunks are
        smaller than N, give the one-shot answer."""
        rng = np.random.default_rng(3)
        q = torch.from_numpy(_i8(rng, 4, 32))
        db = torch.from_numpy(_i8(rng, 900, 32))
        ref = ttopk.binmax_partial_topk_int8gs_plain(q, db, nbins=64, ntotal=801)
        out = ttopk.binmax_partial_topk_int8gs(
            q, db, nbins=64, ntotal=torch.tensor(801)
        )
        small = ttopk.binmax_partial_topk_int8gs_plain(
            q, db, nbins=64, ntotal=801, rows_per_chunk=128
        )
        for a, b in ((ref, out), (ref, small)):
            torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
            torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)

    def test_brute_force_oracle(self):
        """Bin max and earliest row from a per-row Python loop."""
        rng = np.random.default_rng(5)
        q, db = _i8(rng, 3, 8), _i8(rng, 100, 8)
        db[40] = db[8]  # a tie in bin 8: row 8 must win
        nbins, nt = 16, 90
        vals, idxs = ttopk.binmax_partial_topk_int8gs(
            torch.from_numpy(q), torch.from_numpy(db), nbins=nbins, ntotal=nt
        )
        s = q.astype(np.int64) @ db.astype(np.int64).T
        for b in range(3):
            for j in range(nbins):
                rows = [r for r in range(nt) if r % nbins == j]
                best = max(rows, key=lambda r: (s[b, r], -r))
                assert vals[b, j] == s[b, best] and idxs[b, j] == best

    def test_cpu_wrapper_launches_nothing(self):
        before = ttopk.binmax_partial_topk_int8gs.launches
        rng = np.random.default_rng(4)
        ttopk.binmax_partial_topk_int8gs(
            torch.from_numpy(_i8(rng, 2, 8)), torch.from_numpy(_i8(rng, 64, 8)),
            nbins=16,
        )
        assert ttopk.binmax_partial_topk_int8gs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,ntotal,d,nbins", [
    (8, 1_000_777, 1_000_333, 768, 1024),  # the main path's shape
    (37, 5000, 4321, 64, 128),
    (5, 3000, 90, 768, 128),  # ntotal < nbins: empty bins
    (9, 4096, None, 12, 1024),  # D % 16 != 0, one step per bin
])
def test_k1_kernel_matches_plain_on_card(b, n, ntotal, d, nbins):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(b + n)
    q = torch.randint(-127, 128, (b, d), generator=g, device="cuda",
                      dtype=torch.int8)
    db = torch.randint(-127, 128, (n, d), generator=g, device="cuda",
                       dtype=torch.int8)
    db[nbins + 5] = db[5]  # a tie: the earlier row keeps the bin
    before = ttopk.binmax_partial_topk_int8gs.launches
    kv, ki = ttopk.binmax_partial_topk_int8gs(q, db, nbins=nbins, ntotal=ntotal)
    pv, pi = ttopk.binmax_partial_topk_int8gs_plain(q, db, nbins=nbins, ntotal=ntotal)
    torch.cuda.synchronize()
    assert ttopk.binmax_partial_topk_int8gs.launches == before + 1
    assert torch.equal(kv, pv)
    assert torch.equal(ki, pi)


@pytest.mark.cuda
def test_k1_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros((2, 6), dtype=torch.int8, device="cuda")
    db = torch.zeros((10, 6), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="% 4"):
        ttopk.binmax_partial_topk_int8gs(q, db, nbins=4)
    with pytest.raises(ValueError):
        ttopk.binmax_partial_topk_int8gs(q.cpu()[:, :4], db[:, :4], nbins=4)
