"""The sharded searches on the card: K1, K2, K5 and K6 once a shard at dp = 4
on one card (`force_host_devices(4, "cuda")`), against the same sharded
searches through the kernels' plain versions. Imports no jax; needs a
CUDA card (skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sharded_card.py
"""

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.ops import ivf as tivf
from rag_inference_pipeline_tpu_torch.ops import pq as tpq
from rag_inference_pipeline_tpu_torch.ops.topk import (
    binmax_partial_topk,
    binmax_partial_topk_int8gs,
    binmax_partial_topk_int8gs_plain,
    binmax_partial_topk_plain,
    quantize_global_int8,
    sharded_topk,
    sharded_topk_int8gs,
)

DP = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_mesh(dp=DP, devices=force_host_devices(DP, "cuda:0"))


def _unit(g, n, d):
    x = torch.randn(n, d, generator=g, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,rescore", [(200_003, 8, True), (200_003, 33, False), (5_000, 4, True)])
def test_k1_once_a_shard_matches_plain(mesh, n, b, rescore):
    """K1 with each shard's own row count (5,000 rows leave shards 1-3
    none: they are not scanned) and the per-shard bf16 re-score."""
    g = torch.Generator(device="cuda").manual_seed(n + b)
    d, k, nbins = 768, 10, 1024
    x = _unit(g, n, d)
    q = _unit(g, b, d)
    codes, scale = quantize_global_int8(x)
    pad = -n % (8192 * DP)
    codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    rows = torch.nn.functional.pad(x, (0, 0, 0, pad)).to(torch.bfloat16)
    shards = mesh.put(codes, mesh.rows_dp)
    rs = mesh.put(rows, mesh.rows_dp) if rescore else None
    kw = dict(rescore_db_shards=rs, rescore_k=64 if rescore else 0, nbins=nbins, ntotal=n)
    binmax_partial_topk_int8gs.launches = 0
    s, i = sharded_topk_int8gs(mesh, q, shards, scale, k, **kw)
    owning = sum(1 for r in range(DP) if n > r * (codes.shape[0] // DP))
    assert binmax_partial_topk_int8gs.launches == owning
    ps, pi = sharded_topk_int8gs(mesh, q, shards, scale, k,
                                 scan=binmax_partial_topk_int8gs_plain, **kw)
    np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **TOL)
    assert (i >= 0).all() and (i < n).all()


@pytest.mark.cuda
def test_k2_once_a_shard_matches_plain(mesh):
    """K2 through the fused sharded scan on integer-valued bf16 rows (every
    product and sum exact): bit for bit, ties included."""
    g = torch.Generator(device="cuda").manual_seed(2)
    n, d, b, k = 100_001, 768, 8, 10
    db = torch.randint(-8, 9, (n + (-n % DP), d), generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-8, 9, (b, d), generator=g, device="cuda").float()
    shards = mesh.put(db, mesh.rows_dp)
    binmax_partial_topk.launches = 0
    s, i = sharded_topk(mesh, q, shards, k, use_fused=True, nbins=512, ntotal=n)
    assert binmax_partial_topk.launches == DP
    ps, pi = sharded_topk(mesh, q, shards, k, use_fused=True, nbins=512, ntotal=n,
                          scan=binmax_partial_topk_plain)
    np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_array_equal(s.cpu().numpy(), ps.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
def test_k5_once_a_shard_matches_plain(mesh, b):
    """K5 through `sharded_ivf_search` (IP, bf16 buckets of integer-valued
    rows and queries: every product and sum exact) under the global coarse
    floor: one launch a shard, bit for bit, ties included."""
    g = torch.Generator(device="cuda").manual_seed(50 + b)
    nlist, cap, d = 256, 128, 768
    sizes = torch.randint(0, cap + 1, (nlist,), generator=g, device="cuda").to(torch.int32)
    filled = torch.arange(cap, device="cuda")[None, :] < sizes[:, None]
    ids = torch.where(filled, torch.arange(nlist * cap, device="cuda").view(nlist, cap), -1)
    rows = torch.randint(-8, 9, (nlist, cap, d), generator=g, device="cuda") * filled[:, :, None]
    listing = tivf.IVFListing(_unit(g, nlist, d), rows.to(torch.bfloat16),
                              ids.to(torch.int32), sizes)
    shards = tivf.shard_ivf_listing(mesh, listing)
    q = torch.randint(-8, 9, (b, d), generator=g, device="cuda").float()
    tivf.ivf_dedup_scores.launches = 0
    s, i = tivf.sharded_ivf_search(mesh, shards, q, 10, nprobe=16)
    assert tivf.ivf_dedup_scores.launches == DP
    ps, pi = tivf.sharded_ivf_search(mesh, shards, q, 10, nprobe=16,
                                     scan=tivf.ivf_dedup_scores_plain)
    np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_array_equal(s.cpu().numpy(), ps.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
def test_k6_once_a_shard_matches_plain(mesh, b):
    """K6 through `sharded_ivfpq_search` (PQ4, m 192 at 768d) under the
    global coarse floor: one launch a shard."""
    g = torch.Generator(device="cuda").manual_seed(b)
    nlist, cap, d, m = 256, 128, 768, 192
    sizes = torch.randint(0, cap + 1, (nlist,), generator=g, device="cuda").to(torch.int32)
    pos = torch.arange(cap, device="cuda")
    filled = pos[None, :] < sizes[:, None]
    ids = torch.where(filled, torch.arange(nlist * cap, device="cuda").view(nlist, cap), -1)
    codes = torch.zeros((nlist, cap, 256), dtype=torch.uint8, device="cuda")
    codes[:, :, :m] = torch.randint(0, 16, (nlist, cap, m), generator=g, device="cuda").to(
        torch.uint8)
    codes *= filled[:, :, None]
    listing = tpq.IVFPQListing(
        centroids=_unit(g, nlist, d), codebooks=torch.randn(m, 16, d // m, generator=g,
                                                             device="cuda") * 0.1,
        code_buckets=codes, ids=ids.to(torch.int32), list_sizes=sizes,
    )
    shards = tpq.shard_ivfpq_listing(mesh, listing)
    q = _unit(g, b, d)
    tpq.ivfpq4_adc_scores.launches = 0
    s, i = tpq.sharded_ivfpq_search(mesh, shards, q, 10, nprobe=16)
    assert tpq.ivfpq4_adc_scores.launches == DP
    ps, pi = tpq.sharded_ivfpq_search(mesh, shards, q, 10, nprobe=16,
                                      scan=tpq.ivfpq4_adc_scores_plain)
    np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_sharded_flat_index_on_the_card(mesh):
    """FlatIndex at dp = 4 on one card: the row shards are views of one
    allocation (one copy of the codes), K1 once a shard, and the same ids
    as the unsharded index where the two re-score the same shortlist."""
    g = torch.Generator(device="cuda").manual_seed(7)
    n, d = 150_000, 768
    x = _unit(g, n, d)
    q = x[:8] + 0.05 * _unit(g, 8, d)
    idx = FlatIndex(d, mesh=mesh, nbins=1024)
    idx.add(x)
    assert len(idx._db_i8) == DP
    assert len({s.untyped_storage().data_ptr() for s in idx._db_i8}) == 1
    binmax_partial_topk_int8gs.launches = 0
    _, i = idx.search(q, 10)
    assert binmax_partial_topk_int8gs.launches == DP
    assert (i[:, 0] == torch.arange(8, device="cuda")).all()
