"""The flat index's host rescore store on the card: K1's shortlist with no
device re-score, then the native f16 re-rank on the host, against the
same pipeline through K1's plain version and the numpy re-score. Imports
no jax; needs a CUDA card (skipped without one) and g++:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_host_stores_card.py
"""

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.ops.topk import (
    binmax_partial_topk_int8gs,
    binmax_partial_topk_int8gs_plain,
    fused_topk_int8gs,
)
from rag_inference_pipeline_tpu_torch.utils import cpuscan

TOL = dict(rtol=1e-5, atol=1e-5)


def _unit(g, n, d):
    x = torch.randn(n, d, generator=g, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k", [(50_000, 768, 8, 10), (20_000, 64, 33, 40), (40, 64, 5, 50)])
def test_host_refine_on_the_card_matches_plain(n, d, b, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(n + d)
    x = _unit(g, n, d)
    q = _unit(g, b, d)
    idx = FlatIndex(d, device=torch.device("cuda"), rescore_store="host")
    before = torch.cuda.memory_allocated()
    idx.add(x)
    assert idx._db is None and idx._host_rescore.shape == (n, d)
    assert torch.cuda.memory_allocated() - before < idx._db_i8.numel() + (1 << 20)
    binmax_partial_topk_int8gs.launches = 0
    s, i = idx.search(q, k)
    assert binmax_partial_topk_int8gs.launches == 1
    assert s.device.type == "cuda" and i.dtype == torch.int32
    s_k = min(max(idx.rescore_k, k + 32), idx.nbins)
    _, short = fused_topk_int8gs(q, idx._db_i8, idx._db_gscale, s_k, nbins=idx.nbins,
                                 ntotal=idx.ntotal, scan=binmax_partial_topk_int8gs_plain)
    qn = q.cpu().numpy()
    ps, pi = cpuscan.rescore_f16_plain(qn, idx._host_rescore, short.cpu().numpy(), k)
    ts, ti = s.cpu().numpy(), i.cpu().numpy()
    valid = ti >= 0
    np.testing.assert_array_equal(valid, pi >= 0)
    assert (n < s_k) == (~valid).any()
    np.testing.assert_allclose(ts[valid], ps[valid], **TOL)
    assert (ts[~valid] == np.float32(-3.0e38)).all() and (ps[~valid] == -np.inf).all()
    for r in range(b):
        for j in np.nonzero(ti[r] != pi[r])[0]:  # near-ties only
            assert abs(float(ts[r, j]) - float(ps[r, j])) <= 2 * TOL["atol"]
        assert sorted(ti[r][valid[r]]) == sorted(pi[r][valid[r]])
