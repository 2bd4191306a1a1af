"""The kernel wrappers without the JAX package: the K1 wrapper's CPU
dispatch and plain version and the shared launch helper here, and every
hand-written CUDA kernel (K1 to K8, the W8A8 quantize and GEMM, and the
encoder flash attention) against its plain version on a card.

This file imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.ops import _kernels
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


class TestLaunchHelper:
    """`_kernels.launch`, which every wrapper calls: the stream comes from
    the raw current-stream lookup, a device guard is entered only for a
    device other than the current one, and a non-zero cudaError raises."""

    @pytest.mark.parametrize("index,current,guard", [
        (0, 0, False), (1, 0, True), (0, 2, True), (3, 3, False),
    ])
    def test_device_guard_decision(self, index, current, guard):
        assert _kernels.needs_device_guard(index, current) is guard

    @pytest.mark.parametrize("index,current,rc", [(0, 0, 0), (1, 0, 0), (2, 2, 700)])
    def test_launch_on_a_fake_library(self, monkeypatch, index, current, rc):
        import contextlib

        calls, guards = [], []

        class FakeLib:
            def ragtorch_fake(self, *args):
                calls.append(args)
                return rc

        @contextlib.contextmanager
        def device(i):
            guards.append(i)
            yield

        monkeypatch.setattr(_kernels, "_lib", FakeLib())
        monkeypatch.setattr(_kernels, "_raw_stream", None)  # looked up at the launch
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda i: 1000 + i, raising=False)
        monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current, raising=False)
        monkeypatch.setattr(torch.cuda, "device", device)
        if rc:
            with pytest.raises(RuntimeError, match="ragtorch_fake launch failed: cudaError 700"):
                _kernels.launch("ragtorch_fake", index, 7, None)
        else:
            _kernels.launch("ragtorch_fake", index, 7, None)
        assert calls == [(7, None, 1000 + index)]
        assert guards == ([index] if index != current else [])


class TestScanGrid:
    """The grid of the bin-max kernels K1, K2 and K3 on the CPU, with the
    card's SM count and the library's tile faked: a split of the step range
    over at most four blocks (bin tiles by query tiles) per SM, never more
    groups than steps or than 65535, the same for the three wrappers."""

    @staticmethod
    def _fake_card(monkeypatch, sms, tile=(128, 64)):
        class Props:
            multi_processor_count = sms

        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
        monkeypatch.setattr(_kernels, "binmax_tile", lambda: tile)

    @pytest.mark.parametrize("b,nbins,nt,sms,tile,groups", [
        (8, 1024, 1_000_333, 132, (128, 64), 66),  # K1 on the fused /query
        (128, 1024, 1_000_333, 132, (128, 64), 33),  # the kernel lab's batch
        (8, 512, 1_000_333, 132, (128, 64), 132),  # K2 on the flat /retrieve
        (64, 512, 1_000_777, 132, (128, 64), 132),  # K3 under fused_topk_int8
        (200, 1024, 1_000_333, 132, (128, 64), 16),  # 4 query tiles; 528 // 32
        (33, 512, 49_000, 132, (128, 64), 96),  # never more groups than steps
        (128, 65_536, 10**7, 132, (128, 64), 1),  # more base blocks than 4 an SM
        (1, 1, 10**6, 100_000, (128, 64), 65535),  # never more than a grid allows
        (128, 1024, 1_000_333, 132, (64, 32), 8),  # another tile: 16 x 4 blocks
        (8, 1024, 1_000_333, 132, (64, 8), 33),  # 16 x 1
    ])
    def test_scan_groups_follow_the_tile(self, monkeypatch, b, nbins, nt, sms,
                                         tile, groups):
        self._fake_card(monkeypatch, sms, tile)
        got = ttopk._scan_groups(torch.device("cpu"), b, nbins, nt)
        assert got == groups
        assert 1 <= got <= min(-(-nt // nbins), 65535)

    def test_tile_read_once_from_the_library(self, monkeypatch):
        """`_kernels.binmax_tile` asks the library once and keeps it."""
        calls = []

        class FakeLib:
            def ragtorch_binmax_tile(self, bins, max_q):
                calls.append(1)
                bins._obj.value, max_q._obj.value = 128, 64
                return 0

        monkeypatch.setattr(_kernels, "_lib", FakeLib())
        monkeypatch.setattr(_kernels, "_binmax_tile", None)
        assert _kernels.binmax_tile() == (128, 64)
        assert _kernels.binmax_tile() == (128, 64)
        assert calls == [1]

    @pytest.mark.parametrize("b,n,nbins", [(8, 5000, 128), (33, 3000, 256), (70, 900, 512)])
    def test_k1_k2_k3_take_the_same_grid(self, monkeypatch, b, n, nbins):
        """Each wrapper, made to take its card route on CPU tensors, hands
        its kernel the groups of the one shared rule."""
        self._fake_card(monkeypatch, 132)
        calls = {}
        monkeypatch.setattr(ttopk, "_on_cpu", lambda *args: False)
        monkeypatch.setattr(ttopk._kernels, "launch",
                            lambda name, index, *args: calls.__setitem__(name, args))
        for fn in (ttopk.binmax_partial_topk_int8gs, ttopk.binmax_partial_topk_int8,
                   ttopk.binmax_partial_topk):  # counts of real launches, restored
            monkeypatch.setattr(fn, "launches", fn.launches)
        rng = np.random.default_rng(b)
        q, db = torch.from_numpy(_i8(rng, b, 16)), torch.from_numpy(_i8(rng, n, 16))
        ttopk.binmax_partial_topk_int8gs(q, db, nbins=nbins)
        ttopk.binmax_partial_topk_int8(q, db, torch.ones(n), nbins=nbins)
        ttopk.binmax_partial_topk(q.float(), db.to(torch.bfloat16), nbins=nbins)
        groups = ttopk._scan_groups(db.device, b, nbins, n)
        assert calls["ragtorch_binmax_int8gs"][-2:] == (nbins, groups)
        assert calls["ragtorch_binmax_int8"][-2:] == (nbins, groups)
        assert calls["ragtorch_binmax_bf16"][-3:] == (nbins, groups, 2)


def _plant_ties(q, db, nbins, nt, scales=None):
    """Rows 5 and 7 made query 0's best in their bins (all of query 0's
    signs, at full scale), then copied to a later step (row nbins + 5) and
    to the last z-group of the kernel's split (row 7 + (G-1) * steps a
    group * nbins, when below nt): the earlier row must keep the bin. With
    `scales` (K3), the copies take the same scale."""
    top = 127 if db.dtype == torch.int8 else 8
    for r in (5, 7):
        if r < nt:
            db[r] = (torch.sign(q[0].float()) * top).to(db.dtype)
    steps = -(-nt // nbins)
    groups = ttopk._scan_groups(db.device, q.shape[0], nbins, nt)
    late = 7 + (groups - 1) * -(-steps // groups) * nbins
    for src, dst in ((5, nbins + 5), (7, late)):
        if dst < nt and dst != src:
            db[dst] = db[src]
            if scales is not None:
                scales[dst] = scales[src]


# B in {1, 8, 9, 33, 128} and more (1 or 2 query tiles of at most 64: 1-8
# n-tiles, the last one partly full),
# D in {12, 36, 768} (12 and 36: rows not a multiple of 16 bytes, 4-byte
# copies), ntotal in the middle of a 128-bin tile and below nbins
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,ntotal,d,nbins", [
    (8, 1_000_777, 1_000_333, 768, 1024),  # the main path's shape
    (37, 5000, 4321, 64, 128),
    (5, 3000, 90, 768, 128),  # ntotal < nbins: empty bins
    (9, 4096, None, 12, 1024),  # D % 16 != 0, one step per bin
    (1, 20_000, 19_950, 36, 256),
    (33, 50_000, 49_000, 768, 512),
    (128, 200_000, 199_937, 768, 1024),  # the kernel lab's batch
    (128, 9_000, 8_999, 12, 128),
    (20, 9_000, 8_999, 36, 128),  # 3 n-tiles
    (30, 9_000, 8_999, 768, 256),  # 4
    (90, 9_000, 8_999, 768, 256),  # two tiles of 45: 6 n-tiles
    (100, 9_000, 8_999, 36, 128),  # two tiles of 50: 7 n-tiles
])
def test_k1_kernel_matches_plain_on_card(b, n, ntotal, d, nbins):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(b + n)
    q = torch.randint(-127, 128, (b, d), generator=g, device="cuda",
                      dtype=torch.int8)
    db = torch.randint(-127, 128, (n, d), generator=g, device="cuda",
                       dtype=torch.int8)
    _plant_ties(q, db, nbins, n if ntotal is None else ntotal)
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


# --- K2, K4, K5 -------------------------------------------------------------


def _card_inputs(g, integer, *shape, dtype=torch.bfloat16):
    """Integer-valued entries in [-8, 8] (exact f32 sums: bit-identical to
    the plain version) or random unit rows (scores within rtol/atol 1e-5)."""
    if integer:
        x = torch.randint(-8, 9, shape, generator=g, device="cuda").float()
    else:
        x = torch.randn(shape, generator=g, device="cuda")
        x = x / x.norm(dim=-1, keepdim=True)
    return x.to(dtype)


def _close(a, b, exact):
    if exact:
        assert torch.equal(a, b)
    else:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _same_choice(k_idx, p_idx, exact):
    """Bit-exact inputs pick the same rows; random inputs sum in another
    order, so a near-tie (scores within the tolerance, checked by
    `_close`) may pick the other row, in a tiny share of the bins."""
    if exact:
        assert torch.equal(k_idx, p_idx)
    else:
        assert (k_idx != p_idx).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,ntotal,d,nbins,integer,dtype", [
    (8, 1_000_777, 1_000_333, 768, 512, True, torch.bfloat16),  # main path
    (8, 1_000_777, 1_000_333, 768, 512, False, torch.bfloat16),
    (37, 5000, 4321, 64, 128, True, torch.bfloat16),
    (5, 3000, 90, 768, 128, True, torch.float32),  # ntotal < nbins
    (1, 20_000, 19_950, 36, 256, True, torch.bfloat16),  # 4-byte copies
    (9, 30_000, 29_999, 12, 128, False, torch.bfloat16),
    (33, 50_000, 49_000, 768, 512, False, torch.bfloat16),  # 5 n-tiles
    (128, 200_000, 199_937, 768, 1024, True, torch.bfloat16),  # two query tiles
    (128, 200_000, 199_937, 768, 1024, False, torch.bfloat16),
    (5, 3000, 90, 768, 128, True, torch.bfloat16),  # ntotal < nbins
    (20, 9_000, 8_999, 36, 128, True, torch.bfloat16),  # 3 n-tiles
    (100, 9_000, 8_999, 768, 256, True, torch.bfloat16),  # 7 n-tiles
])
def test_k2_kernel_matches_plain_on_card(b, n, ntotal, d, nbins, integer, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K2 kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(b + n)
    q = _card_inputs(g, integer, b, d, dtype=torch.float32)
    db = _card_inputs(g, integer, n, d, dtype=dtype)
    if integer:
        _plant_ties(q, db, nbins, ntotal)
    else:
        db[nbins + 5] = db[5]  # a tie: the earlier row keeps the bin
    before = ttopk.binmax_partial_topk.launches
    kv, ki = ttopk.binmax_partial_topk(q, db, nbins=nbins, ntotal=ntotal)
    pv, pi = ttopk.binmax_partial_topk_plain(q, db, nbins=nbins, ntotal=ntotal)
    torch.cuda.synchronize()
    assert ttopk.binmax_partial_topk.launches == before + 1
    _close(kv, pv, integer)
    _same_choice(ki, pi, integer)


def _card_listing(g, integer, nlist, cap, d, fill):
    """A listing with ragged, empty and full lists (sizes from `fill`)."""
    from rag_inference_pipeline_tpu_torch.ops.ivf import IVFListing

    sizes = (torch.rand(nlist, generator=g, device="cuda") * fill * cap).int()
    sizes[:3] = torch.tensor([0, cap, cap - 1], device="cuda", dtype=torch.int32)
    buckets = _card_inputs(g, integer, nlist, cap, d)
    pos = torch.arange(cap, device="cuda")
    buckets[pos[None, :] >= sizes[:, None]] = 0
    ids = torch.where(pos[None, :] < sizes[:, None],
                      torch.arange(nlist * cap, device="cuda").view(nlist, cap),
                      -1).int()
    cents = _card_inputs(g, integer, nlist, d, dtype=torch.float32)
    return IVFListing(cents, buckets, ids, sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nprobe,integer", [(8, 64, True), (8, 64, False), (13, 5, True)])
def test_k5_kernel_matches_plain_on_card(b, nprobe, integer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K5 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import ivf

    g = torch.Generator(device="cuda").manual_seed(b * nprobe)
    lst = _card_listing(g, integer, 4096, 640, 768, 0.8)
    q = _card_inputs(g, integer, b, 768)
    probe = torch.randint(0, 4096, (b, nprobe), generator=g, device="cuda").int()
    probe[:, 0] = torch.arange(b, device="cuda") % 3  # the empty and full lists
    slots, _ = ivf.dedup_probes(probe, 4096, min(4096, b * nprobe))
    before = ivf.ivf_dedup_scores.launches
    k = ivf.ivf_dedup_scores(q, lst.buckets, slots, lst.list_sizes)
    p = ivf.ivf_dedup_scores_plain(q, lst.buckets, slots, lst.list_sizes)
    torch.cuda.synchronize()
    assert ivf.ivf_dedup_scores.launches == before + 1
    _close(k, p, integer)
    ks, ki = ivf.ivf_search_dedup(lst, q.float(), 10, nprobe=nprobe)
    ps, pi = ivf.ivf_search_dedup(lst, q.float(), 10, nprobe=nprobe,
                                  scan=ivf.ivf_dedup_scores_plain)
    assert torch.equal(ki, pi)
    _close(ks, ps, integer)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,kind", [
    (1, 768, "int"),
    (8, 768, "int"),  # the main path: 512 slots
    (8, 768, "real"),
    (13, 768, "int"),
    (32, 768, "int"),  # 2,048 slots, one z-tile
    (32, 768, "real"),
    (33, 768, "int"),  # five n-tiles, the last one ragged
    (64, 768, "int"),  # every list a slot, two z-tiles of 32
    (64, 768, "real"),
    (13, 36, "int"),  # 72-byte rows: 4-byte copies, a zero-filled k-tail
    (33, 36, "real"),
    (8, 768, "f32"),  # f32 buckets: the CUDA-core path
    (33, 36, "f32"),
])
def test_k5_kernel_across_batches_on_card(b, d, kind):
    """K5 at nprobe 64 over a 4096 x 640 listing: integer-valued inputs bit
    for bit, real unit rows within rtol=atol=1e-5 (the tensor cores sum in
    another order than cuBLAS), and the same ids from ivf_search_dedup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K5 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import ivf

    exact = kind != "real"
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(b * d)
    lst = _card_listing(g, exact, 4096, 640, d, 0.8)
    lst = lst._replace(buckets=lst.buckets.to(dtype))
    q = _card_inputs(g, exact, b, d, dtype=dtype)
    probe = torch.randint(0, 4096, (b, 64), generator=g, device="cuda").int()
    probe[:, 0] = torch.arange(b, device="cuda") % 3  # the empty and full lists
    slots, _ = ivf.dedup_probes(probe, 4096, min(4096, b * 64))
    before = ivf.ivf_dedup_scores.launches
    k = ivf.ivf_dedup_scores(q, lst.buckets, slots, lst.list_sizes)
    p = ivf.ivf_dedup_scores_plain(q, lst.buckets, slots, lst.list_sizes)
    torch.cuda.synchronize()
    assert ivf.ivf_dedup_scores.launches == before + 1
    _close(k, p, exact)
    ks, ki = ivf.ivf_search_dedup(lst, q.float(), 10, nprobe=64)
    ps, pi = ivf.ivf_search_dedup(lst, q.float(), 10, nprobe=64,
                                  scan=ivf.ivf_dedup_scores_plain)
    assert torch.equal(ki, pi)
    _close(ks, ps, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nprobe,d,kind", [
    (64, 64, 768, "int"),  # the main path: a 64-item /retrieve
    (64, 64, 768, "real"),
    (5, 3, 768, "int"),
    (1, 1, 768, "int"),
    (1, 64, 768, "real"),
    (65, 64, 768, "int"),
    (5, 3, 36, "int"),  # 72-byte rows: 4-byte copies
    (65, 3, 36, "real"),
    (64, 64, 768, "f32"),  # f32 buckets
    (5, 3, 36, "f32"),
    (1, 3, 36, "f32"),
])
def test_k4_kernel_matches_plain_on_card(b, nprobe, d, kind):
    """K4 over a 4096 x 640 listing with empty, full and ragged lists and
    a list probed twice: integer-valued inputs bit for bit, real unit rows
    within rtol=atol=1e-5, and the same ids from ivf_search_scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K4 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import ivf

    exact = kind != "real"
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(b * nprobe + d)
    lst = _card_listing(g, exact, 4096, 640, d, 0.8)
    lst = lst._replace(buckets=lst.buckets.to(dtype))
    q = _card_inputs(g, exact, b, d, dtype=dtype)
    probe = torch.randint(0, 4096, (b, nprobe), generator=g, device="cuda").int()
    if nprobe >= 2:
        probe[:, 1] = probe[:, 0]  # a repeated list: the earlier slot wins
    if nprobe >= 3:
        probe[0, :3] = torch.tensor([0, 1, 1], device="cuda")  # empty, full, full
    before = ivf.ivf_scan_partial.launches
    kv, kw = ivf.ivf_scan_partial(q, lst.buckets, probe, lst.list_sizes)
    pv, pw = ivf.ivf_scan_partial_plain(q, lst.buckets, probe, lst.list_sizes)
    torch.cuda.synchronize()
    assert ivf.ivf_scan_partial.launches == before + 1
    _close(kv, pv, exact)
    _same_choice(kw, pw, exact)
    if nprobe >= 3:  # a repeated list never wins from the later slot
        assert not (kw[1:] == 1).any() and not (kw[0] == 2).any()
    ks, ki = ivf.ivf_search_scan(lst, q.float(), 10, nprobe=nprobe)
    ps, pi = ivf.ivf_search_scan(lst, q.float(), 10, nprobe=nprobe,
                                 scan=ivf.ivf_scan_partial_plain)
    assert torch.equal(ki, pi)
    _close(ks, ps, exact)


@pytest.mark.cuda
def test_ivf_kernels_refuse_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import ivf

    buckets = torch.zeros((4, 128, 16), dtype=torch.float16, device="cuda")
    sizes = torch.zeros(4, dtype=torch.int32, device="cuda")
    slots = torch.arange(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ivf.ivf_dedup_scores(buckets[0, :2], buckets, slots, sizes)
    with pytest.raises(TypeError):
        ivf.ivf_dedup_scores(buckets[0, :2].bfloat16(), buckets.bfloat16(),
                             slots.long(), sizes)
    with pytest.raises(ValueError):
        ivf.ivf_scan_partial(buckets[0, :2].cpu(), buckets, slots[None], sizes)
    with pytest.raises(TypeError):
        ttopk.binmax_partial_topk(buckets[0, :2], buckets[0])


# --- K6 ---------------------------------------------------------------------


def _pq4_buckets(g, nlist, cap, m, fill):
    """PQ4 code buckets lane-padded to 128 columns (zeros past m), with
    ragged, empty and full lists; zeros past each list's size."""
    m_store = max(128, -(-m // 128) * 128)
    sizes = (torch.rand(nlist, generator=g, device="cuda") * fill * cap).int()
    sizes[:3] = torch.tensor([0, cap, cap - 1], device="cuda", dtype=torch.int32)
    codes = torch.randint(0, 16, (nlist, cap, m_store), generator=g, device="cuda",
                          dtype=torch.uint8)
    codes[:, :, m:] = 0
    pos = torch.arange(cap, device="cuda")
    codes[pos[None, :] >= sizes[:, None]] = 0
    return codes, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("b,nprobe,m,integer", [
    (8, 64, 192, True),  # the main path: 512 slots of the 1M PQ4 layout
    (8, 64, 192, False),
    (64, 64, 192, True),  # every list a slot, 8 n-tiles
    (64, 64, 192, False),
    (13, 5, 24, True),  # an 8-subspace tail chunk, b_pad 16
    (1, 64, 8, True),  # one n-tile, one tail chunk
    (1, 3, 192, False),
    (13, 64, 16, True),  # a partly padded query tile
    (72, 64, 192, True),  # two z-tiles: 40 and 32 queries
    (72, 3, 16, False),
])
def test_k6_kernel_matches_plain_on_card(b, nprobe, m, integer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K6 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import ivf, pq

    g = torch.Generator(device="cuda").manual_seed(b * m + nprobe)
    codes, sizes = _pq4_buckets(g, 4096, 640, m, 0.8)
    b_pad = -(-b // 8) * 8
    lut = _card_inputs(g, integer, b_pad, m * 16)
    probe = torch.randint(0, 4096, (b, nprobe), generator=g, device="cuda").int()
    probe[:, 0] = torch.arange(b, device="cuda") % 3  # the empty and full lists
    slots, _ = ivf.dedup_probes(probe, 4096, min(4096, b * nprobe))
    before = pq.ivfpq4_adc_scores.launches
    k = pq.ivfpq4_adc_scores(lut, codes, slots, sizes)
    p = pq.ivfpq4_adc_scores_plain(lut, codes, slots, sizes)
    torch.cuda.synchronize()
    assert pq.ivfpq4_adc_scores.launches == before + 1
    _close(k, p, integer)
    # the whole search, kernel against plain, on a listing of these codes
    cb = _card_inputs(g, integer, m, 16, 4, dtype=torch.float32)
    cents = _card_inputs(g, integer, 4096, 4 * m, dtype=torch.float32)
    pos = torch.arange(640, device="cuda")
    ids = torch.where(pos[None, :] < sizes[:, None],
                      torch.arange(4096 * 640, device="cuda").view(4096, 640), -1).int()
    lst = pq.IVFPQListing(cents, cb, codes, ids, sizes)
    q = _card_inputs(g, integer, b, 4 * m, dtype=torch.float32)
    ks, ki = pq.ivfpq4_search_dedup(lst, q, 10, nprobe=nprobe)
    ps, pi = pq.ivfpq4_search_dedup(lst, q, 10, nprobe=nprobe,
                                    scan=pq.ivfpq4_adc_scores_plain)
    _close(ks, ps, integer)
    assert torch.equal(ki, pi)


@pytest.mark.cuda
def test_k6_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import pq

    codes = torch.zeros((4, 128, 128), dtype=torch.uint8, device="cuda")
    sizes = torch.zeros(4, dtype=torch.int32, device="cuda")
    slots = torch.arange(4, dtype=torch.int32, device="cuda")
    lut = torch.zeros((8, 16 * 16), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        pq.ivfpq4_adc_scores(lut.float(), codes, slots, sizes)
    with pytest.raises(ValueError, match="multiple of 8"):
        pq.ivfpq4_adc_scores(lut[:7], codes, slots, sizes)
    with pytest.raises(ValueError, match="16-byte"):
        pq.ivfpq4_adc_scores(lut, codes[:, :, :8].contiguous(), slots, sizes)
    with pytest.raises(TypeError):
        pq.ivfpq4_adc_scores(lut, codes, slots.long(), sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k,case", [
    (4, 97, 40, "ties"),
    (6, 64, 20, "signed_zeros"),
    (5, 50, 12, "nan"),
    (4, 300, 100, "neg_inf_fill"),
    (3, 33, 33, "k_equals_n"),
    # the B=64 PQ4 search's flat top-k: above _ONE_PASS_MAX, two passes
    (64, 2_621_440, 256, "ties"),
    (64, 2_621_440, 256, "signed_zeros"),
    (64, 2_621_440, 256, "nan"),
    (64, 2_621_440, 256, "neg_inf_fill"),
])
def test_topk_selection_on_card_matches_cpu(rows, n, k, case):
    """The card's selection (one pass over int64 keys for small inputs, two
    passes over the values for large ones) returns the CPU selection's
    indices and value bits (the CPU one is held to lax.top_k in
    test_torch_topk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the two-pass selection runs on CUDA tensors")
    rng = np.random.default_rng(rows * n + k)
    x = rng.integers(-3, 4, (rows, n)).astype(np.float32)
    if case == "signed_zeros":
        x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), (rows, n))
    elif case == "nan":
        x = rng.standard_normal((rows, n)).astype(np.float32)
        x[rng.random(x.shape) < 0.1] = np.nan
    elif case == "neg_inf_fill":
        x[:, rng.random(n) < max(0.5, 1 - 0.5 * k / n)] = ttopk.NEG_INF
        x[0, 20:] = ttopk.NEG_INF  # fewer valid entries than k
    cpu = torch.from_numpy(x)
    cv, ci = ttopk._topk(cpu, k)
    gv, gi = ttopk._topk(cpu.cuda(), k)
    assert torch.equal(gi.cpu(), ci)
    assert torch.equal(gv.cpu().view(torch.int32), cv.view(torch.int32))


# --- K3, K7, K8 -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,nbins", [
    (8, 1_000_777, 768, 512),  # fused_topk_int8's default nbins at 1M rows
    (37, 5000, 64, 128),
    (5, 90, 768, 128),  # N < nbins: empty bins
    (1, 20_000, 36, 256),  # 4-byte copies; N in the middle of a tile
    (9, 30_001, 12, 128),
    (33, 50_000, 768, 512),
    (128, 200_000, 768, 1024),
    (30, 9_001, 36, 128),  # 4 n-tiles
    (90, 9_001, 768, 256),  # two tiles of 45: 6 n-tiles
])
def test_k3_kernel_matches_plain_on_card(b, n, d, nbins):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K3 kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(b + n)
    q = torch.randint(-127, 128, (b, d), generator=g, device="cuda", dtype=torch.int8)
    db = torch.randint(-127, 128, (n, d), generator=g, device="cuda", dtype=torch.int8)
    # f32 scales over many binades, one negative, one zero, one NaN
    scales = torch.exp(torch.rand(n, generator=g, device="cuda") * 25 - 20)
    scales[:3] = torch.tensor([-0.25, 0.0, float("nan")], device="cuda")
    scales[5:8] = 1e3  # rows 5 and 7 win their bins for query 0
    _plant_ties(q, db, nbins, n, scales)
    before = ttopk.binmax_partial_topk_int8.launches
    kv, ki = ttopk.binmax_partial_topk_int8(q, db, scales, nbins=nbins)
    pv, pi = ttopk.binmax_partial_topk_int8_plain(q, db, scales, nbins=nbins)
    torch.cuda.synchronize()
    assert ttopk.binmax_partial_topk_int8.launches == before + 1
    assert torch.equal(kv, pv)
    assert torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype", [
    (8, 384, 2, 64, torch.bfloat16),  # Qwen2.5-0.5B's cache at B=8
    (3, 16, 4, 8, torch.float32),
])
def test_k7_kernel_matches_plain_on_card(b, s, h, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K7 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import kv

    g = torch.Generator(device="cuda").manual_seed(b * s)
    cache = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    new = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    pos = torch.randint(0, s, (b,), generator=g, device="cuda").int()
    pos[0], pos[-1] = s + 20, -3  # past the end: row S-1; below 0: row S-3
    ref = kv.kv_row_insert_plain(cache.clone(), new, pos)
    before = kv.kv_row_insert.launches
    out = kv.kv_row_insert(cache, new, pos)
    torch.cuda.synchronize()
    assert out is cache and kv.kv_row_insert.launches == before + 1
    assert torch.equal(out, ref)
    with pytest.raises(TypeError):
        kv.kv_row_insert(cache, new, pos.long())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype", [
    (8, 384, 2, 64, torch.bfloat16),  # Qwen2.5-0.5B's cache at B=8
    (3, 16, 4, 8, torch.float32),
])
def test_k7_pair_matches_plain_on_card(b, s, h, d, dtype):
    """One launch writes both caches, bit-identical to two plain inserts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K7 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import kv

    g = torch.Generator(device="cuda").manual_seed(b * s + 1)
    ck, cv = (torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    nk, nv = (torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    pos = torch.randint(0, s, (b,), generator=g, device="cuda").int()
    pos[0], pos[-1] = s + 20, -3  # past the end: row S-1; below 0: row S-3
    ref_k, ref_v = kv.kv_row_insert_pair_plain(ck.clone(), cv.clone(), nk, nv, pos)
    before = (kv.kv_row_insert.launches, kv.kv_row_insert_pair.launches)
    out_k, out_v = kv.kv_row_insert_pair(ck, cv, nk, nv, pos)
    torch.cuda.synchronize()
    assert out_k is ck and out_v is cv
    assert (kv.kv_row_insert.launches, kv.kv_row_insert_pair.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(out_k, ref_k) and torch.equal(out_v, ref_v)
    with pytest.raises(ValueError, match="CUDA"):
        kv.kv_row_insert_pair(ck, cv.cpu(), nk, nv, pos)
    with pytest.raises(ValueError, match="16-byte"):
        kv.kv_row_insert_pair(ck, cv, nk, nv.transpose(1, 2).contiguous().transpose(1, 2), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,chunk", [
    (1_000_000, 768, 4096),  # the lab's stream shapes
    (1_000_000, 768, 8192),
    (1000, 128, 64),  # N not a multiple of chunk
    (100, 256, 512),  # chunk > N: nothing streamed
])
def test_k8_kernel_matches_plain_on_card(n, d, chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K8 kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import stream

    g = torch.Generator(device="cuda").manual_seed(n + chunk)
    db = torch.randint(-128, 128, (n, d), generator=g, device="cuda", dtype=torch.int8)
    q = torch.randint(-1000, 1000, (8, 128), generator=g, device="cuda", dtype=torch.int32)
    before = stream.stream_sum.launches
    out, checksum = stream.stream_sum(q, db, chunk)
    ref, ref_sum = stream.stream_sum_plain(q, db, chunk)
    torch.cuda.synchronize()
    assert stream.stream_sum.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(checksum, ref_sum)
    strided = torch.zeros((64, d + 8), dtype=torch.int8, device="cuda")[:, 8:]
    with pytest.raises(ValueError, match="16-byte"):
        stream.stream_sum(q, strided, 8)


def _w8a8_rows(g, m, k, dtype):
    """Activations with a zero row and a row of exact ties (abs-max 127, so
    the scale is 1 and k + 0.5 values round half to even)."""
    x = torch.randn(m, k, generator=g, device="cuda") * 3
    x[0] = 0
    if m > 1:
        ties = torch.tensor([127.0, 0.5, 1.5, -2.5, 125.5], device="cuda")
        x[1] = ties.repeat(-(-k // 5))[:k]
    return x.to(dtype)


# rows past the short-row kernel's 8,192 bf16 (4,096 f32) a row, by input
# dtype: Llama-3.1-8B's down (K 14,336) on the long-row kernel in
# registers, a K past what a cluster of 8 blocks holds in registers
# (32,784 pieces: streamed and read twice), and a K that is no whole
# number of 16-byte pieces (the scalar kernel)
LONG_ROWS = {torch.bfloat16: (14_336, 262_272, 14_338),
             torch.float32: (14_336, 131_136, 14_338)}


def _hold_long_rows(g, m):
    """`quantize_rows` at every LONG_ROWS K and on an x one element off a
    16-byte boundary at K 14,336 (the scalar kernel) against its plain
    version, with its launches and long-row launches; the wgmma GEMM on
    its output at K 14,336."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    for dtype, ks in LONG_ROWS.items():
        for k in ks + (None,):
            if k is None:  # x off 16 bytes at K 14,336
                k = 14_336
                flat = (torch.randn(m * k + 1, generator=g, device="cuda") * 3).to(dtype)
                x = flat[1:].view(m, k)
                assert x.data_ptr() % 16
                path = w8a8._Q_SCALAR
            else:
                x = _w8a8_rows(g, m, k, dtype)
                path = {14_336: w8a8._Q_LONG, 14_338: w8a8._Q_SCALAR}.get(
                    k, w8a8._Q_STREAMED)
            plan = w8a8._quant_plan(m, k, w8a8._IN_KINDS[dtype], w8a8._sms(0),
                                    x.data_ptr() % 16 == 0)
            assert plan[0] == path, (m, k, dtype, plan)
            before = (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches)
            q, s = w8a8.quantize_rows(x)
            pq, ps = w8a8.quantize_rows_plain(x)
            torch.cuda.synchronize()
            assert (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches) == (
                before[0] + 1, before[1] + int(path >= w8a8._Q_LONG))
            assert torch.equal(q, pq) and torch.equal(s, ps), (m, k, dtype, plan)
            if k == 14_336 and path == w8a8._Q_LONG:
                wq = torch.randint(-127, 128, (128, k), generator=g, device="cuda",
                                   dtype=torch.int8)
                ws = torch.rand(128, generator=g, device="cuda") * 1e-3
                bias = (torch.randn(128, generator=g, device="cuda") * 0.1).to(dtype)
                for b in (None, bias):
                    got = w8a8.w8a8_gemm(q, s, wq, ws, b, out_dtype=dtype)
                    want = w8a8.w8a8_gemm_plain(pq, ps, wq, ws, b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), ("wgmma", m, k, dtype, b is None)
            del x, q, s, pq, ps
    torch.cuda.empty_cache()


# M in {1, 5, 8, 17, 32, 33, 64, 65, 72, 288, 300, 4096} (M_STAR is 16): one
# m tile of 8 rows, tiles of 16 to 64 rows and several of them (the
# small-row kernel), one to three 128-row tiles and prefill's 32 (wgmma); N
# in {2, 3} (the classifiers' few labels: tails in N), 128 and 4,864; K 36
# (4-byte copies, a ragged 64-byte K block; no wgmma), 896 and 4,864; bf16
# and f32 in and out, with and without a bias; then `quantize_rows` at the
# long rows of LONG_ROWS (`_hold_long_rows`). Each kernel is called
# directly, whatever the route would pick.
@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 8, 17, 32, 33, 64, 65, 72, 288, 300, 4096])
def test_w8a8_kernels_match_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(m)
    for k in (36, 896, 4864):
        for dtype in (torch.bfloat16, torch.float32):
            x = _w8a8_rows(g, m, k, dtype)
            before = w8a8.quantize_rows.launches
            q, s = w8a8.quantize_rows(x)
            pq, ps = w8a8.quantize_rows_plain(x)
            torch.cuda.synchronize()
            assert w8a8.quantize_rows.launches == before + 1
            assert torch.equal(q, pq) and torch.equal(s, ps), (m, k, dtype)
            for n in (2, 3, 128, 4864):
                wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                                   dtype=torch.int8)
                ws = torch.rand(n, generator=g, device="cuda") * 1e-2
                bias = (torch.randn(n, generator=g, device="cuda") * 0.1).to(dtype)
                for b in (None, bias):
                    want = w8a8.w8a8_gemm_plain(pq, ps, wq, ws, b, out_dtype=dtype)
                    before = w8a8.w8a8_qgemm.launches
                    (got,) = w8a8.w8a8_qgemm(x, [(wq, ws)], [b], out_dtype=dtype)
                    torch.cuda.synchronize()
                    assert w8a8.w8a8_qgemm.launches == before + 1
                    assert torch.equal(got, want), ("qgemm", m, n, k, dtype, b is None)
                    if k % 16:
                        continue
                    before = w8a8.w8a8_gemm.launches
                    got = w8a8.w8a8_gemm(q, s, wq, ws, b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    assert w8a8.w8a8_gemm.launches == before + 1
                    assert torch.equal(got, want), ("wgmma", m, n, k, dtype, b is None)
    _hold_long_rows(g, m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 32, 33, 64, 300])
def test_w8a8_groups_match_plain_on_card(m):
    """Groups of 1-3 weights over one x, with mixed biases, through the
    route (`w8a8_dense`) and through the small-row kernel: each output
    equals the plain version; the small-row kernel launches once a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(100 + m)
    for k, ns in ((896, (896, 128, 128)), (896, (4864, 4864)), (768, (5,)),
                  (4864, (896,)), (64, (3, 200, 17))):
        x = _w8a8_rows(g, m, k, torch.bfloat16)
        weights = [(torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                                  dtype=torch.int8),
                    torch.rand(n, generator=g, device="cuda") * 1e-2) for n in ns]
        biases = [None if i % 2 else torch.randn(n, generator=g, device="cuda")
                  .to(torch.bfloat16) for i, n in enumerate(ns)]
        want = w8a8.w8a8_dense_plain(x, weights, biases, out_dtype=torch.bfloat16)
        before = w8a8.w8a8_qgemm.launches
        got = w8a8.w8a8_qgemm(x, weights, biases, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert w8a8.w8a8_qgemm.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (m, k, ns)
        got = w8a8.w8a8_dense(x, weights, biases, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), ("dense", m, k, ns)


@pytest.mark.cuda
def test_w8a8_gemm_exact_sums_and_unaligned_bases_on_card():
    """Sums far past 2^24 (every product 127^2 at K = 4,864) stay exact s32
    on both routes; a weight 4 bytes off a 16-byte boundary takes the small
    kernel's 4-byte copies (and `w8a8_dense` routes it there at any M), an
    x off its 4-element boundary is copied first; the tied head's shape
    (N = 151,936, f32 out) at B = 8 and at the verify round's 72 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    n, k = 96, 4864
    wq = torch.full((n, k), 127, dtype=torch.int8, device="cuda")
    ones_n = torch.ones(n, device="cuda")
    for m in (8, 130):
        x = torch.full((m, k), 127.0, device="cuda")  # scale 1: q = x
        x[1::2] = -127.0
        want = torch.full((m, n), 127.0 * 127 * k, device="cuda")
        want[1::2] *= -1
        (got,) = w8a8.w8a8_qgemm(x, [(wq, ones_n)], out_dtype=torch.float32)
        xq, xs = w8a8.quantize_rows(x)
        got2 = w8a8.w8a8_gemm(xq, xs, wq, ones_n, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got2, want)
    g = torch.Generator(device="cuda").manual_seed(3)
    buf = torch.randint(-127, 128, (64 * 896 + 4,), generator=g, device="cuda",
                        dtype=torch.int8)
    w_off = buf[4:].view(64, 896)
    assert w_off.data_ptr() % 16 == 4
    ws = torch.rand(64, generator=g, device="cuda") * 1e-3
    xbuf = torch.randn(300 * 896 + 2, generator=g, device="cuda").to(torch.bfloat16)
    x_off = xbuf[2:].view(300, 896)
    assert x_off.data_ptr() % 8 == 4
    before = (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches)
    for x in (x_off, x_off[:8]):
        want = w8a8.w8a8_dense_plain(x, [(w_off, ws)], out_dtype=torch.bfloat16)[0]
        got = w8a8.w8a8_dense(x, [(w_off, ws)], out_dtype=torch.bfloat16)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches) == (before[0] + 2, before[1])
    wq = torch.randint(-127, 128, (151_936, 896), generator=g, device="cuda",
                       dtype=torch.int8)
    ws = torch.rand(151_936, generator=g, device="cuda") * 1e-3
    for m in (8, 72):
        x = torch.randn(m, 896, generator=g, device="cuda").to(torch.bfloat16)
        want = w8a8.w8a8_dense_plain(x, [(wq, ws)], out_dtype=torch.float32)[0]
        got = w8a8.w8a8_dense(x, [(wq, ws)], out_dtype=torch.float32)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want), m
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8.w8a8_gemm(torch.zeros((8, 36), dtype=torch.int8, device="cuda"),
                       torch.ones(8, device="cuda"), wq[:4, :36].contiguous(),
                       ws[:4].contiguous(), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        w8a8.w8a8_qgemm(torch.zeros((8, 30), device="cuda"),
                        [(wq[:4, :30].contiguous(), ws[:4].contiguous())],
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        w8a8.quantize_rows(torch.zeros(4, 64, device="cuda").t())


def _near_ties(g, m, k, device):
    """Rows whose every x / s lies within a few ulps of a half-integer (and
    some exactly on one): each row's abs-max is 127 s for an awkward s, the
    others (j + 0.5) s nudged by a relative 0, +-2^-23 or +-2^-22."""
    s = torch.rand(m, 1, generator=g, device=device) * 10 + 1e-3
    j = torch.randint(-127, 127, (m, k), generator=g, device=device).float()
    nudge = torch.tensor([0.0, 2.0**-23, -(2.0**-23), 2.0**-22, -(2.0**-22)], device=device)
    pick = torch.randint(0, 5, (m, k), generator=g, device=device)
    x = (j + 0.5) * s * (1 + nudge[pick])
    x[:, 0] = 127 * s[:, 0]
    return x


@pytest.mark.cuda
def test_w8a8_quantize_near_ties_on_card():
    """x / s near and on half-integers: the quantizing kernels (the
    activation quantize on each of its kernels, and the small-row kernel's
    prologue where it holds the rows) round as the IEEE quotient does, bit
    for bit with the plain version: short rows; Llama-3.1-8B's down (K
    14,336) at 1 to 4,096 rows, in registers over 1 to 8 blocks a row; a
    row streamed twice; a ragged K on the scalar kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(11)
    for m, k in ((8, 896), (300, 4864), (64, 36), (1, 14_336), (32, 14_336), (72, 14_336),
                 (288, 14_336), (4096, 14_336), (32, 262_272), (72, 14_338)):
        x = _near_ties(g, m, k, "cuda")
        pq, ps = w8a8.quantize_rows_plain(x)
        assert ((x / ps[:, None] - pq.float()).abs() > 0.49).float().mean() > 0.5
        q, s = w8a8.quantize_rows(x)
        torch.cuda.synchronize()
        assert torch.equal(q, pq) and torch.equal(s, ps), (m, k)
        if k % 4 or w8a8._qgemm_rows(m, k) is None:
            continue
        n = min(k, 128)  # the first n columns of x, each once
        w = torch.zeros(n, k, device="cuda", dtype=torch.int8)
        w[torch.arange(n), torch.arange(n)] = 1
        ones = torch.ones(n, device="cuda")
        (got,) = w8a8.w8a8_qgemm(x, [(w, ones)], out_dtype=torch.float32)
        want = w8a8.w8a8_gemm_plain(pq, ps, w, ones, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k)


# every plan the long-row kernel takes at Llama-3.1-8B's down (K 14,336),
# beside the one `_quant_plan` picks: the row in registers over 1, 2, 4 and
# 8 blocks (the fewest warps that hold a block's slice), and streamed over 1
# block of 1 warp, 2 of 4 and 8 of 32
def _quant_plans(m, k, dtype):
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    pieces = k * dtype.itemsize // 16
    plans = [w8a8._quant_plan(m, k, w8a8._IN_KINDS[dtype], w8a8._sms(0))]
    plans += [(w8a8._Q_LONG, -(-pieces // (c * 128)), c) for c in (1, 2, 4, 8)]
    plans += [(w8a8._Q_STREAMED, w, c) for w, c in ((1, 1), (4, 2), (32, 8))]
    return list(dict.fromkeys(plans))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 32, 72, 288, 4096])
def test_w8a8_quantize_plans_match_plain_on_card(m, monkeypatch):
    """`quantize_rows` on each plan of the long-row kernel (blocks of a
    cluster meeting in distributed shared memory, the row streamed twice)
    equals its plain version bit for bit, bf16 and f32, and counts one
    long-row launch; the entry refuses a plan its kernel cannot run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(700 + m)
    k = 14_336
    for dtype in (torch.bfloat16, torch.float32):
        x = _w8a8_rows(g, m, k, dtype)
        pq, ps = w8a8.quantize_rows_plain(x)
        for plan in _quant_plans(m, k, dtype):
            monkeypatch.setattr(w8a8, "_quant_plan", lambda *a, plan=plan: plan)
            before = w8a8.quantize_rows.long_row_launches
            q, s = w8a8.quantize_rows(x)
            torch.cuda.synchronize()
            assert w8a8.quantize_rows.long_row_launches == before + 1
            assert torch.equal(q, pq) and torch.equal(s, ps), (m, dtype, plan)
        # a row too long for the plan's registers, or for the short-row kernel
        for plan in ((w8a8._Q_LONG, 1, 1), (w8a8._Q_SHORT, 8, 1), (w8a8._Q_LONG, 4, 16)):
            monkeypatch.setattr(w8a8, "_quant_plan", lambda *a, plan=plan: plan)
            with pytest.raises(RuntimeError, match="ragtorch_w8a8_quantize_rows"):
                w8a8.quantize_rows(x)
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 72, 288])
def test_w8a8_long_rows_replay_in_a_graph_on_card(m):
    """Llama-3.1-8B's down (K 14,336: `quantize_rows` on the long-row
    kernel, one block a row at 32 and 72 rows, two at 288, then the wgmma
    GEMM)
    captured in a CUDA graph and replayed over new rows, bf16 and f32: the
    plain version's outputs each time; the capture counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(900 + m)
    k = 14_336
    xs = {dtype: torch.randn(m, k, generator=g, device="cuda").to(dtype)
          for dtype in (torch.bfloat16, torch.float32)}
    weights = [(torch.randint(-127, 128, (4096, k), generator=g, device="cuda",
                              dtype=torch.int8),
                torch.rand(4096, generator=g, device="cuda") * 1e-3)]

    def run():
        return [w8a8.w8a8_dense(x, weights, out_dtype=dtype)[0] for dtype, x in xs.items()]

    run()  # warm up: the library
    torch.cuda.synchronize()
    counts = (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches,
              w8a8.w8a8_gemm.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = run()
    assert (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches,
            w8a8.w8a8_gemm.launches) == counts
    for seed in (1, 2):
        for x in xs.values():
            x.copy_(torch.randn(x.shape, generator=g, device="cuda") * seed)
        graph.replay()
        want = [w8a8.w8a8_dense_plain(x, weights, out_dtype=dtype)[0]
                for dtype, x in xs.items()]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ys, want)), seed


# the streaming small-row kernel's shapes on every cluster size its plan
# takes (K split over 1, 2 or 8 blocks, the partial sums reduced into each
# tile's owner): Llama-3.1-8B's decode products at B 1 and 8, its engine's
# 17 and 32 rows, its down (K 14,336), Qwen2.5-0.5B's tied head at 32 rows
# (a ring of one stage), and, forced onto it, the 0.5B's q/k/v group with
# biases and a classifier (the short-K kernel's shapes), a ragged K of
# 4-byte copies; and the s32 kind at Qwen2.5-0.5B's tp = 2 row shards (8 x
# 448, 8 x 2,432, 72 x 2,432)
_SMALL_CLUSTER_SHAPES = [
    (1, 4096, (4096, 1024, 1024)), (8, 4096, (4096,)), (8, 14336, (4096,)),
    (17, 4096, (4096,)), (32, 4096, (14336,)), (32, 896, (151936,)),
    (8, 896, (896, 128, 128)), (8, 768, (5,)), (5, 36, (130,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,ns", _SMALL_CLUSTER_SHAPES)
def test_w8a8_small_rows_every_cluster_on_card(m, k, ns, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(m * 31 + k)
    x = _w8a8_rows(g, m, k, torch.bfloat16)
    weights = [(torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                              dtype=torch.int8),
                torch.rand(n, generator=g, device="cuda") * 1e-2) for n in ns]
    biases = [(torch.randn(n, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
              if i == 0 else None for i, n in enumerate(ns)]
    want = w8a8.w8a8_dense_plain(x, weights, biases, out_dtype=torch.bfloat16)
    pick = w8a8._qgemm_plan
    monkeypatch.setattr(w8a8, "_qgemm_short", lambda k, ns: False)
    ran = 0
    for c in (1, 2, 8):
        try:
            plan = pick(m, k, ns, w8a8._sms(0), cluster=c)
        except ValueError:  # a wave of them leaves no room for a ring (the head)
            continue
        ran += 1
        monkeypatch.setattr(w8a8, "_qgemm_plan", lambda *a, plan=plan: plan)
        got = w8a8.w8a8_qgemm(x, weights, biases, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (m, k, ns, plan)
    assert ran == (1 if ns == (151936,) else 3)  # the head at 32 rows plans on pairs alone


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(8, 448), (8, 2432), (72, 2432)])
def test_w8a8_small_rows_s32_at_tp_shapes_on_card(m, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(m + k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (896, k), generator=g, device="cuda", dtype=torch.int8)
    got = w8a8._qgemm_launch(xq, [(wq, None)], [None], torch.int32)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, w8a8.w8a8_acc_plain(xq, wq))


@pytest.mark.cuda
def test_w8a8_small_kernel_on_two_streams_on_card():
    """Two streams run the small-row kernels at once (the streaming one at
    K 4,864, the short-K one at K 896), many times over: no state is shared
    between launches, so each stream's outputs equal its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(9)
    jobs = []
    for k, n in ((4864, 896), (896, 4864)):
        x = torch.randn(8, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                           dtype=torch.int8), torch.rand(n, generator=g, device="cuda"))
        jobs.append((x, w, w8a8.w8a8_dense_plain(x, [w], out_dtype=torch.bfloat16)[0]))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for s, (x, w, _), o in zip(streams, jobs, outs):
            with torch.cuda.stream(s):
                o.append(w8a8.w8a8_qgemm(x, [w], out_dtype=torch.bfloat16)[0])
    torch.cuda.synchronize()
    for (_, _, want), o in zip(jobs, outs):
        assert all(torch.equal(y, want) for y in o)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 130])
def test_w8a8_routes_replay_in_a_graph_on_card(m):
    """`w8a8_dense` captured in a CUDA graph (the small-row route at 8 rows,
    quantize_rows + wgmma at 130) and replayed over new x: the plain
    version's outputs; the capture counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, 896, generator=g, device="cuda").to(torch.bfloat16)
    weights = [(torch.randint(-127, 128, (n, 896), generator=g, device="cuda",
                              dtype=torch.int8),
                torch.rand(n, generator=g, device="cuda") * 1e-2) for n in (896, 128)]
    w8a8.w8a8_dense(x, weights, out_dtype=torch.bfloat16)  # warm up: the library
    torch.cuda.synchronize()
    counts = (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
              w8a8.quantize_rows.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = w8a8.w8a8_dense(x, weights, out_dtype=torch.bfloat16)
    assert (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
            w8a8.quantize_rows.launches) == counts
    for seed in (1, 2):
        x.copy_(torch.randn(m, 896, generator=g, device="cuda").to(torch.bfloat16) * seed)
        graph.replay()
        want = w8a8.w8a8_dense_plain(x, weights, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ys, want)), seed


@pytest.mark.cuda
def test_w8a8_plan_smem_matches_the_library_on_card():
    """The wrapper's shared-memory arithmetic (which picks the m tile, the
    unit and the ring's depth) is the kernel's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import _kernels, w8a8

    lib = _kernels.load_library()
    for mt in (8, 16, 32, 48, 64):
        for k in (4, 36, 64, 768, 896, 4864, 14336):
            assert lib.ragtorch_w8a8_qshort_smem(mt, k) == w8a8._qshort_smem(mt, k)
            for cluster, slots, kc, depth in ((1, 1, 128, 2), (2, 122, 512, 2),
                                              (2, 3, 256, 8), (8, 14, 128, 1)):
                assert lib.ragtorch_w8a8_qgemm_smem(mt, k, cluster, slots, kc, depth) == \
                    w8a8._qgemm_smem(mt, k, slots, kc, depth, cluster)


def _wgmma_group(g, k, ns, dtype):
    """1-3 int8 weights [N, K] with scales, a bias on the first only."""
    weights = [(torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                              dtype=torch.int8),
                torch.rand(n, generator=g, device="cuda") * 1e-2) for n in ns]
    biases = [(torch.randn(n, generator=g, device="cuda") * 0.1).to(dtype) if i == 0
              else None for i, n in enumerate(ns)]
    return weights, biases


def _wgmma_plans(m, k, ns):
    """The plan `_gemm_plan` gives on 132 SMs, then the others the kernel
    takes (bm, bn, split, share, band, deep): 64- and 128-row tiles by 128
    columns over all of K, in bands of 3 column tiles too; 64 x 64 tiles unsplit; K split 2, 3 and over every
    128-byte chunk (at most 8 blocks) on 64 x 64 tiles and on 128 weight
    rows by 32, 64, 80 or 128 token rows (the swapped product); and the
    weight tile shared by 2, 3 and 4 row tiles' blocks (rows past M in the
    last group where M has fewer tiles), two blocks an SM or one, in bands
    of 3 too."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    chunks = -(-k // 128)
    wide = sum(-(-n // 128) for n in ns)
    narrow = sum(-(-n // 64) for n in ns)
    splits = [s for s in (2, 3, min(8, chunks)) if 1 < s <= chunks]
    plans = [tuple(w8a8._gemm_plan(m, k, ns, 132)[:6])]
    plans += [(64, 128, 1, 1, wide, False), (128, 128, 1, 1, wide, False),
              (128, 128, 1, 1, 3, False), (64, 64, 1, 1, narrow, False)]
    plans += [(64, 64, s, 1, narrow, False) for s in splits]
    plans += [(bm, 128, s, 1, wide, True) for bm in (32, 64, 80, 128) for s in splits]
    plans += [(128, 128, 1, 2, wide, False), (128, 128, 1, 3, wide, True),
              (128, 128, 1, 2, 3, True), (128, 128, 1, 4, 3, False)]
    return list(dict.fromkeys(plans))


# M in {33, 64, 65, 72, 128, 129, 288, 300}: one row tile of 64 rows (one
# consumer warpgroup), one or several of 128 with 1 to 64 rows live in the
# last; N 3 and 130 (tails in a 64- and a 128-column tile) and 896; K 48 (one
# chunk, mostly past K), 912 (a 16-byte tail chunk) and 4,864; groups of 1 to
# 3 weights; f32, bf16 and s32 out; every plan the kernel takes.
@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 64, 65, 72, 128, 129, 288, 300])
def test_w8a8_wgmma_plans_match_plain_on_card(m, monkeypatch):
    """The wgmma GEMM on each launch plan (split K through a cluster's
    shared memory, a weight tile shared by a cluster's row tiles, bands of
    column tiles, narrow tiles, one launch a group) equals its plain
    version bit for bit, and counts one launch a group (a few-tile one
    where the plan is one for few rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(500 + m)
    for k, ns in ((48, (130,)), (912, (896, 3)), (4864, (896,)), (912, (896, 128, 130))):
        xq, xs = w8a8.quantize_rows(_w8a8_rows(g, m, k, torch.float32))
        for dtype in (torch.bfloat16, torch.float32, torch.int32):
            weights, biases = _wgmma_group(g, k, ns, torch.float32 if dtype == torch.int32
                                           else dtype)
            if dtype == torch.int32:
                weights, biases = [(wq, None) for wq, _ in weights], [None] * len(ns)
                want = [w8a8.w8a8_acc_plain(xq, wq) for wq, _ in weights]
                scales = None
            else:
                want = [w8a8.w8a8_gemm_plain(xq, xs, wq, ws, b, out_dtype=dtype)
                        for (wq, ws), b in zip(weights, biases)]
                scales = xs
            for plan in _wgmma_plans(m, k, ns):
                monkeypatch.setattr(w8a8, "_gemm_plan",
                                    lambda *a, plan=plan: (*plan, 0))
                fn = w8a8.w8a8_gemm_s32 if dtype == torch.int32 else w8a8.w8a8_gemm
                before = (fn.launches, fn.few_tile_launches)
                got = w8a8._gemm_launch(xq, scales, weights, biases, dtype)
                torch.cuda.synchronize()
                assert (fn.launches, fn.few_tile_launches) == (
                    before[0] + 1, before[1] + int(w8a8._few_rows(plan)))
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    m, k, ns, dtype, plan)
            monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [72, 288])
def test_w8a8_wgmma_plans_replay_in_a_graph_on_card(m):
    """The verify round's and the engine's groups (q/k/v, gate/up, down,
    and down's s32 kind at tp = 2) on the plan `_gemm_plan` gives, captured
    in one CUDA graph and replayed over new rows: the plain version's
    outputs each time (the split's partials live in shared memory only, so
    a replay needs nothing reset); the capture counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    g = torch.Generator(device="cuda").manual_seed(m)
    xs_in = {k: torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
             for k in (896, 4864)}
    groups = [(896, _wgmma_group(g, 896, (896, 128, 128), torch.bfloat16)),
              (896, _wgmma_group(g, 896, (4864, 4864), torch.bfloat16)),
              (4864, _wgmma_group(g, 4864, (896,), torch.bfloat16))]
    wq_tp = torch.randint(-127, 128, (896, 2432), generator=g, device="cuda",
                          dtype=torch.int8)
    xq_tp = torch.empty((m, 2432), dtype=torch.int8, device="cuda")

    def run():
        outs = [w8a8.w8a8_dense(xs_in[k], ws, bs, out_dtype=torch.bfloat16)
                for k, (ws, bs) in groups]
        return outs + [[w8a8.w8a8_gemm_s32(xq_tp, wq_tp)]]

    run()  # warm up: the library
    torch.cuda.synchronize()
    counts = (w8a8.quantize_rows.launches, w8a8.w8a8_gemm.launches,
              w8a8.w8a8_gemm_s32.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = run()
    assert (w8a8.quantize_rows.launches, w8a8.w8a8_gemm.launches,
            w8a8.w8a8_gemm_s32.launches) == counts
    for seed in (1, 2, 3):
        for x in xs_in.values():
            x.copy_(torch.randn(x.shape, generator=g, device="cuda").to(torch.bfloat16)
                    * seed)
        xq_tp.copy_(torch.randint(-127, 128, xq_tp.shape, generator=g, device="cuda",
                                  dtype=torch.int8))
        graph.replay()
        want = [w8a8.w8a8_dense_plain(xs_in[k], ws, bs, out_dtype=torch.bfloat16)
                for k, (ws, bs) in groups] + [[w8a8.w8a8_acc_plain(xq_tp, wq_tp)]]
        torch.cuda.synchronize()
        for got, exp in zip(ys, want):
            assert all(torch.equal(a, b) for a, b in zip(got, exp)), seed


# kernel against plain version on the card: both sum q.k and p.v in f32 in
# another order, which moves a score by ~1e-7 of its size; in bf16 and f16
# that can round a p to its neighbour before p.v and flip the output's last
# bit, so the bound is one ulp of the output (rtol) plus a little (atol)
FLASH_TOL = {
    torch.bfloat16: dict(atol=1e-3, rtol=2**-7),
    torch.float16: dict(atol=2.5e-4, rtol=2**-10),
    torch.float32: dict(atol=1e-5, rtol=1e-5),
}


def _flash_masks(b, t, device="cuda"):
    """Rows cycling through the four mask kinds: every token valid, the
    first 70%, one token, none."""
    valid = torch.tensor([t, int(0.7 * t), 1, 0] * (b // 4 + 1), device=device)[:b]
    return (torch.arange(t, device=device)[None, :] < valid[:, None]).int()


def _flash_inputs(seed, b, t, h, dh, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, h, dh), generator=g, device="cuda").to(dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("t", [128, 256, 1024, 2048])
def test_flash_kernel_matches_plain_on_card(t, dh, dtype):
    """The encoder flash kernel against its plain version at bge-base's
    width (H * Dh = 768) over the four mask kinds; T 128 and 256 are one
    and two key blocks (the TMA ring's first uses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    q, k, v = _flash_inputs(t + dh, 4, t, 768 // dh, dh, dtype)
    seg = _flash_masks(4, t)
    before = fa.flash_encoder_attention.launches
    out = fa.flash_encoder_attention(q, k, v, seg, seg)
    ref = fa.flash_encoder_attention_plain(q, k, v, seg, seg)
    torch.cuda.synchronize()
    assert fa.flash_encoder_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_strided_heads_on_card():
    """q, k, v as views of one fused [B, T, 3, H, Dh] projection, and int64
    segment ids: the kernel reads the strides, no copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    (qkv,) = _flash_inputs(7, 3 * 2, 1024, 6, 128, torch.bfloat16)[:1]
    qkv = qkv.view(2, 3, 1024, 6, 128).transpose(1, 2)  # [B, T, 3, H, Dh]
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    seg = _flash_masks(2, 1024).long()
    out = fa.flash_encoder_attention(q, k, v, seg, seg)
    ref = fa.flash_encoder_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), seg, seg)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_kernel_places_each_key_on_card(dh, dtype):
    """q = k = 0, so every key of a row's segment weighs alike, and v one-hot
    by key: out[b, i, h, d] is the mean over the row's segment of the keys j
    with j % Dh == d, weighted 1 + j // Dh + h. A key or a column landing
    in the wrong place shows as a wrong entry, not as a small error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    b, t, h = 4, 512, 768 // dh
    keys = torch.arange(t, device="cuda")
    weight = (1 + keys // dh)[:, None] + torch.arange(h, device="cuda")[None, :]  # [T, H]
    onehot = torch.nn.functional.one_hot(keys % dh, dh).float()  # [T, Dh]
    v = (weight[:, :, None] * onehot[:, None, :]).expand(b, t, h, dh).to(dtype).contiguous()
    q = torch.zeros((b, t, h, dh), dtype=dtype, device="cuda")
    seg = _flash_masks(b, t)
    out = fa.flash_encoder_attention(q, q, v, seg, seg)
    same = (seg[:, :, None] == seg[:, None, :]).double()  # [B, Tq, Tk]
    want = torch.einsum("bqk,bkhd->bqhd", same / same.sum(-1, keepdim=True), v.double())
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), want, atol=1e-2, rtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_kernel_is_deterministic_on_card(dtype):
    """Two calls on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    for dh in (64, 128, 256):
        q, k, v = _flash_inputs(dh, 4, 1024, 768 // dh, dh, dtype)
        seg = _flash_masks(4, 1024)
        first = fa.flash_encoder_attention(q, k, v, seg, seg)
        second = fa.flash_encoder_attention(q, k, v, seg, seg)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_kernel_f32_extreme_magnitudes_on_card(t, dh):
    """f32 token rows of magnitude 1e30 and 1e-30 in q (a one-hot p, a flat
    one), k (keys that score ~0) and v (1e-30, and 1e30 rows of one sign so
    that the outputs they lead sum without cancelling): the kernel's bf16
    parts keep f32's exponent range, and no product overflows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    q, k, v = _flash_inputs(t * dh + 1, 4, t, 768 // dh, dh, torch.float32)
    tok = torch.arange(t, device="cuda")[None, :, None, None]
    q = q * torch.where(tok % 7 == 1, 1e30, torch.where(tok % 7 == 2, 1e-30, 1.0))
    k = k * torch.where(tok % 5 == 3, 1e-30, 1.0)
    v = torch.where(tok % 3 == 1, v.abs() * 1e30, torch.where(tok % 3 == 2, v * 1e-30, v))
    seg = _flash_masks(4, t)
    out = fa.flash_encoder_attention(q, k, v, seg, seg)
    ref = fa.flash_encoder_attention_plain(q, k, v, seg, seg)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and ref.abs().max() > 1e29
    torch.testing.assert_close(out, ref, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_kernel_reads_any_stride_order_on_card(dh):
    """Views whose strides a 4-D tensor map must carry in another order:
    q from [B, H, T, Dh] (heads apart by more than rows), k from [T, B, H,
    Dh] (batch rows closest), v with padded head rows, B 1 for a dimension
    of one; and segment ids off 16 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    t, h = 1024, 768 // dh
    for b in (3, 1):
        g = torch.Generator(device="cuda").manual_seed(dh + b)
        q = torch.randn((b, h, t, dh), generator=g, device="cuda").bfloat16().transpose(1, 2)
        k = torch.randn((t, b, h, dh), generator=g, device="cuda").bfloat16().permute(1, 0, 2, 3)
        v = torch.randn((b, t, h, dh + 8), generator=g, device="cuda").bfloat16()[..., :dh]
        ids = torch.zeros(b * t + 1, dtype=torch.int32, device="cuda")
        seg = ids[1:].view(b, t)  # 4 bytes off the allocation
        seg.copy_(_flash_masks(4, t)[:b])
        assert seg.data_ptr() % 16
        out = fa.flash_encoder_attention(q, k, v, seg, seg)
        ref = fa.flash_encoder_attention_plain(
            q.contiguous(), k.contiguous(), v.contiguous(), seg, seg)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("t,dh,flash", [
    (1024, 64, True), (2048, 128, True), (1024, 256, True), (1152, 64, True),
    (896, 64, False), (1000, 64, False), (1152, 96, False), (2048, 32, False),
])
def test_encoder_attention_takes_flash_at_the_gate_on_card(t, dh, flash):
    """On CUDA tensors `encoder_attention` launches the kernel exactly once
    where the reference's gate picks flash, with segment-id semantics, and
    never elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.models import layers as tlayers
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    q, k, v = _flash_inputs(t * dh, 4, t, 2, dh, torch.bfloat16)
    mask = _flash_masks(4, t)
    before = fa.flash_encoder_attention.launches
    out = tlayers.encoder_attention(q, k, v, mask)
    if flash:
        want = fa.flash_encoder_attention_plain(q, k, v, mask, mask)
    else:
        want = tlayers.attention(q, k, v, tlayers.make_padding_mask(mask))
    torch.cuda.synchronize()
    assert fa.flash_encoder_attention.launches == before + int(flash)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernel_raises_and_never_falls_back_on_card(monkeypatch):
    """A refused launch and a failed build raise; the wrapper never returns
    the plain version's answer for CUDA tensors; it refuses what the kernel
    cannot take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    q, k, v = _flash_inputs(3, 2, 1024, 2, 64, torch.bfloat16)
    seg = _flash_masks(2, 1024)
    fa.flash_encoder_attention(q, k, v, seg, seg)  # the library is built
    before = fa.flash_encoder_attention.launches
    with monkeypatch.context() as m:  # a dtype code the entry point refuses
        m.setattr(fa, "_KINDS", {**fa._KINDS, torch.bfloat16: 7})
        with pytest.raises(RuntimeError, match="ragtorch_flash_attention launch failed"):
            fa.flash_encoder_attention(q, k, v, seg, seg)

    def no_build():
        raise RuntimeError("nvcc failed")

    with monkeypatch.context() as m:
        m.setattr(_kernels, "_lib", None)
        m.setattr(_kernels, "load_library", no_build)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fa.flash_encoder_attention(q, k, v, seg, seg)
    assert fa.flash_encoder_attention.launches == before
    with pytest.raises(ValueError, match="multiple of the 128"):
        fa.flash_encoder_attention(q[:, :1000], k[:, :1000], v[:, :1000],
                                   seg[:, :1000], seg[:, :1000])
    with pytest.raises(ValueError, match="head width"):
        fa.flash_encoder_attention(q[..., :32], k[..., :32], v[..., :32], seg, seg)
    with pytest.raises(TypeError):
        fa.flash_encoder_attention(q, k.float(), v, seg, seg)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_encoder_attention(q, k, v.cpu(), seg, seg)
    with pytest.raises(ValueError, match="16-byte"):
        odd = torch.empty((2, 1024, 2, 72), dtype=torch.bfloat16, device="cuda")[..., 4:68]
        fa.flash_encoder_attention(odd, k, v, seg, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t", [1024, 2048, 4096])
def test_long_encoder_runs_through_flash_on_card(monkeypatch, t, quantized):
    """`bert_embed` and `bert_classify` at bge-base width (random bf16
    weights, and their W8A8 tree) with `max_positions` T: 12 kernel
    launches a forward, and the same answers as the forward whose
    attention runs the plain version. Last-bit differences of the
    attention pass through 12 post-LN layers in bf16, hence a cosine for
    the unit-norm embeddings and an absolute bound for the logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    from rag_inference_pipeline_tpu_torch.models import bert as tbert
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    cfg = tbert.BertConfig(max_positions=t, num_labels=5)
    g = torch.Generator(device="cuda").manual_seed(t)
    params = tbert.init_bert_params(cfg, generator=g, dtype=torch.bfloat16, device="cuda")
    if quantized:
        params = tbert.quantize_bert_params(params)
    mask = _flash_masks(2, t)
    ids = torch.randint(1, cfg.vocab_size, (2, t), generator=g, device="cuda") * mask
    with torch.inference_mode():
        before = fa.flash_encoder_attention.launches
        emb = tbert.bert_embed(params, cfg, ids, mask)
        logits = tbert.bert_classify(params, cfg, ids, mask)
        torch.cuda.synchronize()
        assert fa.flash_encoder_attention.launches == before + 2 * cfg.layers
        monkeypatch.setattr(tbert, "encoder_attention",
                            lambda q, k, v, m: fa.flash_encoder_attention_plain(q, k, v, m, m))
        ref_emb = tbert.bert_embed(params, cfg, ids, mask)
        ref_logits = tbert.bert_classify(params, cfg, ids, mask)
    assert emb.shape == (2, cfg.hidden) and logits.shape == (2, 5)
    assert torch.isfinite(emb).all() and torch.isfinite(logits).all()
    assert torch.nn.functional.cosine_similarity(emb, ref_emb, dim=-1).min() >= 0.999
    torch.testing.assert_close(logits, ref_logits, atol=0.1, rtol=0)
