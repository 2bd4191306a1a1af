"""The f32 encoder flash kernel's arithmetic, emulated on the CPU.

`csrc/flash_attention.cu` runs f32 attention on bf16 tensor cores: every
f32 operand x is split into three bf16 parts, x1 = bf16(x), x2 = bf16(x -
x1), x3 = bf16(x - x1 - x2), and each product a . b is the sum of the six
products a3 b1, a2 b2, a1 b3, a2 b1, a1 b2, a1 b1, smallest first, in one
f32 accumulator. 1 / l' is folded into p before p is split, and the
accumulator is scaled by alpha l / l' before P V adds to it. The kernel
cannot run here; these tests run the same scheme in plain torch (each
bf16 x bf16 product is exact in f32, the sums f32) over the library's
128-key blocks and hold it to the card's tolerance against the plain
version (`ops/flash_attention.py`) and against the library Pallas kernel
that the JAX package calls on a TPU, in TPU interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from rag_inference_pipeline_tpu_torch.ops import flash_attention as tfa

# the card's tolerance of the f32 kernel against its plain version
# (tests/test_torch_kernels.py and chip_smoke.py FLASH_TOL)
TOL = dict(atol=1e-5, rtol=1e-5)
# (part of a, part of b), 0-based: the kernel's order, smallest first
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


@pytest.fixture(autouse=True)
def _ieee_subnormals():
    """The card keeps f32 subnormals, and so must the emulation: a library
    linked with -ffast-math that an earlier test of the same process
    loaded (the JAX package's native code: its Makefile links
    crtfastmath.o, whose constructor sets flush-to-zero and
    denormals-are-zero) would flush the third part's small values."""
    torch.set_flush_denormal(False)


def _split(x):
    """x's three bf16 parts, as f32 tensors."""
    x1 = x.bfloat16().float()
    r = x - x1
    x2 = r.bfloat16().float()
    return x1, x2, (r - x2).bfloat16().float()


def _products(a, b, acc, terms):
    """acc + a @ b as the tensor cores take it: `terms` of the parts'
    products added in turn to one f32 accumulator."""
    pa, pb = _split(a), _split(b)
    for i, k in terms:
        acc = acc + pa[i] @ pb[k]
    return acc


def _split_flash(q, k, v, seg_q, seg_kv, terms=SIX):
    """The f32 kernel's forward: `flash_encoder_attention_plain` with both
    products split and 1 / l' folded into p."""
    dh = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(dh)
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))  # [B, H, T, Dh]
    sq = seg_q[:, None, :, None]
    m = torch.full((*qh.shape[:3], 1), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(qh.shape)
    for s0 in range(0, q.shape[1], tfa.BLOCK_K):
        kb, vb = kh[:, :, s0:s0 + tfa.BLOCK_K], vh[:, :, s0:s0 + tfa.BLOCK_K]
        s = _products(qh, kb.transpose(-1, -2), 0.0, terms) * sm_scale
        same = sq == seg_kv[:, None, None, s0:s0 + tfa.BLOCK_K]
        s = s + torch.where(same, 0.0, tfa.MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = _products(p * inv, vb, acc * (l_corr * inv), terms)
        m, l = m_next, l_next
    return acc.transpose(1, 2)


def _masks(b, t):
    """Rows cycling through the four mask kinds: every token valid, the
    first 70%, one token, none."""
    valid = torch.tensor([t, int(0.7 * t), 1, 0] * (b // 4 + 1))[:b]
    return (torch.arange(t)[None, :] < valid[:, None]).int()


def _qkv(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
            for _ in range(3)]


def _extremes(q, k, v):
    """Token rows of magnitude 1e30 and 1e-30: q (scores of 1e30, a one-hot
    p; scores of 1e-30, a flat one), k (keys that score ~0) and v (1e-30,
    and 1e30 rows of one sign, so that an output they lead sums without
    cancelling and its relative error is the scheme's). No product
    overflows."""
    tok = torch.arange(q.shape[1])[None, :, None, None]
    q = q * torch.where(tok % 7 == 1, 1e30, torch.where(tok % 7 == 2, 1e-30, 1.0))
    k = k * torch.where(tok % 5 == 3, 1e-30, 1.0)
    v = torch.where(tok % 3 == 1, v.abs() * 1e30, torch.where(tok % 3 == 2, v * 1e-30, v))
    return q, k, v


def _library(q, k, v, mask):
    """The library flash attention that the JAX package's `encoder_attention`
    calls on a TPU (`models/layers.py:205-215`), in TPU interpret mode,
    waited for inside the context."""
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(
            *(jnp.asarray(x.numpy()).transpose(0, 2, 1, 3) for x in (q, k, v)),
            segment_ids=jfa.SegmentIds(q=jnp.asarray(mask.numpy()),
                                       kv=jnp.asarray(mask.numpy())),
            causal=False, sm_scale=1.0 / math.sqrt(q.shape[-1]),
        )
        return torch.from_numpy(np.array(out.transpose(0, 2, 1, 3).block_until_ready()))


@pytest.mark.parametrize("scale", [1.0, 1e30, 1e-30, 1e-36])
def test_three_parts_are_exact(scale):
    """x1 + x2 + x3 == x bit for bit, each part a bf16 value, wherever |x|
    >= 2^-110 (x's last bit within bf16's subnormals, 2^-133); below, the
    third part loses what lies under 2^-134."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    x = x * scale
    parts = _split(x)
    for part in parts:
        assert torch.equal(part.bfloat16().float(), part)
    whole = (parts[0] + parts[1]) + parts[2]
    big = x.abs() >= 2.0**-110
    assert torch.equal(whole[big], x[big])
    assert ((whole - x).abs() <= 2.0**-134).all()


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 1024])
def test_split_scheme_matches_plain(t, dh):
    """The six-term scheme against the plain version over the four mask
    kinds, within the card's f32 tolerance."""
    q, k, v = _qkv(t + dh, 4, t, 2, dh)
    seg = _masks(4, t)
    got = _split_flash(q, k, v, seg, seg)
    ref = tfa.flash_encoder_attention_plain(q, k, v, seg, seg)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_split_scheme_matches_library(dh):
    """The six-term scheme against the library kernel the reference calls,
    over the four mask kinds, within the card's f32 tolerance."""
    q, k, v = _qkv(dh, 4, 256, 1, dh)
    seg = _masks(4, 256)
    ref = _library(q, k, v, seg)
    torch.testing.assert_close(_split_flash(q, k, v, seg, seg), ref, **TOL)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_split_scheme_holds_extreme_magnitudes(dh):
    """Rows of 1e30 and 1e-30 in q, k and v: bf16 keeps f32's exponent
    range, so the parts neither overflow nor vanish and the outputs led by
    1e30 rows keep the relative tolerance."""
    q, k, v = _extremes(*_qkv(dh + 1, 4, 256, 2, dh))
    seg = _masks(4, 256)
    got = _split_flash(q, k, v, seg, seg)
    ref = tfa.flash_encoder_attention_plain(q, k, v, seg, seg)
    assert torch.isfinite(got).all() and ref.abs().max() > 1e29
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("terms,holds", [
    (((0, 0),), False),  # one bf16 part: bf16 attention
    (SIX, True),
])
def test_fewer_parts_miss_the_tolerance(terms, holds):
    """The tolerance tells the split from plain bf16 products: a1 b1 alone
    misses it, the six terms hold it, on the same inputs."""
    q, k, v = _qkv(3, 4, 256, 2, 64)
    seg = _masks(4, 256)
    got = _split_flash(q, k, v, seg, seg, terms)
    ref = tfa.flash_encoder_attention_plain(q, k, v, seg, seg)
    assert torch.allclose(got, ref, **TOL) == holds
