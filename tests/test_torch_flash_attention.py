"""Port parity of the encoder's flash branch: `ops/flash_attention.py`
against the library Pallas flash attention that the JAX package's
`encoder_attention` calls on a TPU (`models/layers.py:205-215`), run here in
TPU interpret mode; the port's gate against the reference's; and the long
encoder (`bert_encode`, `bert_embed`) through the flash branch on both
sides.

Interpret mode costs seconds a call (~4 s at B 4, H 1, T 1024), so the
shapes stay small; each call enters `force_tpu_interpret_mode` on its own
and waits for its result there.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu_torch.models import bert as tbert
from rag_inference_pipeline_tpu_torch.models import layers as tlayers
from rag_inference_pipeline_tpu_torch.models.weights import bert_params_from_jax
from rag_inference_pipeline_tpu_torch.ops import _kernels
from rag_inference_pipeline_tpu_torch.ops import flash_attention as tfa

# plain version against the library, both on the CPU. f32: the two q.k
# and p.v sums run in another order and the two exps differ in the last
# bit: within 2.4e-7 measured at |out| <= 3, so 1e-6. bf16: the same f32
# differences round a few p (0.1-0.3% of the outputs differ) to the
# neighbouring bf16 value before p.v, and the output's cast flips its last
# bit: within one bf16 ulp of the output (measured <= 2^-9 at |out| <= 3),
# so rtol 2^-7 plus a little
LIB_TOL = {
    "float32": dict(atol=1e-6, rtol=0),
    "bfloat16": dict(atol=1e-3, rtol=2**-7),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _masks(b, t):
    """Rows cycling through the four mask kinds: every token valid, the
    first 70%, one token, none."""
    valid = np.array([t, int(0.7 * t), 1, 0] * (b // 4 + 1))[:b]
    return (np.arange(t)[None, :] < valid[:, None]).astype(np.int32)


def _qkv(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3)]


def _library(q, k, v, mask):
    """The reference's flash branch (`layers.py:205-215`) in TPU interpret
    mode, entered for this call alone. The call is waited for inside the
    context: interpret mode runs the kernel in host callbacks that call
    jnp, and a jnp op dispatched meanwhile by the caller deadlocks with
    them."""
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
            segment_ids=jfa.SegmentIds(q=mask, kv=mask), causal=False,
            sm_scale=1.0 / math.sqrt(q.shape[-1]),
        )
        return out.transpose(0, 2, 1, 3).astype(q.dtype).block_until_ready()


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh,h", [
    (256, 64, 2), (256, 128, 2), (256, 256, 2), (1024, 64, 1), (1024, 128, 1),
])
def test_plain_matches_library(t, dh, h, dtype):
    """The plain version against the library kernel over the four mask
    kinds: valid rows, padded rows and the all-zero row alike."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(t + dh, 4, t, h, dh)
    mask = _masks(4, t)
    ref = np.asarray(_library(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                              jnp.asarray(mask)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    m = torch.from_numpy(mask)
    out = tfa.flash_encoder_attention(tq, tk, tv, m, m)  # CPU: the plain version
    assert out.dtype == tdt and out.shape == tq.shape
    got = _np(out)
    np.testing.assert_allclose(got, ref, **LIB_TOL[dtype])
    if dtype == "bfloat16":  # a few rounding flips, not a drift
        assert (got != ref).mean() < 0.01


def test_padded_rows_follow_segment_ids():
    """Where the reference takes flash, a padded query attends the padded
    keys: the plain version's padded rows equal the library's and differ
    from the key-padding path's, whose valid rows they share."""
    t = 1024
    q, k, v = _qkv(11, 2, t, 1, 64)
    mask = _masks(2, t)  # row 0 full, row 1 valid up to 716
    ref = np.asarray(_library(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    m = torch.from_numpy(mask)
    flash = _np(tfa.flash_encoder_attention(tq, tk, tv, m, m))
    masked = _np(tlayers.attention(tq, tk, tv, tlayers.make_padding_mask(m)))
    np.testing.assert_allclose(flash, ref, **LIB_TOL["float32"])
    valid = mask.astype(bool)
    np.testing.assert_allclose(flash[valid], masked[valid], atol=1e-5, rtol=0)
    assert np.abs(flash[~valid] - masked[~valid]).max() > 1e-3


def _reference_takes_flash(monkeypatch, t, dh) -> bool:
    """Which branch the JAX `encoder_attention` takes for [1, t, 1, dh]
    inputs with the backend read as a TPU: both branches are stubbed, so
    only the gate runs."""
    taken = []

    def flash(q, k, v, **kw):
        taken.append("flash")
        return q

    def masked(q, k, v, mask):
        taken.append("masked")
        return q

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "flash_attention", flash)
    monkeypatch.setattr(jlayers, "attention", masked)
    x = jnp.zeros((1, t, 1, dh), jnp.float32)
    jlayers.encoder_attention(x, x, x, jnp.ones((1, t), jnp.int32))
    assert len(taken) == 1
    return taken[0] == "flash"


@pytest.mark.parametrize("dh", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("t", [896, 1000, 1024, 1152, 2048])
def test_gate_matches_reference(monkeypatch, t, dh):
    """`_use_flash` on the card decides as the reference's gate on a TPU;
    on the CPU it never takes flash, as the reference does not."""
    card = types.SimpleNamespace(shape=(1, t, 1, dh), is_cuda=True)
    assert tlayers._use_flash(card) is _reference_takes_flash(monkeypatch, t, dh)
    assert tlayers._use_flash(torch.zeros((1, t, 1, dh))) is False


@pytest.mark.parametrize("t", [256, 1024])
def test_encoder_attention_on_cpu_matches_jax(t):
    """On CPU tensors both packages take the key-padding path."""
    q, k, v = _qkv(t, 4, t, 2, 64)
    mask = _masks(4, t)
    ref = np.asarray(jlayers.encoder_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                               jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = _np(tlayers.encoder_attention(tq, tk, tv, torch.from_numpy(mask)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_wrapper_refuses_and_counts_nothing_on_cpu():
    """Shapes the kernel does not take are refused on both devices, cheapest
    check first; a CPU call runs the plain version and launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 256, 2, 64))
    m = torch.from_numpy(_masks(2, 256))
    before = tfa.flash_encoder_attention.launches
    tfa.flash_encoder_attention(q, k, v, m, m)
    assert tfa.flash_encoder_attention.launches == before
    with pytest.raises(ValueError, match="multiple of the 128"):
        tfa.flash_encoder_attention(q[:, :200], k[:, :200], v[:, :200],
                                    m[:, :200], m[:, :200])
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_encoder_attention(q[..., :32], k[..., :32], v[..., :32], m, m)
    with pytest.raises(ValueError, match="segment ids"):
        tfa.flash_encoder_attention(q, k, v, m[:1], m)
    with pytest.raises(TypeError, match="share one"):
        tfa.flash_encoder_attention(q, k.double(), v, m, m)
    with pytest.raises(TypeError, match="integers"):
        tfa.flash_encoder_attention(q, k, v, m.float(), m)


def test_card_path_raises_instead_of_falling_back(monkeypatch):
    """Tensors the wrapper takes for the card's go to the kernel or raise:
    a failed build surfaces, and no plain answer comes back."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 128, 1, 64))
    m = torch.ones((1, 128), dtype=torch.int32)

    def no_build(*args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa, "_on_card", lambda *args: 0)
    monkeypatch.setattr(_kernels, "launch", no_build)
    before = tfa.flash_encoder_attention.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tfa.flash_encoder_attention(q, k, v, m, m)
    assert tfa.flash_encoder_attention.launches == before


LONG_BERT = dict(vocab_size=1024, hidden=128, layers=2, heads=2, intermediate=256,
                 max_positions=1024)


def _flash_branch(q, k, v, attn_mask):
    """The reference's `encoder_attention` as it runs on a TPU at T >= 1024:
    its flash branch, in interpret mode."""
    return _library(q, k, v, attn_mask)


@pytest.fixture(scope="module")
def long_encoder():
    """A 2-layer, 128-wide BERT at max_positions 1024 on both sides (weights
    from JAX), a batch of a full row and a row padded from 700, and the JAX
    `bert_encode` of it through the flash branch (run once: ~8 s)."""
    jcfg = jbert.BertConfig(**LONG_BERT)
    tcfg = tbert.BertConfig(**LONG_BERT)
    jp = jax.jit(lambda key: jbert.init_bert_params(key, jcfg))(jax.random.key(8))
    tp = bert_params_from_jax(jax.device_get(jp), tcfg)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 1024, (2, 1024)).astype(np.int32)
    mask = (np.arange(1024)[None, :] < np.array([1024, 700])[:, None]).astype(np.int32)
    ids = ids * mask
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jbert, "encoder_attention", _flash_branch)
        hidden = jbert.bert_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    return jcfg, jp, tcfg, tp, ids, mask, hidden


@pytest.mark.parametrize("entry", ["bert_encode", "bert_embed"])
def test_long_encoder_through_flash_matches_jax(monkeypatch, long_encoder, entry):
    """The port's encoder with `encoder_attention` on the flash version (the
    plain one, on the CPU) against the JAX encoder through its flash branch:
    every row of `bert_encode`, padded ones included, and `bert_embed`
    (JAX's pooling over that same encoder output)."""
    jcfg, jp, tcfg, tp, ids, mask, hidden = long_encoder
    monkeypatch.setattr(jbert, "bert_encode", lambda *args: hidden)
    monkeypatch.setattr(tbert, "encoder_attention",
                        lambda q, k, v, m: tfa.flash_encoder_attention(q, k, v, m, m))
    ref = np.asarray(getattr(jbert, entry)(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        out = _np(getattr(tbert, entry)(tp, tcfg, torch.from_numpy(ids),
                                        torch.from_numpy(mask)))
    assert out.shape == ref.shape and np.isfinite(out).all()
    # f32 through two layers: the attention's last-bit differences and the
    # two frameworks' matmul and LayerNorm sums
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
