"""The sequence-parallel encoder (`parallel/sequence.py::bert_encode_sp`) on
the CPU against the JAX package's on the 8 fake devices of
`tests/conftest.py`, and against the port's unsplit `bert_encode`.

The reference's test (tests/test_device_pipeline.py:174-196) compares valid
rows only: a padded query row attends nothing of its own, and its value is
not part of the result. The same here, at sp = 8 over T = 64 and at
sp = 2 and 4 through the dp axis and through a tp group."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core import make_mesh as j_make_mesh
from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.parallel import bert_encode_sp as j_bert_encode_sp
from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.models import bert as tbert
from rag_inference_pipeline_tpu_torch.models.weights import bert_params_from_jax
from rag_inference_pipeline_tpu_torch.parallel import bert_encode_sp


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    jp = jax.jit(partial(jbert.init_bert_params, cfg=jcfg))(jax.random.key(0))
    return jcfg, jp, tcfg, bert_params_from_jax(jax.device_get(jp), tcfg)


def _inputs(seed=0, t=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (2, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 40:] = 0
    return ids, mask


def test_sp8_matches_jax_on_valid_rows(pair):
    jcfg, jp, tcfg, tp = pair
    ids, mask = _inputs()
    ref = np.asarray(j_bert_encode_sp(jp, jcfg, j_make_mesh(dp=8, tp=1), jnp.asarray(ids),
                                      jnp.asarray(mask), sp_axis="dp"))
    mesh = make_mesh(dp=8, devices=force_host_devices(8))
    out = bert_encode_sp(tp, tcfg, mesh, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape == (2, 64, tcfg.hidden)
    np.testing.assert_allclose(out[0], ref[0], atol=2e-4, rtol=0)
    np.testing.assert_allclose(out[1, :40], ref[1, :40], atol=2e-4, rtol=0)


@pytest.mark.parametrize("sp,axis", [(2, "dp"), (4, "dp"), (2, "tp")])
def test_matches_unsplit_encoder(pair, sp, axis):
    _, _, tcfg, tp = pair
    ids, mask = (torch.from_numpy(a) for a in _inputs(seed=sp))
    dp, tpn = (sp, 1) if axis == "dp" else (1, sp)
    mesh = make_mesh(dp=dp, tp=tpn, devices=force_host_devices(sp))
    out = bert_encode_sp(tp, tcfg, mesh, ids, mask, sp_axis=axis)
    ref = tbert.bert_encode(tp, tcfg, ids, mask)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out[1, :40].numpy(), ref[1, :40].numpy(), atol=2e-5, rtol=0)


def test_indivisible_sequence_is_refused(pair):
    _, _, tcfg, tp = pair
    ids, mask = (torch.from_numpy(a) for a in _inputs(t=60))
    mesh = make_mesh(dp=8, devices=force_host_devices(8))
    with pytest.raises(ValueError, match="divisible"):
        bert_encode_sp(tp, tcfg, mesh, ids, mask)
