"""Checkpoint loading on the card: quantize-on-load against
`quantize_qwen_params` of the bf16 load, and a BF16 checkpoint that loads
onto the card without a host copy of the file. Imports no jax; needs a CUDA
card (skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_checkpoints_card.py

The checkpoint is Qwen2.5-0.5B-Instruct's width and depth (~0.99 GB in
BF16), random, written under HF names by the port's writer.
"""

import os
import subprocess
import sys

import pytest
import torch

from rag_inference_pipeline_tpu_torch.models.qwen import (
    QwenConfig,
    init_qwen_params,
    quantize_qwen_params,
)
from rag_inference_pipeline_tpu_torch.models.safetensors import (
    load_safetensors_dict,
    save_safetensors,
)
from rag_inference_pipeline_tpu_torch.models.weights import QWEN_LAYER_HF, qwen_params_from_hf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hf_shapes(cfg: QwenConfig) -> dict:
    """HF name -> shape of a tied decoder checkpoint, from the model's own
    skeleton: a layer's 2-D (linear) leaves stored [out, in]."""
    sd = init_qwen_params(cfg, generator=None, device="meta").state_dict()
    out = {"model.embed_tokens.weight": tuple(sd["embed"].shape),
           "model.norm.weight": tuple(sd["final_ln"].shape)}
    for n in range(cfg.layers):
        for k, hf in QWEN_LAYER_HF.items():
            if f"layers.{n}.{k}" in sd:
                out[f"model.layers.{n}.{hf}"] = tuple(sd[f"layers.{n}.{k}"].shape[::-1])
    return out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(11)
    tensors = {
        k: (0.02 * torch.randn(shape, generator=g, device="cuda")).to(torch.bfloat16)
        for k, shape in _hf_shapes(QwenConfig.qwen25_05b()).items()
    }
    d = tmp_path_factory.mktemp("qwen_bf16")
    save_safetensors(tensors, str(d / "model.safetensors"))
    return str(d)


def _assert_bitwise(a, b) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k].contiguous().view(torch.uint8),
                           sb[k].contiguous().view(torch.uint8)), k


@pytest.mark.cuda
def test_quantize_on_load_on_card(checkpoint):
    """The int8 tree quantized as it loads equals quantize_qwen_params of
    the bf16 load, on the card, bit for bit; the bf16 load is the file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, dev = QwenConfig.qwen25_05b(), torch.device("cuda")
    with load_safetensors_dict(checkpoint) as raw:
        bf16 = qwen_params_from_hf(raw, cfg, device=dev, dtype=torch.bfloat16)
        q = qwen_params_from_hf(raw, cfg, device=dev, dtype=torch.bfloat16, quantize=True)
        assert torch.equal(bf16.layers[3].up_w.cpu(),
                           raw["model.layers.3.mlp.up_proj.weight"].t())
    torch.cuda.synchronize()
    _assert_bitwise(q, quantize_qwen_params(bf16))


_RSS_PROBE = """
import resource, sys, threading, torch
from rag_inference_pipeline_tpu_torch.models.qwen import QwenConfig
from rag_inference_pipeline_tpu_torch.models.safetensors import load_safetensors_dict
from rag_inference_pipeline_tpu_torch.models.weights import QWEN_LAYER_HF, qwen_params_from_hf

def rss_kb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() // 1024

torch.zeros(1, device="cuda")  # the CUDA context before the baseline
base = peak = rss_kb()
done = threading.Event()

def sample():
    global peak
    while not done.wait(0.001):
        peak = max(peak, rss_kb())

th = threading.Thread(target=sample)
th.start()
with load_safetensors_dict(sys.argv[1]) as raw:
    p = qwen_params_from_hf(raw, QwenConfig.qwen25_05b(), device="cuda",
                            dtype=torch.bfloat16)
torch.cuda.synchronize()
done.set()
th.join()
print(base, max(peak, rss_kb()))
"""


@pytest.mark.cuda
def test_bf16_checkpoint_loads_without_a_host_copy(checkpoint):
    """In a fresh process, the host's RSS, sampled every millisecond while
    the ~0.99 GB BF16 file loads onto the card, rises by less than a quarter
    of the file's size: the file is read through one 64 MB pinned buffer,
    its pages never mapped. (The process's lifetime peak, `ru_maxrss`,
    says nothing here: the CUDA context's start-up passes it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    size_kb = os.path.getsize(os.path.join(checkpoint, "model.safetensors")) // 1024
    out = subprocess.run([sys.executable, "-c", _RSS_PROBE, checkpoint], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    base, peak = (int(x) for x in out.stdout.split())
    print(f"file {size_kb} kB, RSS {base} -> peak {peak} kB")
    assert peak - base < size_kb / 4
