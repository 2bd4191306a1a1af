"""rag_inference_pipeline_tpu_torch — the RAG serving path in PyTorch + CUDA.

A port of `rag_inference_pipeline_tpu` (JAX on a TPU) to PyTorch on an
NVIDIA Hopper GPU. The JAX package stays the reference: every module here
mirrors its counterpart's layout and is tested against it on the same
inputs (tests/test_torch_*.py). Plain tensor code is PyTorch; every kernel
the JAX package wrote in Pallas becomes a kernel written by hand for Hopper
under `csrc/`, with its plain PyTorch version beside its wrapper.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
