"""Measurement and deployment tools of the port, each run as a module:

    python -m rag_inference_pipeline_tpu_torch.tools.bench_kernel --mode stream
    python -m rag_inference_pipeline_tpu_torch.tools.bench_decode_anatomy
    python -m rag_inference_pipeline_tpu_torch.tools.start_pipeline

`--smoke` runs either bench tool at tiny shapes on the CPU; otherwise they
run on the card and raise without one. Results go to `build/bench/`.
`start_pipeline` starts a TOTAL_NODES deployment of the server.
"""
