"""k-means (Lloyd's) on the device, for the IVF coarse quantizer and, as a
batch of independent problems, the PQ codebooks.

Port of `rag_inference_pipeline_tpu/ops/kmeans.py`: chunked float32
matmuls for the nearest-centroid scores and one-hot matmuls for the
per-cluster sums, as the reference computes them (no Pallas kernel is
involved). The random init and the reseeding noise come from an explicit
`torch.Generator`; `jax.random` cannot be reproduced, so `kmeans` matches
the reference in kind, not bit for bit, while `assign_clusters` and
`_lloyd_step` match it on the same centroids.

float32 matmuls on a CUDA card must not run in TF32, or assignments and
IVF probe sets move: `require_full_f32` refuses a process that turned
TF32 on (`torch.get_float32_matmul_precision() != "highest"`).
"""

from __future__ import annotations

from typing import Optional

import torch


def require_full_f32(t: torch.Tensor) -> None:
    """Raise when float32 matmuls on `t`'s CUDA device would use TF32."""
    if t.device.type == "cuda" and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmuls run in TF32 (torch.set_float32_matmul_precision "
            f"is {torch.get_float32_matmul_precision()!r}): k-means "
            "assignments and IVF probe sets need full float32"
        )


def _scores(xc: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """2 x.c - |c|^2 (argmax = nearest centroid in L2), float32; any
    leading batch dimensions broadcast."""
    return 2.0 * torch.matmul(xc.float(), c.transpose(-1, -2)) - c_sq[..., None, :]


def assign_clusters(
    x: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 65536
) -> torch.Tensor:
    """Nearest-centroid assignment (L2). Returns [N] int32; among equal
    scores the lower centroid id (`argmax` returns the first)."""
    require_full_f32(x)
    c = centroids.float()
    c_sq = (c * c).sum(dim=1)
    out = [
        torch.argmax(_scores(x[s : s + chunk], c, c_sq), dim=1)
        for s in range(0, x.shape[0], chunk)
    ]
    return torch.cat(out).to(torch.int32)


def _lloyd_step(
    x_pad: torch.Tensor, n_real: int, centroids: torch.Tensor, *, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over padded data: rows at or past `n_real` do
    not count. x_pad [..., N, D] and centroids [..., k, D]: a leading
    dimension runs independent problems at once (the PQ subspaces).
    Returns (new_centroids [..., k, D] f32, counts [..., k] f32); an empty
    cluster keeps its old centroid."""
    k = centroids.shape[-2]
    c = centroids.float()
    c_sq = (c * c).sum(dim=-1)
    sums = torch.zeros(c.shape, dtype=torch.float32, device=x_pad.device)
    counts = torch.zeros(c.shape[:-1], dtype=torch.float32, device=x_pad.device)
    for start in range(0, x_pad.shape[-2], chunk):
        xf = x_pad[..., start : start + chunk, :].float()
        a = torch.argmax(_scores(xf, c, c_sq), dim=-1)
        # a float one-hot without one_hot's int64 intermediate
        onehot = torch.zeros((*a.shape, k), device=x_pad.device).scatter_(
            -1, a[..., None], 1.0
        )
        rid = torch.arange(start, start + xf.shape[-2], device=x_pad.device)
        onehot = onehot * (rid < n_real).float()[:, None]
        sums = sums + torch.matmul(onehot.transpose(-1, -2), xf)
        counts = counts + onehot.sum(dim=-2)
    new_c = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where((counts > 0)[..., None], new_c, c), counts


def kmeans(
    x: torch.Tensor,
    k: int,
    *,
    iters: int = 15,
    chunk: int = 65536,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means. Returns (centroids [k, D] f32, counts [k] f32).

    `x` is [N, D], or [M, N, D] for M independent problems trained at once
    (the reference vmaps its k-means over the PQ subspaces); the results
    then gain the leading M. Init: k points sampled without replacement
    (`randperm`, one per problem). Each iteration reseeds empty clusters at
    perturbed copies of the largest cluster's centroid, as the reference
    does. `generator` lives on x's device; the same seed gives the same
    result."""
    require_full_f32(x)
    n, d = x.shape[-2:]
    if n < k:
        raise ValueError(f"k-means needs at least k training points: n={n} < k={k}")
    chunk = min(chunk, max(256, n))
    if x.dim() == 2:
        c = x[torch.randperm(n, generator=generator, device=x.device)[:k]].float()
    else:
        perm = torch.stack([
            torch.randperm(n, generator=generator, device=x.device)[:k]
            for _ in range(x.shape[0])
        ])
        c = torch.gather(x, 1, perm[:, :, None].expand(-1, -1, d)).float()
    counts = torch.zeros(c.shape[:-1], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        new_c, counts = _lloyd_step(x, n, c, chunk=chunk)
        big = torch.argmax(counts, dim=-1, keepdim=True)  # [..., 1]
        fattest = torch.gather(new_c, -2, big[..., None].expand(*big.shape, d))
        noise = 1e-3 * torch.randn(
            new_c.shape, generator=generator, device=x.device
        )
        c = torch.where((counts > 0)[..., None], new_c, fattest + noise)
    return c, counts
