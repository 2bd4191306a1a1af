"""The device mesh: a dp x tp grid of `torch.device`s and the placement of
tensors on it.

Port of `rag_inference_pipeline_tpu/core/mesh.py`. The reference places a
`jax.Array` on a `jax.sharding.Mesh` and lets `shard_map` run one program
per device; here a placed tensor is a list with one tensor per dp position,
and the sharded functions (`ops/*::sharded_*`) loop over the positions,
launching every position's work before reading any result.

- `put(x, mesh.rows_dp)` splits dim 0 into dp equal row blocks, block i on
  position i's device (views of `x` where it already lies there);
- `put(x)` (replicated) gives every position the tensor, with ONE copy per
  distinct physical device: positions that share a device share the copy.

A mesh's device list may repeat a device. `force_host_devices(n)` gives n
positions on one physical device (the CPU in the tests, `cuda:0` on a
one-card machine), so the sharded paths run with the real kernels on one
card and can be held to the unsharded search; there the positions' work
runs one after another. It is an explicit call: `make_mesh` never repeats
a device on its own, and a dp x tp larger than the devices there are
raises.

Tensor parallelism: `group(i)` is dp position i's tp group, the devices
its Megatron shards of the weights live on (`parallel/sharding.py`). The
model functions run a group's shards one after another and sum the
row-parallel partials on the group's first device (`models/layers.py::
tp_sum`); tp stays inside a process (`core/distributed.py::
validate_mesh_for_hosts`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

# placements accepted by MeshContext.put
ROWS_DP = "rows_dp"
REPLICATED = "replicated"


def default_devices(platform: Optional[str] = None) -> list[torch.device]:
    """The devices a mesh spans by default: `cuda:0 .. cuda:n-1` (raises
    without a card), or the one `cpu` for DEVICE_PLATFORM=cpu."""
    from .device import resolve_device

    dev = resolve_device(platform)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def force_host_devices(n: int, device: Union[str, torch.device, None] = None) -> list[torch.device]:
    """`n` mesh positions on one physical device: the reference fakes n CPU
    devices (`XLA_FLAGS=--xla_force_host_platform_device_count`); here the
    device (default: the CPU) is repeated n times, for `make_mesh(devices=)`."""
    if n < 1:
        raise ValueError(f"force_host_devices needs n >= 1, got {n}")
    return [torch.device(device if device is not None else "cpu")] * n


@dataclass(frozen=True)
class MeshContext:
    """The shared device-mesh handle: `grid[i][j]` is the device of dp
    position i, tp position j."""

    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def tp(self) -> int:
        return len(self.grid[0])

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The first device of each dp position's tp group: where its batch
        slice, its row shards and its replicated tensors live."""
        return tuple(row[0] for row in self.grid)

    def group(self, i: int) -> tuple[torch.device, ...]:
        """The tp group of dp position i: the device of each tp position."""
        return self.grid[i]

    @property
    def front(self) -> torch.device:
        """Position 0's device: where merged results and the batch live."""
        return self.grid[0][0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The physical devices of the dp positions' groups' first devices,
        each once, in position order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def rows_dp(self) -> str:
        """Shard dim 0 over dp: database rows, lists, batch entries."""
        return ROWS_DP

    @property
    def replicated(self) -> str:
        return REPLICATED

    def put(self, x, sharding: Optional[str] = None) -> list[torch.Tensor]:
        """`x` (a tensor or a numpy array) placed on the mesh: one tensor a
        dp position, row blocks (`rows_dp`, dim 0 must divide by dp) or the
        whole tensor once per distinct device (replicated, the default)."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if (sharding or REPLICATED) == REPLICATED:
            copies = {d: t.to(d) for d in self.distinct}
            return [copies[d] for d in self.devices]
        if sharding != ROWS_DP:
            raise ValueError(f"unknown placement {sharding!r}")
        if t.shape[0] % self.dp:
            raise ValueError(f"{t.shape[0]} rows do not split over dp={self.dp}")
        r = t.shape[0] // self.dp
        # on one repeated device the blocks are views of `x`; across devices
        # a block that stays on x's device is copied, so x can be freed
        own = len(self.distinct) > 1
        return [
            _own(t[i * r : (i + 1) * r].to(d), t, own) for i, d in enumerate(self.devices)
        ]

    def gather_rows(self, shards: Sequence[torch.Tensor], n: Optional[int] = None) -> torch.Tensor:
        """Row shards back as one host tensor, cut to the first n rows."""
        full = torch.cat([s.cpu() for s in shards])
        return full if n is None else full[:n]


def _own(block: torch.Tensor, whole: torch.Tensor, own: bool) -> torch.Tensor:
    """`block`, copied when `own` and it is still a view of `whole`."""
    shares = block.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
    return block.clone() if own and shares else block


def make_mesh(
    dp: int = 0,
    tp: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> MeshContext:
    """A dp x tp mesh; dp = 0 infers dp from the devices and tp. Needs
    dp * tp <= len(devices) (devices default to `default_devices()`); dp
    position i's tp group is devices[i * tp : (i + 1) * tp]."""
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    if tp <= 0:
        tp = 1
    if dp <= 0:
        dp = max(1, len(devs) // tp)
    need = dp * tp
    if need > len(devs):
        raise ValueError(f"mesh dp={dp} x tp={tp} needs {need} devices, have {len(devs)}")
    from .distributed import is_multiprocess, validate_mesh_for_hosts

    if is_multiprocess():
        validate_mesh_for_hosts(dp, tp, local=len(devs))
    grid = tuple(tuple(devs[i * tp : (i + 1) * tp]) for i in range(dp))
    return MeshContext(grid=grid)


def mesh_from_settings(settings) -> MeshContext:
    """The mesh of MESH_DP x MESH_TP over DEVICE_PLATFORM's devices, after
    joining the process group DIST_* configure."""
    from .distributed import init_distributed

    init_distributed(settings)
    return make_mesh(dp=settings.mesh_dp, tp=settings.mesh_tp,
                     devices=default_devices(settings.device_platform))
