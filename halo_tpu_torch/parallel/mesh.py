"""A device mesh for the port (port of halo_tpu/parallel/mesh.py).

JAX's mesh is one controller over many devices; so is the port's: one
process drives an ordered tuple of torch devices, one shard each.  A
device may repeat: Mesh((cuda:0, cuda:0)) or Mesh((cpu,) * 8) holds
several logical shards on one device, as the JAX tests' forced 8-device
host platform does (tests/conftest.py), and is how one card checks the
sharding arithmetic.  The collectives of halo_tpu's shard_map code
(all_to_all, ppermute) are tensor copies between the shards' devices
(`.to(dev)`); on a repeated device such a copy moves nothing.

A sharded tensor is a list of shards, shard s on mesh.devices[s], each a
slice of the last (lane) axis of the port's (8, ..., n) rows
(shard_leading, in place of PartitionSpec("data")).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    def __len__(self) -> int:
        return len(self.devices)


def data_mesh(n_devices: int | None = None) -> Mesh:
    """All visible CUDA devices, or the first n_devices; raises without a
    GPU (as device.cuda does) or with fewer than n_devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("halo_tpu_torch: no CUDA device is available")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise RuntimeError(f"halo_tpu_torch: {n} CUDA devices asked for, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def shard_leading(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """x's last axis split into len(mesh) equal slices, slice s on
    mesh.devices[s]."""
    d = len(mesh)
    if x.shape[-1] % d:
        raise ValueError(f"{x.shape[-1]} lanes do not split over {d} shards")
    return [part.to(dev) for part, dev in zip(x.chunk(d, -1), mesh.devices)]


def replicated(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """x on every shard's device."""
    return [x.to(dev) for dev in mesh.devices]


def gather(shards: list[torch.Tensor], device) -> torch.Tensor:
    """The shards of shard_leading joined again on `device`."""
    return torch.cat([s.to(device) for s in shards], -1)
