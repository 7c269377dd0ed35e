"""Sharded MSMs (port of halo_tpu/parallel/msm.py:159-241, the v2 tier).

Each shard runs ops/msm2's pipeline (msm_windows: recode, sort, the
ec_pmadd_scan kernel, the lane prefix, the ec_padd tree) on its slice of
the points, which gives its window sums [sum_{d<dmax} Q_d, Q_dmax].
Those are linear in the points, so the shards' window sums, copied to
mesh.devices[0] and added with ec_padd (a tree over the shards, the
ring reduce of halo_tpu's _ring_reduce_point), are the whole MSM's; the
host window combine (_windows_to_host, _combine_host) then runs once per
MSM, not once per shard.  A shard holds a power of two of points, at
least 16; zero scalars pad the tail.

halo_tpu's v1 tier (msm_sharded, msm_sharded_pair) is not carried over:
the port has one MSM tier.
"""

from __future__ import annotations

import torch

from ..curves import Affine, CurveCfg
from ..device import cached
from ..ops import mont, msm2
from ..srs import srs_pack
from .mesh import Mesh, shard_leading

MIN_PER_SHARD = 16


def _per_shard(n: int, d: int) -> int:
    return msm2.pad_pow2(max(MIN_PER_SHARD, -(-n // d)))


@cached(8)
def _srs_shards(cfg_name: str, mesh: Mesh, n: int) -> tuple[torch.Tensor, ...]:
    """The first n packed SRS generators, lane-sharded over the mesh."""
    return tuple(t.contiguous() for t in shard_leading(mesh, srs_pack(cfg_name, n, mesh.devices[0])))


def _reduce(p_mod: int, parts: list[torch.Tensor], dev) -> torch.Tensor:
    """Sum the shards' (3, 8, ...) window sums on `dev`: a tree of ec_padd."""
    parts = [t.to(dev) for t in parts]
    while len(parts) > 1:
        parts = [mont.ec_padd(p_mod, parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def _sharded_msm(cfg: CurveCfg, mesh: Mesh, xys, Ks) -> list[Affine]:
    """k MSMs: shard s holds table xys[s] (16, per) and scalars Ks[s]
    (8, k, per)."""
    k, per = Ks[0].shape[1], Ks[0].shape[2]
    c_bits = msm2.choose_c(per)
    windows, _ = msm2.cfg_for_c(c_bits)
    k_max = max(1, msm2.PREFIX_BYTES_CAP // (windows * per * 96))
    outs: list[Affine] = []
    for j0 in range(0, k, k_max):
        S = _reduce(cfg.p, [msm2.msm_windows(cfg.p, xy, K[:, j0:j0 + k_max], c_bits)
                            for xy, K in zip(xys, Ks)], mesh.devices[0])
        for win in msm2._windows_to_host(S, S.shape[2] // windows, windows):
            outs.append(msm2._combine_host(cfg, win, c_bits))
    return outs


def msm2_srs_rows_sharded(cfg: CurveCfg, mesh: Mesh, K: torch.Tensor) -> list[Affine]:
    """k SRS MSMs of (8, k, n_req) canonical scalar words, sharded over the
    mesh (the sharded msm2.msm2_srs_rows_multi; the Engine's commit path
    on a mesh)."""
    d = len(mesh)
    total = _per_shard(K.shape[-1], d) * d
    Ks = shard_leading(mesh, msm2._pad_scalars(K, total))
    return _sharded_msm(cfg, mesh, _srs_shards(cfg.name, mesh, total), Ks)


def msm2_sharded(cfg: CurveCfg, mesh: Mesh, scalars: list[int], points: list[Affine]) -> Affine:
    """General MSM over explicit affine points (None = identity), sharded
    over the mesh (the sharded msm2.msm2)."""
    if not scalars:
        return None
    d = len(mesh)
    xy, K = msm2.pack_explicit(cfg, scalars, points, _per_shard(len(scalars), d) * d,
                               mesh.devices[0])
    return _sharded_msm(cfg, mesh, [t.contiguous() for t in shard_leading(mesh, xy)],
                        shard_leading(mesh, K[:, None]))[0]
