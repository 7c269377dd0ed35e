"""SRS for the port: public parameters and the packed device table.

The generators come from their hash-to-curve formula (reference
crates/group/src/main.rs:55-68; halo_tpu/srs.py:132-143): generator i is
G * (SHA3-256(i as 8 LE bytes || genesis) mod r) for the fixed curve
generator G.  Index 0 is S, index 1 is H, and SRS point j is index
b + k + 2 for (b, k) = divmod(j, 2^14), the reference's overlapping-block
layout (halo_tpu/srs.py:195-214).  derive_srs computes all n + 2 scalar
multiples as one batched scalar_mul_rows of G on the device (ec_pdbl,
ec_pmadd), then normalises them to affine on the host with one inversion.

srs_pack gives the device table the MSM gathers from: (16, n) int32 rows,
x in rows 0-7 and y in rows 8-15, Montgomery form over the base field.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .curves import Affine, CurveCfg, cfg_of, ec_mul
from .fields import R256
from .ops import ecrows, ff, mont

N_MAX = 1 << 20
G_BLOCKS_SIZE = N_MAX // 64
_GENESIS = b"To understand recursion, one must first understand recursion"


@dataclass
class PublicParams:
    cfg: CurveCfg
    S: Affine
    H: Affine
    D: int
    gs_x: np.ndarray  # (N, 16) u16 canonical limbs
    gs_y: np.ndarray

    def __len__(self) -> int:
        return self.gs_x.shape[0]

    def g_affine(self, i: int) -> Affine:
        return (int.from_bytes(self.gs_x[i].tobytes(), "little"),
                int.from_bytes(self.gs_y[i].tobytes(), "little"))

    def gs_ints(self, n: int) -> list[Affine]:
        xraw = self.gs_x[:n].tobytes()
        yraw = self.gs_y[:n].tobytes()
        return [(int.from_bytes(xraw[32 * i: 32 * i + 32], "little"),
                 int.from_bytes(yraw[32 * i: 32 * i + 32], "little")) for i in range(n)]


def _hash_scalar(cfg: CurveCfg, i: int) -> int:
    h = hashlib.sha3_256()
    h.update(int(i).to_bytes(8, "little"))
    h.update(_GENESIS)
    return int.from_bytes(h.digest(), "little") % cfg.r


def _limbs16(vals: list[int]) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).copy()


@lru_cache(maxsize=4)
def load_sh(cfg_name: str) -> tuple[Affine, Affine]:
    """S and H alone (enough for succinct checks), by host scalar
    multiplication."""
    cfg = cfg_of(cfg_name)
    return tuple(ec_mul(cfg, cfg.generator, _hash_scalar(cfg, i)) for i in (0, 1))


def derive_srs(cfg_name: str, n: int, device) -> PublicParams:
    """S, H and the first n SRS generators, derived on `device`."""
    assert n & (n - 1) == 0 and n <= N_MAX
    cfg = cfg_of(cfg_name)
    idx = [0, 1] + [sum(divmod(j, G_BLOCKS_SIZE)) + 2 for j in range(n)]
    k = ff.to_rows([_hash_scalar(cfg, i) for i in idx], device)
    g = pack_points(cfg, [cfg.generator[0]], [cfg.generator[1]], device)
    pts = ecrows.to_affine_ints(cfg.p, ecrows.scalar_mul_rows(cfg.p, g, k))
    gs = pts[2:]
    return PublicParams(cfg=cfg, S=pts[0], H=pts[1], D=n - 1,
                        gs_x=_limbs16([p[0] for p in gs]), gs_y=_limbs16([p[1] for p in gs]))


_DERIVED: dict[str, PublicParams] = {}


def load_srs(cfg_name: str, n: int, device) -> PublicParams:
    """S, H and the first n generators.  Each curve's SRS is derived once,
    at the largest n asked for so far (the first n points of a larger SRS
    are the same points); `device` runs the derivation."""
    assert n & (n - 1) == 0 and n <= N_MAX
    pp = _DERIVED.get(cfg_name)
    if pp is None or len(pp) < n:
        pp = _DERIVED[cfg_name] = derive_srs(cfg_name, n, device)
    if len(pp) == n:
        return pp
    return PublicParams(cfg=pp.cfg, S=pp.S, H=pp.H, D=n - 1, gs_x=pp.gs_x[:n], gs_y=pp.gs_y[:n])


def pack_points(cfg: CurveCfg, xs: list[int], ys: list[int], device) -> torch.Tensor:
    """Affine coordinates (canonical ints) -> (16, n) Montgomery rows."""
    r2 = ff.const_rows(R256 * R256 % cfg.p, device)
    x = mont.field_mul(cfg.p, ff.to_rows(xs, device), r2)
    y = mont.field_mul(cfg.p, ff.to_rows(ys, device), r2)
    return torch.cat((x, y))


@lru_cache(maxsize=8)
def srs_pack(cfg_name: str, n: int, device: torch.device) -> torch.Tensor:
    """The first n SRS generators as a packed (16, n) device table."""
    size = 1 << max(0, (n - 1).bit_length())
    gs = load_srs(cfg_name, max(size, 4), device).gs_ints(n)
    return pack_points(cfg_of(cfg_name), [g[0] for g in gs], [g[1] for g in gs], device)


def msm_naive(cfg: CurveCfg, scalars: list[int], device) -> Affine:
    """MSM of scalars against the first len(scalars) SRS generators by
    ecrows.msm_naive_rows (double-and-add per lane, then an ec_padd tree):
    the reference the bucket MSM of ops/msm2.py is held against."""
    xy = srs_pack(cfg.name, len(scalars), torch.device(device))
    k = ff.to_rows([s % cfg.r for s in scalars], device)
    return ecrows.to_affine_ints(cfg.p, ecrows.msm_naive_rows(cfg.p, xy, k))[0]
