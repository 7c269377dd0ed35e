"""SRS for the port: host public parameters and the packed device table.

load_srs returns halo_tpu.srs.PublicParams.  Where halo_tpu's own source
is at hand (the reference .precompute mount, or its .cache npz) it reads
through halo_tpu.srs.load_srs; otherwise it derives the generators with
the same formula (halo_tpu/srs.py:132-143 and the overlapping-block layout
of :195-214) but through the C++ batch scalar multiplication of
halo_tpu.native, which at 2^16 generators takes seconds where the Python
derivation takes minutes.

srs_pack gives the device table the MSM gathers from: (16, n) int32 rows,
x in rows 0-7 and y in rows 8-15, Montgomery form over the base field.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np
import torch

from halo_tpu import srs as halo_srs
from halo_tpu.curves import PALLAS, VESTA, Affine, CurveCfg
from halo_tpu.fields import R256

from .ops import ff, mont

_GENESIS = b"To understand recursion, one must first understand recursion"


def cfg_of(name: str) -> CurveCfg:
    return PALLAS if name == "pallas" else VESTA


def _hash_scalar(cfg: CurveCfg, i: int) -> int:
    h = hashlib.sha3_256()
    h.update(int(i).to_bytes(8, "little"))
    h.update(_GENESIS)
    return int.from_bytes(h.digest(), "little") % cfg.r


def _batch_mul_generator(cfg: CurveCfg, ks: list[int]) -> list[Affine]:
    from halo_tpu import native
    from halo_tpu.curves import ec_mul

    if native.available():
        return native.ec_batch_mul(cfg, ks, [cfg.generator] * len(ks))
    return [ec_mul(cfg, cfg.generator, k) for k in ks]


def _limbs16(vals: list[int]) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).copy()


def derive_srs(cfg_name: str, n: int) -> halo_srs.PublicParams:
    """S (index 0), H (index 1) and generator j = index b + k + 2 for
    (b, k) = divmod(j, G_BLOCKS_SIZE): halo_tpu's bootstrap layout."""
    assert n & (n - 1) == 0 and n <= halo_srs.N_MAX
    cfg = cfg_of(cfg_name)
    idx = [0, 1] + [sum(divmod(j, halo_srs.G_BLOCKS_SIZE)) + 2 for j in range(n)]
    pts = _batch_mul_generator(cfg, [_hash_scalar(cfg, i) for i in idx])
    gs = pts[2:]
    return halo_srs.PublicParams(
        cfg=cfg, S=pts[0], H=pts[1], D=n - 1,
        gs_x=_limbs16([p[0] for p in gs]), gs_y=_limbs16([p[1] for p in gs]))


@lru_cache(maxsize=8)
def load_srs(cfg_name: str, n: int) -> halo_srs.PublicParams:
    cfg = cfg_of(cfg_name)
    if halo_srs._have_reference() or halo_srs._npz_cache_path(cfg, n).exists():
        return halo_srs.load_srs(cfg_name, n)
    return derive_srs(cfg_name, n)


def host_msm(cfg: CurveCfg, scalars: list[int]) -> Affine:
    """MSM of host scalars against the first len(scalars) SRS generators
    on the host (halo_tpu.native's C++ MSM, or Python ints without it):
    the reference a device MSM is checked against."""
    from halo_tpu import native
    from halo_tpu.curves import msm_host

    n = len(scalars)
    gs = load_srs(cfg.name, 1 << max(2, (n - 1).bit_length())).gs_ints(n)
    return native.msm(cfg, scalars, gs) if native.available() else msm_host(cfg, scalars, gs)


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
    pp = load_srs(cfg_name, max(size, 4))
    gx = pp.gs_x[:n].astype("<u2").tobytes()
    gy = pp.gs_y[:n].astype("<u2").tobytes()
    xs = [int.from_bytes(gx[32 * i: 32 * i + 32], "little") for i in range(n)]
    ys = [int.from_bytes(gy[32 * i: 32 * i + 32], "little") for i in range(n)]
    return pack_points(cfg_of(cfg_name), xs, ys, device)
