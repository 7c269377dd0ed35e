"""SRS for the port: public parameters and the packed device table.

The generators come from their hash-to-curve formula (reference
crates/group/src/main.rs:55-68; halo_tpu/srs.py:132-143): generator i is
G * (SHA3-256(i as 8 LE bytes || genesis) mod r) for the fixed curve
generator G.  Index 0 is S, index 1 is H, and SRS point j is index
b + k + 2 for (b, k) = divmod(j, 2^14), the reference's overlapping-block
layout (halo_tpu/srs.py:195-214).  derive_srs hashes the n + 2 scalars
on the host, computes their multiples of G on the device in one ec_smul
launch (ecrows.scalar_mul_rows, G broadcast), normalises them to affine
Montgomery rows there (ecrows.to_affine_rows), and copies the canonical
words to the host once for the PublicParams' u16 limb tables.

srs_pack gives the device table the MSM gathers from: (16, n) int32 rows,
x in rows 0-7 and y in rows 8-15, Montgomery form over the base field.
It is the derivation's own table, kept on the device it was derived on.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import device as devmod
from .curves import Affine, CurveCfg, cfg_of, ec_mul
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
    table: torch.Tensor  # (16, N) Montgomery rows, on the device that derived them

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


@lru_cache(maxsize=4)
def load_sh(cfg_name: str) -> tuple[Affine, Affine]:
    """S and H alone (enough for succinct checks), by host scalar
    multiplication."""
    cfg = cfg_of(cfg_name)
    return tuple(ec_mul(cfg, cfg.generator, _hash_scalar(cfg, i)) for i in (0, 1))


def derive_srs(cfg_name: str, n: int, device, split: dict | None = None) -> PublicParams:
    """S, H and the first n SRS generators, derived on `device`.  If
    `split` is given, it is filled with the seconds of each part (hash,
    to_card, ec_smul, to_affine_rows, to_host, total), with the device
    synchronised between parts."""
    assert n & (n - 1) == 0 and n <= N_MAX
    cfg = cfg_of(cfg_name)
    device = torch.device(device)
    times = [time.perf_counter()]

    def mark():
        if split is not None:
            devmod.sync(device)
        times.append(time.perf_counter())

    idx = [0, 1] + [sum(divmod(j, G_BLOCKS_SIZE)) + 2 for j in range(n)]
    scalars = [_hash_scalar(cfg, i) for i in idx]
    mark()
    k = ff.to_rows(scalars, device)
    g = ecrows.pack_points(cfg.p, [cfg.generator[0]], [cfg.generator[1]], device)
    mark()
    P = ecrows.scalar_mul_rows(cfg.p, g, k)
    mark()
    table = ecrows.to_affine_rows(cfg.p, P)
    mark()
    # canonical words: (8, 2, n + 2) (word, coordinate, point) -> host,
    # then (2, n + 2, 16) little-endian u16 limbs
    canon = mont.field_mul(cfg.p, table.reshape(2, ff.NWORDS, -1).transpose(0, 1),
                           ff.const_rows(1, device))
    words = canon.cpu().numpy().view("<u4").transpose(1, 2, 0)
    limbs = np.ascontiguousarray(words).view("<u2")
    mark()
    if split is not None:
        names = ("hash", "to_card", "ec_smul", "to_affine_rows", "to_host")
        split.update({k_: b - a for k_, a, b in zip(names, times, times[1:])})
        split["total"] = times[-1] - times[0]

    def affine(c):
        return tuple(int.from_bytes(limbs[i, c].tobytes(), "little") for i in (0, 1))

    return PublicParams(cfg=cfg, S=affine(0), H=affine(1), D=n - 1, gs_x=limbs[0, 2:],
                        gs_y=limbs[1, 2:], table=table[:, 2:].contiguous())


_DERIVED: dict[str, PublicParams] = {}
_DERIVED_LOCK = threading.Lock()  # the provers of parallel/pipeline.py share _DERIVED


def load_srs(cfg_name: str, n: int, device, split: dict | None = None) -> PublicParams:
    """S, H and the first n generators.  Each curve's SRS is derived once,
    at the largest n asked for so far (the first n points of a larger SRS
    are the same points); `device` runs the derivation, which fills
    `split` (derive_srs)."""
    assert n & (n - 1) == 0 and n <= N_MAX
    with _DERIVED_LOCK:
        pp = _DERIVED.get(cfg_name)
        if pp is None or len(pp) < n:
            pp = _DERIVED[cfg_name] = derive_srs(cfg_name, n, device, split)
    if len(pp) == n:
        return pp
    return PublicParams(cfg=pp.cfg, S=pp.S, H=pp.H, D=n - 1, gs_x=pp.gs_x[:n], gs_y=pp.gs_y[:n],
                        table=pp.table[:, :n])


@devmod.cached(8)
def srs_pack(cfg_name: str, n: int, device: torch.device) -> torch.Tensor:
    """The first n SRS generators as a packed (16, n) device table: the
    derivation's Montgomery table, moved to `device` if it lies elsewhere."""
    size = 1 << max(0, (n - 1).bit_length())
    table = load_srs(cfg_name, max(size, 4), device).table
    return table[:, :n].contiguous().to(device)


def msm_naive(cfg: CurveCfg, scalars: list[int], device) -> Affine:
    """MSM of scalars against the first len(scalars) SRS generators by
    ecrows.msm_naive_rows (double-and-add per lane, then an ec_padd tree):
    the reference the bucket MSM of ops/msm2.py is held against."""
    xy = srs_pack(cfg.name, len(scalars), torch.device(device))
    k = ff.to_rows([s % cfg.r for s in scalars], device)
    return ecrows.to_affine_ints(cfg.p, ecrows.msm_naive_rows(cfg.p, xy, k))[0]
