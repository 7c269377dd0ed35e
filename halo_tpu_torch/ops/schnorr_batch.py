"""Batched Schnorr hashing and verification on tensors (port of
halo_tpu/ops/schnorr_batch.py).

N signatures under one public key run in lockstep over N lanes:

  1. message hash   every transcript absorbs the same number of values
                    (SIGNATURE label, pk, R, the L message fields), so the
                    sponge schedule is the same for all lanes: field_add
                    absorbs into state words 0 and 1, and permute_batch
                    (the poseidon_permute kernel) over all N states; L + 5
                    = 15 absorbs for 10-field messages are 8 permutations.
                    Where the scalar field is the smaller one (Vesta) the
                    challenge drops its low bit, as Sponge.challenge does.
  2. recode         t = -e in the scalar field (field_sub from zero), so
                    the check s*G == R + e*pk becomes s*G + t*pk == R; s
                    and t split into 32 base-256 digits each.
  3. fixed-base MSM one table of affine points: entry w*256 + j is
                    (j+1) * 2^(8w) * G, entry TABLE + w*256 + j the same
                    for pk, and the last entry -OFF*(G + pk), OFF = sum_w
                    2^(8w), which cancels the +1 of every digit (so no
                    entry is the identity, the scan kernel's contract).
                    Lane i adds its 64 digit entries and the correction in
                    one ec_pmadd_scan launch of R = 65 steps.
  4. compare        the projective sum (X : Y : Z) equals the affine R iff
                    X == x_R Z and Y == y_R Z: field_mul on the card, then
                    a word compare of canonical values.

verify_batch runs the stages as pack_batch (host values to the device),
challenge_rows (1), scan_indices (2), one ec_pmadd_scan (3) and compare
(4).  Each lane hashes its own transcript and checks its own equation: the
result is one verdict per signature, equal to halo_tpu.schnorr.verify's.
The reference pads N to its 512-lane block; the port has no block and no
padding.  When e = 0 the port's t is 0 where the reference's borrow chain
gives r: the same group element, and the tables take any digit string.

Tables depend only on (curve, pk): built on the host with projective adds
and one batched inversion (~16,000 adds), cached, copied to the caller's
device once per (curve, pk, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..curves import Affine, CurveCfg, ec_add, ec_mul
from ..device import cached
from ..fields import R256
from ..poseidon.sponge import Protocols
from . import ecrows, ff, mont, msm2, poseidon

WINDOWS = 32  # base-256 digits of a scalar below 2^256
TABLE = WINDOWS * 256
CORRECTION = 2 * TABLE  # the table column of -OFF*(G + pk)
STEPS = 2 * WINDOWS + 1  # scan depth: 64 digits and the correction


# ---------------- host table construction ---------------- #


def _table_points(cfg: CurveCfg, base: Affine) -> list[Affine]:
    """Window-major table: entry [w*256 + j] = (j+1) * 2^(8w) * base."""
    p = cfg.p
    b3 = 15 % p
    cols: list[tuple] = []
    B = (base[0], base[1], 1)
    for _ in range(WINDOWS):
        cur = B
        col = [cur]
        for _ in range(255):
            cur = msm2._pj_add(p, b3, cur, B)
            col.append(cur)
        cols.extend(col)
        B = col[255]  # 256 * 2^(8w) * base = 2^(8(w+1)) * base
    return ecrows.batch_to_affine(p, cols)


@lru_cache(maxsize=8)
def _table_words(cfg: CurveCfg, pk: Affine) -> np.ndarray:
    """(16, 2*TABLE + 1) int32 Montgomery rows of [G table | pk table |
    -OFF*(G + pk)]: x words in rows 0-7, y words in rows 8-15."""
    p = cfg.p
    pts = _table_points(cfg, cfg.generator) + _table_points(cfg, pk)
    off = int.from_bytes(b"\x01" * WINDOWS, "little")  # sum_w 2^(8w)
    corr = ec_mul(cfg, ec_add(cfg, cfg.generator, pk), off)
    pts.append((corr[0], (p - corr[1]) % p))
    xw = ff.ints_to_words([x * R256 % p for x, _ in pts])
    yw = ff.ints_to_words([y * R256 % p for _, y in pts])
    return np.ascontiguousarray(np.concatenate((xw.T, yw.T))).view(np.int32)


@cached(8)
def tables(cfg: CurveCfg, pk: Affine, device) -> torch.Tensor:
    """The verifier's table for (cfg, pk) as (16, 2*TABLE + 1) Montgomery
    rows on `device`, copied there once."""
    return torch.from_numpy(_table_words(cfg, pk)).to(device)


# ---------------- the lockstep hash ---------------- #


def absorb_rows(cfg: CurveCfg, pk: Affine, r_points, msgs, device) -> torch.Tensor:
    """Each transcript's absorbed values, SIGNATURE label, pk, R (the
    identity as (0, 0)), then the message, as (8, L + 5, N) canonical word
    rows on `device`.  Every message must have the same length L."""
    n = len(msgs)
    if n == 0 or len(r_points) != n:
        raise ValueError(f"{len(r_points)} commitments for {n} messages")
    L = len(msgs[0])
    if any(len(m) != L for m in msgs):
        raise ValueError("every message of a batch must have the same length")
    p = cfg.p
    head = [int(Protocols.SIGNATURE) % p, pk[0] % p, pk[1] % p]
    flat = []
    for r_pt, m in zip(r_points, msgs):
        rx, ry = r_pt if r_pt is not None else (0, 0)
        flat += head
        flat += [rx % p, ry % p]
        flat += [x % p for x in m]
    w = ff.ints_to_words(flat).reshape(n, L + 5, ff.NWORDS)
    rows = np.ascontiguousarray(w.transpose(2, 1, 0)).view(np.int32)
    return torch.from_numpy(rows).to(device)


def _shr1(e: torch.Tensor) -> torch.Tensor:
    """(8, N) words of a 256-bit value -> the value >> 1 (int64 in the
    middle: torch has no unsigned 32-bit shift)."""
    u = e.to(torch.int64) & 0xFFFFFFFF
    hi = torch.cat((u[1:], torch.zeros_like(u[:1])))
    v = (u >> 1) | ((hi & 1) << 31)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def challenge_rows(cfg: CurveCfg, V: torch.Tensor) -> torch.Tensor:
    """The lockstep sponge (halo_tpu _hash_e, poseidon/sponge.py's lazy
    schedule for L + 5 absorbs): V (8, L + 5, N) canonical rows -> each
    lane's challenge e as (8, N) canonical words in the scalar field."""
    p = cfg.p
    n, count = V.shape[2], V.shape[1]
    Vm = mont.field_mul(p, V, ff.const_rows(R256 * R256 % p, V.device))  # to Montgomery
    state = torch.zeros((poseidon.STATE_SIZE, ff.NWORDS, n), dtype=torch.int32, device=V.device)
    pos = 0
    for i in range(count):
        if pos < 2:
            state[pos] = mont.field_add(p, state[pos], Vm[:, i])
            pos += 1
        else:
            state = poseidon.permute_batch(p, state)
            state[0] = mont.field_add(p, state[0], Vm[:, i])
            pos = 1
    state = poseidon.permute_batch(p, state)
    e = mont.field_mul(p, state[0], ff.const_rows(1, V.device))  # out of Montgomery form
    return _shr1(e) if cfg.r < cfg.p else e


def hash_message_batch(cfg: CurveCfg, pk: Affine, r_points, msgs, device) -> list[int]:
    """e = H(SIGNATURE || pk || R_i || m_i) for every lane, as canonical
    ints (halo_tpu.ops.schnorr_batch.hash_message_batch), computed on
    `device`."""
    return ff.from_rows(challenge_rows(cfg, absorb_rows(cfg, pk, r_points, msgs, device)))


# ---------------- verification ---------------- #


def _digits(k: torch.Tensor) -> torch.Tensor:
    """(8, N) scalar words -> (32, N) base-256 digits, least significant first."""
    u = (k.to(torch.int64) & 0xFFFFFFFF)[:, None]
    shifts = torch.arange(0, 32, 8, device=k.device)[None, :, None]
    return ((u >> shifts) & 255).reshape(WINDOWS, -1)


def pack_batch(cfg: CurveCfg, pk: Affine, msgs, sigs, device):
    """The host values of a batch on `device`: the absorbed rows V (8, L +
    5, N), s as (8, N) scalar words, R as (8, 2, N) canonical x and y
    words (the identity as (0, 0)), and the (cfg, pk) table."""
    n = len(sigs)
    if n == 0 or len(msgs) != n:
        raise ValueError(f"{len(msgs)} messages for {n} signatures")
    p = cfg.p
    r_pts = [s.r if s.r is not None else (0, 0) for s in sigs]
    V = absorb_rows(cfg, pk, r_pts, msgs, device)
    S = ff.to_rows([s.s % cfg.r for s in sigs], device)
    R_xy = ff.to_rows([c % p for q in r_pts for c in q], device).reshape(ff.NWORDS, n, 2)
    return V, S, R_xy.permute(0, 2, 1), tables(cfg, tuple(pk), torch.device(device))


def scan_indices(cfg: CurveCfg, S: torch.Tensor, e: torch.Tensor):
    """t = -e in the scalar field, then the scan's (STEPS, N) int32 table
    columns (s's 32 digits into the G table, t's into the pk table, the
    correction) and its all-false sign rows."""
    n, dev = S.shape[1], S.device
    t = mont.field_neg(cfg.r, e)
    cols = torch.arange(WINDOWS, device=dev)[:, None] * 256
    corr = torch.full((1, n), CORRECTION, dtype=torch.int64, device=dev)
    idx = torch.cat((_digits(S) + cols, _digits(t) + cols + TABLE, corr)).to(torch.int32)
    return idx, torch.zeros((STEPS, n), dtype=torch.bool, device=dev)


def compare(cfg: CurveCfg, R_xy: torch.Tensor, acc: torch.Tensor) -> list[bool]:
    """Lane i's verdict: the projective acc[:, :, i] equals the affine R_i
    (R_xy (8, 2, N) canonical words), X == x_R Z and Y == y_R Z."""
    p, dev = cfg.p, R_xy.device
    Rm = mont.field_mul(p, R_xy, ff.const_rows(R256 * R256 % p, dev))
    prod = mont.field_mul(p, Rm, torch.stack((acc[2], acc[2]), 1))  # x_R Z, y_R Z
    return (prod == acc[:2].permute(1, 0, 2)).all(0).all(0).tolist()


def verify_batch(cfg: CurveCfg, pk: Affine, msgs, sigs, device) -> list[bool]:
    """Verify N (message, signature) pairs under one public key on
    `device`; one verdict per signature, equal to calling
    schnorr.verify N times.  Every message must have the same length."""
    V, S, R_xy, table = pack_batch(cfg, pk, msgs, sigs, device)
    idx, neg = scan_indices(cfg, S, challenge_rows(cfg, V))
    acc = mont.ec_pmadd_scan(cfg.p, table, idx, neg)[:, :, -1]  # (3, 8, N)
    return compare(cfg, R_xy, acc)
