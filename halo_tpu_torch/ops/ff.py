"""Pasta field elements as torch tensors (port of halo_tpu/ops/ff.py).

Representation: a field element is 8 little-endian u32 words held in
int32 (the bit pattern of the u32), in a limb-major rows layout: a batch
of shape S is a tensor of shape (8, *S).  Values are canonical residues in
[0, p), in Montgomery form (R = 2^256, the same R as halo_tpu.ops.ff) where
a function says so.  Nothing in the port holds the TPU tier's lazy
quasi-2p domain.

The plain arithmetic here widens words to int64 limbs (torch has no uint32
add or shift on the CPU).  It uses 26-bit limbs rather than 16-bit ones:
ten limbs instead of sixteen cut the work of a product by 2.5x while
int64 still holds every column sum exactly.  These functions run on any
device; they are the plain versions that the kernel wrappers in
ops/mont.py take for CPU tensors only (and that chip_smoke.py holds each
kernel against on the card).  _norm_exact reads a tensor on the host at
every carry round, so no path on the card may reach them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import cached
from ..fields import FP_MOD, FQ_MOD, R256

NWORDS = 8
MODULI = (FP_MOD, FQ_MOD)  # field id 0, 1 (the ids csrc/field.cuh uses)


def field_id(m: int) -> int:
    if m == FP_MOD:
        return 0
    if m == FQ_MOD:
        return 1
    raise ValueError(f"not a Pasta modulus: {m:#x}")


# ---------------- int <-> words (host) ---------------- #


def ints_to_words(xs) -> np.ndarray:
    """ints in [0, 2^256) -> (N, 8) uint32 little-endian words."""
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").reshape(len(xs), NWORDS)


def words_to_ints(a: np.ndarray) -> list[int]:
    """(N, 8) uint32/int32 words -> ints."""
    raw = np.ascontiguousarray(a).astype("<u4", copy=False).tobytes()
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little") for i in range(len(a))]


def to_rows(xs, device) -> torch.Tensor:
    """ints -> (8, N) int32 word rows on `device` (no Montgomery step)."""
    w = np.array(ints_to_words(xs).T, order="C").view(np.int32)
    return torch.from_numpy(w).to(device)


def from_rows(t: torch.Tensor) -> list[int]:
    """(8, *S) word rows -> ints in row-major order of S."""
    w = t.reshape(NWORDS, -1).T.contiguous().cpu().numpy()
    return words_to_ints(w)


def const_rows(x: int, device) -> torch.Tensor:
    """One constant as (8, 1) word rows."""
    return to_rows([x], device)


# ---------------- plain arithmetic: 26-bit limbs in int64 ---------------- #
#
# The plain versions widen the 8 words to ten 26-bit limbs in int64,
# (10, *S).  A canonical value has limbs in [0, 2^26) and value < p.
# Inside a formula, values may be "lazy": limbs |l| < 2^29 (signed) and
# 0 <= value < 2^262.  Lazy sums and differences are limbwise; the product
# of two lazy values stays exact in int64 (per column at most 10 products
# below 2^58 plus the REDC terms); `canon` ends each formula.

LB = 26
NL = 10
M26 = (1 << LB) - 1
TOP = 256 - LB * (NL - 1)  # 22: width of the last REDC digit
MTOP = (1 << TOP) - 1


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(8, *S) int32 words -> (10, *S) int64 canonical 26-bit limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    out = []
    for j in range(NL):
        k, s = divmod(LB * j, 32)
        v = u[k] >> s
        got = 32 - s
        if got < LB and k + 1 < NWORDS:
            v = v | ((u[k + 1] & ((1 << (LB - got)) - 1)) << got)
        out.append(v & M26)
    return torch.stack(out)


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(10, *S) canonical limbs -> (8, *S) int32 words."""
    out = []
    for k in range(NWORDS):
        j, s = divmod(32 * k, LB)
        v = limbs[j] >> s
        got = LB - s
        while got < 32 and j + 1 < NL:
            j += 1
            need = min(LB, 32 - got)
            v = v | ((limbs[j] & ((1 << need) - 1)) << got)
            got += need
        out.append(v)
    u = torch.stack(out)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _limbs_of(x: int) -> list[int]:
    return [(x >> (LB * j)) & M26 for j in range(NL - 1)] + [x >> (LB * (NL - 1))]


@cached(64)
def _kp(m: int, k: int, device: torch.device) -> torch.Tensor:
    """k*m as (10, 1) limbs (the top limb holds the bits above 234)."""
    return torch.tensor(_limbs_of(k * m), dtype=torch.int64, device=device).reshape(NL, 1)


# Both Pasta moduli are 2^254 + c with 1 = c mod 2^32 and c < 2^130: their
# limbs 5-8 are zero and limb 9 is 2^20, so a REDC step adds mi * m as five
# limbs and a shift, and -m^-1 = -1 mod 2^26, so mi = -c_i mod 2^26.
_M_LO = 5
_M_TOP_SHIFT = 254 - LB * (NL - 1)


@lru_cache(maxsize=16)
def _check_sparse(m: int) -> None:
    limbs = _limbs_of(m)
    assert m % (1 << LB) == 1
    assert limbs[_M_LO:NL - 1] == [0] * (NL - 1 - _M_LO) and limbs[-1] == 1 << _M_TOP_SHIFT


def align(a: torch.Tensor, b: torch.Tensor):
    """Give (L, *Sa) and (L, *Sb) the same rank, so that their batch axes
    broadcast right-aligned behind the limb axis."""
    nd = max(a.dim(), b.dim())
    return (a.reshape(a.shape[0], *([1] * (nd - a.dim())), *a.shape[1:]),
            b.reshape(b.shape[0], *([1] * (nd - b.dim())), *b.shape[1:]))


def _carry(c: torch.Tensor) -> torch.Tensor:
    """One carry round over (K, *S): every limb but the top keeps its low
    26 bits and passes the rest (floor, so signed limbs work) up one."""
    hi = c[:-1] >> LB
    c[:-1] &= M26
    c[1:] += hi
    return c


def _norm_exact(c: torch.Tensor) -> torch.Tensor:
    """Carry rounds (in place) until no carry is left: limbs 0..K-2 in
    [0, 2^26), the top limb holds the rest (negative for a negative value)."""
    while bool((c[:-1] >> LB).any()):
        c = _carry(c)
    return c


def canon(m: int, v: torch.Tensor) -> torch.Tensor:
    """Lazy (10, *S) limbs with 0 <= value < 2^262 -> canonical limbs."""
    c = _norm_exact(torch.cat((v, torch.zeros_like(v[:1]))))  # 11 limbs
    q = (c[NL - 1] >> 20) + (c[NL] << 6)  # floor(value / 2^254) >= floor(value / p)
    p11 = torch.cat((_kp(m, 1, v.device), torch.zeros_like(_kp(m, 1, v.device)[:1])))
    p11 = p11.reshape(NL + 1, *([1] * (v.dim() - 1)))
    c = _norm_exact(c - q * p11)  # value in (-p, p)
    c = _norm_exact(c + p11 * (c[NL] < 0))
    return c[:NL]


def lsub(m: int, a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """Lazy a - b + k*m; the caller guarantees value(b) <= k*m."""
    a, b = align(a, b)
    return a - b + _kp(m, k, a.device).reshape(NL, *([1] * (a.dim() - 1)))


def lmul(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy Montgomery product a*b*R^-1 (R = 2^256) of lazy (10, *S)
    limbs (broadcasting): the value is congruent to a*b/R mod m and below
    a*b/R + m; limbs come out carried to |l| <= 2^26 + 1.  Interleaved
    REDC over nine 26-bit digits and one 22-bit digit."""
    a, b = align(a, b)
    shape = tuple(max(x, y) for x, y in zip(a.shape[1:], b.shape[1:]))
    a = a.expand(NL, *shape).reshape(NL, -1)
    b = b.expand(NL, *shape).reshape(NL, -1)
    _check_sparse(m)
    m_lo = _kp(m, 1, a.device)[:_M_LO]
    c = torch.zeros((2 * NL + 1, a.shape[1]), dtype=torch.int64, device=a.device)
    for i in range(NL):
        c.narrow(0, i, NL).addcmul_(b, a[i: i + 1])
    for i in range(NL - 1):
        mi = c[i: i + 1].neg() & M26
        c.narrow(0, i, _M_LO).addcmul_(m_lo, mi)
        c[i + NL - 1].add_(mi[0], alpha=1 << _M_TOP_SHIFT)
        c[i + 1] += c[i] >> LB
    mi = c[NL - 1: NL].neg() & MTOP
    c.narrow(0, NL - 1, _M_LO).addcmul_(m_lo, mi)
    c[2 * NL - 2].add_(mi[0], alpha=1 << _M_TOP_SHIFT)
    # value / 2^256 from the columns at 2^234..: split each column into
    # (high, low 22 bits); the lows move down one limb, 4 bits up
    r = c[NL - 1:]
    out = r >> TOP
    out[:-1] += (r[1:] & MTOP) << (LB - TOP)
    for _ in range(3):
        out = _carry(out)
    top = out[NL - 1] + (out[NL] << LB) + (out[NL + 1] << (2 * LB))
    return torch.cat((out[:NL - 1], top[None])).reshape(NL, *shape)


# ---------------- word-level plain ops (any device) ---------------- #


def mont_mul_plain(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain Montgomery product on (8, *S) word rows (broadcasting)."""
    return limbs_to_words(canon(m, lmul(m, words_to_limbs(a), words_to_limbs(b))))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


# ---------------- host-int Montgomery helpers ---------------- #


def mont_int(x: int, m: int) -> int:
    """x -> x*R mod m."""
    return x * R256 % m


def unmont_int(x: int, m: int) -> int:
    return x * pow(R256, -1, m) % m


def mont_one(m: int, device) -> torch.Tensor:
    """Montgomery one (R mod m) as (8, 1) rows."""
    return const_rows(R256 % m, device)


def mont_inv(m: int, x: int) -> int:
    """Inverse of a scalar by host ints (inv(0) = 0, the Fermat convention
    of halo_tpu.ops.ff.mont_inv)."""
    return pow(x, -1, m) if x % m else 0
