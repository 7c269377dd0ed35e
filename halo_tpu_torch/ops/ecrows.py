"""Rows-layout EC composites over the point kernels (port of
halo_tpu/ops/ecrows.py: identity_rows, select_rows, scalar_mul_rows,
tree_sum_rows, msm_naive_rows).

A batch of projective points of shape S is one (3, 8, *S) int32 tensor:
X, Y, Z as canonical Montgomery word rows over the curve's base field.  An
affine operand is (16, n): x words in rows 0-7, y words in rows 8-15.

scalar_mul_rows is double-and-add, most significant bit first: each step
doubles the accumulator (ec_pdbl) and adds the affine base where the
scalar's bit is set (ec_pmadd, then a lanewise select), so the base stays
affine and may be one point that every lane shares.  halo_tpu's version
runs least significant bit first (ecrows.py:60-80); both give the same
group element.  msm_naive_rows adds the products up with an ec_padd tree:
an MSM that shares no code with the bucket MSM of ops/msm2.py, which
makes it the reference the bucket MSM is checked against on the card.
"""

from __future__ import annotations

import torch

from . import ff, mont

SCALAR_BITS = 255  # both Pasta scalar moduli are below 2^255


def identity_rows(p_mod: int, shape, device) -> torch.Tensor:
    """(3, 8, *shape) copies of the identity (0 : 1 : 0)."""
    shape = tuple(shape)
    out = torch.zeros((3, ff.NWORDS, *shape), dtype=torch.int32, device=device)
    out[1] = ff.mont_one(p_mod, device).reshape(ff.NWORDS, *([1] * len(shape)))
    return out


def select_rows(mask: torch.Tensor, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Lanewise select: mask (*S) bool -> P else Q, both (3, 8, *S)."""
    return torch.where(mask, P, Q)


def scalar_mul_rows(p_mod: int, xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k[:, i] * (x_i, y_i) for n lanes: xy (16, n) affine points, or one
    point (16, 1) for every lane; k (8, n) canonical scalar words.
    Returns (3, 8, n) projective points."""
    n = k.shape[1]
    kw = k.to(torch.int64) & 0xFFFFFFFF
    acc = identity_rows(p_mod, (n,), k.device)
    for i in range(SCALAR_BITS - 1, -1, -1):
        acc = mont.ec_pdbl(p_mod, acc)
        bit = ((kw[i // 32] >> (i % 32)) & 1) == 1
        acc = select_rows(bit, mont.ec_pmadd(p_mod, acc, xy), acc)
    return acc


def tree_sum_rows(p_mod: int, P: torch.Tensor) -> torch.Tensor:
    """Sum (3, 8, n) points over the lanes by halving with ec_padd;
    returns (3, 8, 1)."""
    n = P.shape[2]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        P = torch.cat((P, identity_rows(p_mod, (size - n,), P.device)), -1)
    while P.shape[2] > 1:
        h = P.shape[2] // 2
        P = mont.ec_padd(p_mod, P[:, :, :h], P[:, :, h:])
    return P


def msm_naive_rows(p_mod: int, xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_i k[:, i] * (x_i, y_i) as one (3, 8, 1) projective point."""
    return tree_sum_rows(p_mod, scalar_mul_rows(p_mod, xy, k))


def to_projective_ints(P: torch.Tensor) -> list[tuple[int, int, int]]:
    """(3, 8, *S) Montgomery rows -> [(X, Y, Z)] ints, still times R;
    the factor cancels in X/Z and Y/Z."""
    xs, ys, zs = (ff.from_rows(P[c]) for c in range(3))
    return list(zip(xs, ys, zs))


def to_affine_ints(p_mod: int, P: torch.Tensor) -> list:
    """(3, 8, n) projective Montgomery rows -> n affine int points (None for
    the identity), with one modular inversion for the batch (Montgomery's
    trick).  The Montgomery factor cancels in X/Z and Y/Z."""
    X, Y, Z = zip(*to_projective_ints(P))
    prefix = [1]
    for z in Z:
        prefix.append(prefix[-1] * (z or 1) % p_mod)
    tinv = pow(prefix[-1], -1, p_mod)
    out = [None] * len(Z)
    for i in range(len(Z) - 1, -1, -1):
        if Z[i] == 0:
            continue
        zinv = tinv * prefix[i] % p_mod
        tinv = tinv * Z[i] % p_mod
        out[i] = (X[i] * zinv % p_mod, Y[i] * zinv % p_mod)
    return out
