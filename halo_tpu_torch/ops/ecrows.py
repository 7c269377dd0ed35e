"""Rows-layout EC composites over the point kernels (port of
halo_tpu/ops/ecrows.py: identity_rows, select_rows, scalar_mul_rows,
tree_sum_rows, msm_naive_rows), and the normalisation to affine rows.

A batch of projective points of shape S is one (3, 8, *S) int32 tensor:
X, Y, Z as canonical Montgomery word rows over the curve's base field.  An
affine operand is (16, n): x words in rows 0-7, y words in rows 8-15.

scalar_mul_rows is one ec_smul launch: double-and-add, most significant
bit first, each step doubling the accumulator and adding the affine base
where the scalar's bit is set, so the base stays affine and may be one
point that every lane shares.  halo_tpu's version runs least significant
bit first (ecrows.py:60-80); both give the same group element.
msm_naive_rows adds the products up with an ec_padd tree: an MSM that
shares no code with the bucket MSM of ops/msm2.py, which makes it the
reference the bucket MSM is checked against on the card.  to_affine_rows
divides by Z on the device (mont.batch_inv: one host inversion);
batch_to_affine does the same for host ints, and pack_points puts affine
int points into Montgomery rows.
"""

from __future__ import annotations

import torch

from ..fields import R256
from . import ff, mont


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
    return mont.ec_smul(p_mod, xy, k)


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


def batch_to_affine(p_mod: int, pjs) -> list:
    """(X, Y, Z) int triples -> affine int points (None where Z = 0), with
    one modular inversion for the batch (Montgomery's trick)."""
    prefix = [1]
    for _, _, z in pjs:
        prefix.append(prefix[-1] * (z or 1) % p_mod)
    tinv = pow(prefix[-1], -1, p_mod)
    out = [None] * len(pjs)
    for i in range(len(pjs) - 1, -1, -1):
        X, Y, Z = pjs[i]
        if Z == 0:
            continue
        zinv = tinv * prefix[i] % p_mod
        tinv = tinv * Z % p_mod
        out[i] = (X * zinv % p_mod, Y * zinv % p_mod)
    return out


def to_affine_ints(p_mod: int, P: torch.Tensor) -> list:
    """(3, 8, n) projective Montgomery rows -> n affine int points (None for
    the identity), batch_to_affine on the host.  The Montgomery factor
    cancels in X/Z and Y/Z."""
    return batch_to_affine(p_mod, to_projective_ints(P))


def pack_points(p_mod: int, xs: list[int], ys: list[int], device) -> torch.Tensor:
    """Affine coordinates (canonical ints) -> (16, n) Montgomery rows."""
    r2 = ff.const_rows(R256 * R256 % p_mod, device)
    x = mont.field_mul(p_mod, ff.to_rows(xs, device), r2)
    y = mont.field_mul(p_mod, ff.to_rows(ys, device), r2)
    return torch.cat((x, y))


def to_affine_rows(p_mod: int, P: torch.Tensor) -> torch.Tensor:
    """(3, 8, n) projective Montgomery rows -> (16, n) Montgomery affine
    rows (x in rows 0-7, y in rows 8-15), on P's device: x = X/Z, y = Y/Z
    by field_mul with Z's batched inverse.  Raises ValueError if a lane is
    the identity (Z = 0), which has no affine form."""
    zero = ff.is_zero(P[2])
    if bool(zero.any()):
        lane = int(zero.nonzero()[0, 0])
        raise ValueError(f"to_affine_rows: lane {lane} is the identity")
    zinv = mont.batch_inv(p_mod, P[2])
    return torch.cat((mont.field_mul(p_mod, P[0], zinv), mont.field_mul(p_mod, P[1], zinv)))
