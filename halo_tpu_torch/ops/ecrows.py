"""Rows-layout point helpers (port of halo_tpu/ops/ecrows.py
identity_rows, select_rows).

A batch of projective points of shape S is one (3, 8, *S) int32 tensor:
X, Y, Z as canonical Montgomery word rows over the curve's base field.
"""

from __future__ import annotations

import torch

from . import ff


def identity_rows(p_mod: int, shape, device) -> torch.Tensor:
    """(3, 8, *shape) copies of the identity (0 : 1 : 0)."""
    shape = tuple(shape)
    out = torch.zeros((3, ff.NWORDS, *shape), dtype=torch.int32, device=device)
    out[1] = ff.mont_one(p_mod, device).reshape(ff.NWORDS, *([1] * len(shape)))
    return out


def select_rows(mask: torch.Tensor, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Lanewise select: mask (*S) bool -> P else Q, both (3, 8, *S)."""
    return torch.where(mask, P, Q)


def to_projective_ints(P: torch.Tensor) -> list[tuple[int, int, int]]:
    """(3, 8, *S) Montgomery rows -> [(X, Y, Z)] ints, still times R;
    the factor cancels in X/Z and Y/Z."""
    xs, ys, zs = (ff.from_rows(P[c]) for c in range(3))
    return list(zip(xs, ys, zs))
