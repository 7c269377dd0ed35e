"""Radix-2 NTT over the 2-adic Pasta subgroups (port of the rows path of
halo_tpu/ops/ntt.py, _ntt_rows_fn :199-245, with its twiddle _plan
:28-47).

ark-poly's natural-order evaluation: ntt(coeffs)[i] = p(w^i), w the
canonical 2^k root of unity (fields.two_adic_root_of_unity).
Iterative Cooley-Tukey, as a few launches of the ntt_pass kernel, each
running several stages in shared memory (_passes): the first reads its
input in bit-reversed order, and an inverse's last multiplies by n^-1
(the TPU's mulc_rows).  Values stay canonical Montgomery throughout, so
there is no final canon pass.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..device import cached
from ..fields import R256, two_adic_root_of_unity

from . import ff, mont


@lru_cache(maxsize=64)
def _plan(m: int, log_n: int, inverse: bool):
    """Host plan: (W = [w^j * R mod m for j < n/2], n^-1 * R mod m or
    None).  Stage s of halo_tpu's _plan uses twiddles w_s^j with w_s =
    w^(n/2^s), which are W[j * n/2^s]."""
    n = 1 << log_n
    w = two_adic_root_of_unity(m, log_n)
    if inverse:
        w = pow(w, -1, m)
    half = max(n // 2, 1)
    tw = [0] * half
    cur = R256 % m
    for j in range(half):
        tw[j] = cur
        cur = cur * w % m
    n_inv = pow(n, -1, m) * R256 % m if inverse else None
    return tw, n_inv


@cached(64)
def _plan_dev(m: int, log_n: int, inverse: bool, device: torch.device):
    """(W as the (n/2, 8) element-major table ntt_pass reads, n^-1 R as
    (8, 1) rows or None)."""
    tw, n_inv = _plan(m, log_n, inverse)
    return (ff.to_rows(tw, device).t().contiguous(),
            ff.const_rows(n_inv, device) if inverse else None)


def _passes(log_n: int, tile_log: int = mont.NTT_TILE_LOG) -> list[tuple[int, int]]:
    """The ntt_pass launches of one transform, [(s0, j), ...]: stages 1 ..
    min(log_n, tile_log) first (a tile of 2^j positions), then the rest
    split evenly into passes of at most tile_log - 3 stages (8 low offsets
    x 2^j rows a tile), at least one each.  tile_log = 10 (the kernel's
    tile): 1 pass up to n = 2^10, 2 up to 2^17, 3 up to 2^24; a smaller
    tile_log gives more, shorter passes (the CUDA test's plans of later
    passes at small n)."""
    if not 1 <= tile_log <= mont.NTT_TILE_LOG:
        raise ValueError(f"tile_log {tile_log} not in [1, {mont.NTT_TILE_LOG}]")
    first = min(log_n, tile_log)
    rest = log_n - first
    jmax = max(1, tile_log - mont.NTT_COLS_LOG)
    count = -(-rest // jmax)
    out, s0 = [(0, first)], first
    for i in range(count):
        j = rest // count + (i < rest % count)
        out.append((s0, j))
        s0 += j
    return out


def ntt(m: int, a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse) NTT along the last axis of (8, *B, n)
    Montgomery rows; returns the same shape."""
    n = a.shape[-1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"NTT size {n} is not a power of two")
    if n == 1:
        return a.clone()
    tw, n_inv = _plan_dev(m, log_n, inverse, a.device)
    x = a.reshape(ff.NWORDS, -1)
    plan = _passes(log_n)
    for i, (s0, j) in enumerate(plan):
        x = mont.ntt_pass(m, x, tw, log_n, s0, j, n_inv if i == len(plan) - 1 else None)
    return x.reshape(a.shape)


def intt(m: int, a: torch.Tensor) -> torch.Tensor:
    return ntt(m, a, inverse=True)
