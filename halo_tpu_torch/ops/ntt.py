"""Radix-2 NTT over the 2-adic Pasta subgroups (port of the rows path of
halo_tpu/ops/ntt.py, _ntt_rows_fn :199-245, with its twiddle _plan
:28-47).

ark-poly's natural-order evaluation: ntt(coeffs)[i] = p(w^i), w the
canonical 2^k root of unity (fields.two_adic_root_of_unity).
Iterative Cooley-Tukey: a bit-reversal gather, then log2(n) stages of the
ntt_butterfly kernel; the inverse ends in one field_mul by n^-1 (the TPU's
mulc_rows).  Values stay canonical Montgomery throughout, so there is no
final canon pass.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import R256, two_adic_root_of_unity

from . import ff, mont


@lru_cache(maxsize=64)
def _plan(m: int, log_n: int, inverse: bool):
    """Host plan: (bit-reversal permutation, W = [w^j * R mod m for
    j < n/2], n^-1 * R mod m or None).  Stage s of halo_tpu's _plan uses
    twiddles w_s^j with w_s = w^(n/2^s), which are W[j * n/2^s]."""
    n = 1 << log_n
    w = two_adic_root_of_unity(m, log_n)
    if inverse:
        w = pow(w, -1, m)
    i = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    half = max(n // 2, 1)
    tw = [0] * half
    cur = R256 % m
    for j in range(half):
        tw[j] = cur
        cur = cur * w % m
    n_inv = pow(n, -1, m) * R256 % m if inverse else None
    return rev, tw, n_inv


@lru_cache(maxsize=64)
def _plan_dev(m: int, log_n: int, inverse: bool, device: torch.device):
    rev, tw, n_inv = _plan(m, log_n, inverse)
    return (torch.from_numpy(rev).to(device), ff.to_rows(tw, device),
            ff.const_rows(n_inv, device) if inverse else None)


def ntt(m: int, a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse) NTT along the last axis of (8, *B, n)
    Montgomery rows; returns the same shape."""
    n = a.shape[-1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"NTT size {n} is not a power of two")
    if n == 1:
        return a.clone()
    rev, tw, n_inv = _plan_dev(m, log_n, inverse, a.device)
    x = a.reshape(ff.NWORDS, -1, n)[:, :, rev].reshape(ff.NWORDS, -1)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        x = mont.ntt_butterfly(m, x, tw, half, n // (2 * half))
    if inverse:
        x = mont.field_mul(m, x, n_inv)
    return x.reshape(a.shape)


def intt(m: int, a: torch.Tensor) -> torch.Tensor:
    return ntt(m, a, inverse=True)
