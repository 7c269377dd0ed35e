"""Conversions between halo_tpu's numpy limb arrays and the port's tensors.

halo_tpu keeps a field element as 16 little-endian 16-bit limbs in the
last axis, (..., 16) uint16/uint32; the port keeps 8 little-endian u32
words in the first axis, (8, ...) int32.  Both use R = 2^256 for
Montgomery form, so a Montgomery array converts without arithmetic.  The
tests use these to feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import ecrows, ff


def limbs16_to_rows(a, device="cpu") -> torch.Tensor:
    """(..., 16) 16-bit limbs (Montgomery or canonical) -> (8, ...) rows."""
    a = np.asarray(a).astype(np.uint32)
    words = a[..., 0::2] | (a[..., 1::2] << 16)  # (..., 8)
    rows = np.ascontiguousarray(np.moveaxis(words, -1, 0)).view(np.int32)
    return torch.from_numpy(rows).to(device)


def rows_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(8, ...) rows -> (..., 16) uint32 arrays of 16-bit limbs."""
    w = np.moveaxis(t.cpu().numpy().view(np.uint32), 0, -1)  # (..., 8)
    out = np.empty((*w.shape[:-1], 16), dtype=np.uint32)
    out[..., 0::2] = w & 0xFFFF
    out[..., 1::2] = w >> 16
    return out


def srs_rows(pp, n: int, device) -> torch.Tensor:
    """halo_tpu.srs.PublicParams -> the packed (16, n) device SRS table
    (x words in rows 0-7, y words in rows 8-15, Montgomery form)."""
    xs = ff.words_to_ints(np.ascontiguousarray(
        limbs16_to_rows(pp.gs_x[:n]).numpy().T))
    ys = ff.words_to_ints(np.ascontiguousarray(
        limbs16_to_rows(pp.gs_y[:n]).numpy().T))
    return ecrows.pack_points(pp.cfg.p, xs, ys, device)


def dev_polys_to_rows(dev_polys: dict, device) -> dict:
    """halo_tpu Trace.dev_polys ({key: (k, n, 16) Montgomery}) -> the
    port's {key: (8, k, n)} mirrors."""
    return {key: limbs16_to_rows(np.asarray(v), device) for key, v in dev_polys.items()}
