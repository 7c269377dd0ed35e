"""Signed-digit bucket MSM on tensors (port of halo_tpu/ops/msm2.py).

Pipeline for k MSMs over one point table (their windows stack):

  1. signed-digit recode  c-bit windows, digits in [-2^(c-1), 2^(c-1)];
                          key = |digit| (0 = dead), the sign negates the
                          point inside the scan kernel (_recode_signed).
  2. sort + gather        torch.sort per window row; the scan kernel
                          gathers the affine points itself by index.
  3. prefix scan          one ec_pmadd_scan launch: lane l of a window owns
                          sorted positions [l*R, (l+1)*R) and writes every
                          inclusive prefix (replaces the pmadd_pack kernel
                          and the lax.scan around it, :398-417).
  4. lane prefix          exclusive prefix over the L lane totals of each
                          window: a Hillis-Steele scan of ec_padd (log2 L
                          levels) in place of the Blelloch _excl_prefix.
  5. bucket bounds        Q_d = prefix at the last position with key <= d,
                          found by torch.searchsorted (in place of the MXU
                          histogram _bucket_cum_counts and _bisect_right2).
  6. Abel telescoping     sum_d d*B_d = dmax*Q_dmax - sum_{d<dmax} Q_d: one
                          ec_padd tree over the dmax bucket prefixes.
  7. window combine       the (W, 2) window points go to the host and are
                          Horner-combined in exact projective ints
                          (_combine_host and _pj_add, copied).

Any correct MSM gives the same group element, so the window width and the
lane split are the port's own (chosen for the card and for small CPU
tests); proof bytes depend only on the affine result.  Sizes pad to a
power of two (no TPU tiling floor), and the JAX scan `stride` is dropped
(it is 1 in production).
"""

from __future__ import annotations

import torch

from ..curves import Affine, CurveCfg

from . import ecrows, ff, mont

# one pipeline call keeps its prefix table (k*W*n points of 96 bytes)
# under this many bytes; larger batches run in chunks of MSMs
PREFIX_BYTES_CAP = 8 << 30


def choose_c(n: int) -> int:
    """Window width: small windows keep the bucket stage (dmax buckets per
    window) cheap at small n; wide windows cut the scan work (256/c
    windows of n points) at large n."""
    if n <= 256:
        return 4
    return 8 if n < (1 << 18) else 16


def cfg_for_c(c_bits: int):
    """(windows, dmax); c divides 32, so no digit straddles a word."""
    assert 32 % c_bits == 0
    return 256 // c_bits, 1 << (c_bits - 1)


def choose_lanes(n: int) -> int:
    """Lanes per window; the scan depth is R = n / lanes sequential steps."""
    if n < 16:
        return 1
    return n // 16 if n <= 4096 else n // 64


def pad_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# ---------------- host-side exact EC (final combine) ---------------- #


def _pj_add(p, b3, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = X1 * X2 % p
    t1 = Y1 * Y2 % p
    t2 = Z1 * Z2 % p
    t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % p
    t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % p
    y3 = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % p
    t0 = 3 * t0 % p
    t2 = b3 * t2 % p
    z3 = (t1 + t2) % p
    t1 = (t1 - t2) % p
    y3 = b3 * y3 % p
    X3 = (t3 * t1 - t4 * y3) % p
    Y3 = (t1 * z3 + y3 * t0) % p
    Z3 = (z3 * t4 + t0 * t3) % p
    return (X3, Y3, Z3)


def _pj_to_aff(p_mod: int, Pj):
    X, Y, Z = Pj
    if Z % p_mod == 0:
        return None
    zi = pow(Z, -1, p_mod)
    return (X * zi % p_mod, Y * zi % p_mod)


def _combine_host(cfg: CurveCfg, S, c_bits: int) -> Affine:
    """S: W pairs ((X, Y, Z) of sum_{d<dmax} Q_d, of Q_top) in projective
    ints; W_w = dmax * Q_top - sum Q_d, total = sum_w 2^(c*w) * W_w."""
    windows, _ = cfg_for_c(c_bits)
    p_mod = cfg.p
    b3 = 15 % p_mod
    total = (0, 1, 0)
    for w in reversed(range(windows)):
        qsum, qtop = S[w]
        for _ in range(c_bits):
            total = _pj_add(p_mod, b3, total, total)
        Ww = qtop
        for _ in range(c_bits - 1):
            Ww = _pj_add(p_mod, b3, Ww, Ww)
        negq = (qsum[0], (p_mod - qsum[1]) % p_mod, qsum[2])
        Ww = _pj_add(p_mod, b3, Ww, negq)
        total = _pj_add(p_mod, b3, total, Ww)
    return _pj_to_aff(p_mod, total)


# ---------------- device pipeline ---------------- #


def _recode_signed(K: torch.Tensor, c_bits: int):
    """K (8, k, n) canonical scalar words -> keys (k*W, n) int64 in
    [0, dmax] and neg (k*W, n) bool (halo_tpu msm2.py:153-170)."""
    windows, dmax = cfg_for_c(c_bits)
    per_word = 32 // c_bits
    cmask = (1 << c_bits) - 1
    u = K.to(torch.int64) & 0xFFFFFFFF
    carry = torch.zeros_like(u[0])
    keys, negs = [], []
    for w in range(windows):
        raw = (u[w // per_word] >> ((w % per_word) * c_bits)) & cmask
        t = raw + carry
        ge = t >= dmax
        keys.append(torch.where(ge, (1 << c_bits) - t, t))
        negs.append(ge)
        carry = ge.to(torch.int64)
    k, n = K.shape[1], K.shape[2]
    return (torch.stack(keys, dim=1).reshape(k * windows, n),
            torch.stack(negs, dim=1).reshape(k * windows, n))


def _excl_prefix(p_mod: int, T: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix over the last axis of (3, 8, W2, L) points."""
    L = T.shape[-1]
    inc = T
    s = 1
    while s < L:
        inc = torch.cat((inc[..., :s], mont.ec_padd(p_mod, inc[..., s:], inc[..., :L - s])), -1)
        s *= 2
    ident = ecrows.identity_rows(p_mod, (T.shape[2], 1), T.device)
    return torch.cat((ident, inc[..., :L - 1]), -1)


def _tree_sum(p_mod: int, Q: torch.Tensor) -> torch.Tensor:
    """Sum (3, 8, W2, m) points over the last axis (m a power of two)."""
    while Q.shape[-1] > 1:
        h = Q.shape[-1] // 2
        Q = mont.ec_padd(p_mod, Q[..., :h], Q[..., h:])
    return Q


def msm_windows(p_mod: int, xy: torch.Tensor, K: torch.Tensor, c_bits: int,
                pidx: torch.Tensor | None = None) -> torch.Tensor:
    """k MSMs in one pipeline pass.  xy (16, npts) Montgomery affine table,
    K (8, k, n) canonical scalar words (n a power of two), pidx (k, n)
    table indices of each MSM's points (default: point i for scalar i).
    Returns (3, 8, k*W, 2): per window [sum_{d<dmax} Q_d, Q_dmax]."""
    windows, dmax = cfg_for_c(c_bits)
    k, n = K.shape[1], K.shape[2]
    W2 = k * windows
    L = choose_lanes(n)
    R = n // L
    dev = K.device
    keys, negs = _recode_signed(K, c_bits)
    keys_s, perm = torch.sort(keys, dim=1, stable=True)
    neg_s = negs.gather(1, perm)
    if pidx is None:
        pid = perm
    else:
        pid = pidx.to(dev).repeat_interleave(windows, dim=0).gather(1, perm)
    idx = pid.reshape(W2, L, R).permute(2, 0, 1).reshape(R, W2 * L)
    neg = neg_s.reshape(W2, L, R).permute(2, 0, 1).reshape(R, W2 * L)
    P = mont.ec_pmadd_scan(p_mod, xy, idx.to(torch.int32), neg)  # (3, 8, R, F)

    T = P[:, :, R - 1, :].reshape(3, ff.NWORDS, W2, L)
    Lx = _excl_prefix(p_mod, T)  # (3, 8, W2, L)

    queries = torch.arange(dmax + 1, device=dev, dtype=keys_s.dtype).expand(W2, dmax + 1)
    cnt = torch.searchsorted(keys_s.contiguous(), queries.contiguous(), right=True)
    r = cnt - 1
    valid = r >= 0
    rc = r.clamp(min=0)
    lq = rc // R
    tq = rc % R
    col = torch.arange(W2, device=dev).reshape(W2, 1) * L + lq
    Pg = P.reshape(3, ff.NWORDS, -1)[:, :, (tq * (W2 * L) + col).reshape(-1)]
    Pg = Pg.reshape(3, ff.NWORDS, W2, dmax + 1)
    Lxg = torch.gather(Lx, 3, lq.expand(3, ff.NWORDS, W2, dmax + 1))
    Q = mont.ec_padd(p_mod, Lxg, Pg)
    Q = ecrows.select_rows(valid, Q, ecrows.identity_rows(p_mod, (W2, dmax + 1), dev))
    Qsum = _tree_sum(p_mod, Q[..., :dmax])
    return torch.cat((Qsum, Q[..., dmax:]), -1)


def _windows_to_host(S: torch.Tensor, k: int, windows: int):
    """(3, 8, k*W, 2) -> per MSM, per window, ((X,Y,Z) sum, (X,Y,Z) top)."""
    pts = ecrows.to_projective_ints(S)  # row-major over (k*W, 2)
    out = []
    for i in range(k):
        out.append([(pts[2 * (i * windows + w)], pts[2 * (i * windows + w) + 1])
                    for w in range(windows)])
    return out


def msm_multi(cfg: CurveCfg, xy: torch.Tensor, K: torch.Tensor,
              pidx: torch.Tensor | None = None, c_bits: int | None = None) -> list[Affine]:
    """k MSMs over one table; K (8, k, n) canonical scalar words."""
    k, n = K.shape[1], K.shape[2]
    c_bits = c_bits or choose_c(n)
    windows, _ = cfg_for_c(c_bits)
    k_max = max(1, PREFIX_BYTES_CAP // (windows * n * 96))
    outs: list[Affine] = []
    for j0 in range(0, k, k_max):
        sub = K[:, j0:j0 + k_max]
        psub = None if pidx is None else pidx[j0:j0 + k_max]
        S = msm_windows(cfg.p, xy, sub, c_bits, psub)
        for win in _windows_to_host(S, sub.shape[1], windows):
            outs.append(_combine_host(cfg, win, c_bits))
    return outs


def _pad_scalars(K: torch.Tensor, n: int) -> torch.Tensor:
    if K.shape[-1] == n:
        return K
    pad = torch.zeros((*K.shape[:-1], n - K.shape[-1]), dtype=K.dtype, device=K.device)
    return torch.cat((K, pad), -1)


def msm2_srs_rows_multi(cfg: CurveCfg, K: torch.Tensor) -> list[Affine]:
    """k SRS MSMs: K (8, k, n_req) canonical scalar words on the device;
    scalar i multiplies SRS generator i."""
    from ..srs import srs_pack

    n = pad_pow2(K.shape[-1])
    xy = srs_pack(cfg.name, n, K.device)
    return msm_multi(cfg, xy, _pad_scalars(K, n))


def msm2_srs_rows(cfg: CurveCfg, K: torch.Tensor) -> Affine:
    """One SRS MSM: K (8, n_req) canonical scalar words."""
    return msm2_srs_rows_multi(cfg, K[:, None])[0]


def msm2_srs(cfg: CurveCfg, scalars: list[int], device) -> Affine:
    """MSM of host scalars against the first len(scalars) SRS generators."""
    if not scalars:
        return None
    K = ff.to_rows([s % cfg.r for s in scalars], device)
    return msm2_srs_rows(cfg, K)


def pack_explicit(cfg: CurveCfg, scalars: list[int], points: list[Affine], n: int, device):
    """(xy (16, n) Montgomery table, K (8, n) canonical scalar words) of
    explicit affine points, padded to n; an identity (None, or a pad) is
    a genuine point, (-1, 2), with a zero scalar."""
    gx, gy = cfg.p - 1, 2
    n_req = len(scalars)
    pts = list(points[:n_req]) + [None] * (n - n_req)
    xy = ecrows.pack_points(cfg.p, [gx if q is None else q[0] for q in pts],
                            [gy if q is None else q[1] for q in pts], device)
    ks = [0 if q is None else s % cfg.r for s, q in zip(list(scalars) + [0] * (n - n_req), pts)]
    return xy, ff.to_rows(ks, device)


def msm2(cfg: CurveCfg, scalars: list[int], points: list[Affine], device) -> Affine:
    """General MSM over explicit affine points (None = identity)."""
    if not scalars:
        return None
    xy, K = pack_explicit(cfg, scalars, points, pad_pow2(len(scalars)), device)
    return msm_multi(cfg, xy, K[:, None])[0]
