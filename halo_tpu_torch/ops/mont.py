"""Kernel wrappers and their plain torch versions (port of the host
wrappers of halo_tpu/ops/pallas_mont.py:772-810).

Each wrapper takes the plain version for tensors on the CPU, and for CUDA
tensors launches its kernel (ops/kernels.py) or raises; there is no
fallback.  The plain versions run on any device: chip_smoke.py holds each
kernel against its plain version on the card.

| wrapper        | kernel (csrc/kernels.cu) | replaces (halo_tpu/ops/pallas_mont.py)         |
|----------------|--------------------------|------------------------------------------------|
| field_mul      | k_field_mul              | _mm_kernel :256 (mm_rows), _mulc_kernel :474    |
|                |                          | (mulc_rows: b broadcast), _canon_kernel :482    |
| ntt_butterfly  | k_ntt_butterfly          | _bfly_kernel :459 (bfly_rows)                   |
| ntt_pass       | k_ntt_pass               | _bfly_kernel :459 with the gather and the stage |
|                |                          | loop around it (halo_tpu/ops/ntt.py:211-245)    |
| ec_padd        | k_ec_padd                | _padd_kernel :261 (padd_rows)                   |
| ec_pmadd_scan  | k_ec_pmadd_scan          | _pmadd_pack_kernel :355 and the lax.scan around |
|                |                          | it (halo_tpu/ops/msm2.py:398-417)               |
| ec_pmadd       | k_ec_pmadd               | _pmadd_kernel :308 (pmadd_rows)                 |
| ec_pdbl        | k_ec_pdbl                | _pdbl_kernel :410 (pdbl_rows)                   |
| ec_smul        | k_ec_smul                | _pdbl_kernel :410 and _pmadd_kernel :308 with   |
|                |                          | the fori_loop around them                       |
|                |                          | (halo_tpu/ops/ecrows.py:60-77)                  |
| field_add      | k_field_addsub (add)     | no Pallas kernel: the XLA fusion of             |
| field_sub      | k_field_addsub (sub)     | halo_tpu/ops/ff.py add :129 and sub :134        |
|                |                          | (field_neg: sub from a broadcast zero, :148)    |

On canonical inputs field_mul, ec_padd and ec_pdbl also compute what the
v1 kernels computed: halo_tpu/ops/pallas_ff.py:_mont_mul_kernel :77 and
halo_tpu/ops/pallas_ec.py:_ec_add_kernel :110, _ec_double_kernel :149
(ec_smul's doubling step too).  ec_pmadd and ec_pdbl are the one-step
forms of ec_smul's ladder, ntt_butterfly the one-stage form of ntt_pass;
no path launches them.

scan_mul and batch_inv are composites of field_mul with no kernel of
their own: the engine's grand product and batch inverse, and the
projective-to-affine step of ops/ecrows.py.

Field values are canonical Montgomery (8, ...) int32 word rows; points
are (3, 8, ...) projective (X, Y, Z) rows over the curve's base field.
The plain EC versions follow the kernels' formulas (RCB 2015 alg. 7, its
mixed form and alg. 9, a = 0, b = 5) and batch the independent products of each
formula level into one multiplication, which gives the same values.
"""

from __future__ import annotations

import torch

from ..device import cached
from ..fields import R256

from . import ff, kernels
from .ff import NL, NWORDS

_B = 5  # both Pasta curves: y^2 = x^3 + 5
SCALAR_BITS = 255  # both Pasta scalar moduli are below 2^255


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


# ---------------- field_mul ---------------- #


def field_mul_plain(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ff.mont_mul_plain(m, a, b)


def field_mul(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod m on (8, *S) rows.  b has a's shape
    or holds one element (8 words), which every lane multiplies by (the
    TPU's mulc_rows); either operand may be the single element."""
    if a.shape[1:].numel() == 1 and b.shape[1:].numel() != 1:
        a, b = b, a
    bcast = b.shape[1:].numel() == 1
    if not bcast and b.shape != a.shape:
        raise ValueError(f"field_mul shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if _is_cpu(a):
        return field_mul_plain(m, a, b)
    a = a.contiguous()
    b = b.contiguous()
    kernels.check_cuda(a, b)
    out = torch.empty_like(a)
    n = a.shape[1:].numel()
    kernels.launch("field_mul", out, a, b, n, 1 if bcast else 0, ff.field_id(m))
    return out


# ---------------- field_add, field_sub ---------------- #


def field_add_plain(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    la, lb = ff.align(ff.words_to_limbs(a), ff.words_to_limbs(b))
    return ff.limbs_to_words(ff.canon(m, la + lb))


def field_sub_plain(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ff.limbs_to_words(ff.canon(m, ff.lsub(m, ff.words_to_limbs(a), ff.words_to_limbs(b), 1)))


def _addsub(name: str, plain, m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    na, nb = a.shape[1:].numel(), b.shape[1:].numel()
    if a.shape[0] != NWORDS or b.shape[0] != NWORDS \
            or (a.shape != b.shape and na != 1 and nb != 1):
        raise ValueError(f"{name} shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if _is_cpu(a):
        return plain(m, a, b)
    shape = b.shape if nb != 1 else a.shape
    n = shape[1:].numel()
    ops = []
    for t, count in ((a, na), (b, nb)):
        bcast = count == 1
        if not bcast and not t[0].is_contiguous():  # lanes not contiguous
            t = t.contiguous()
            kernels.count_copy(name)
        ops.append((t, t.stride(0), bcast))
    (a, sa, ba), (b, sb, bb) = ops
    kernels.check_cuda(a, b, contiguous=False)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    kernels.launch(name, out, a, b, n, sa, int(ba), sb, int(bb), ff.field_id(m))
    return out


def field_add(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod m on canonical (8, *S) word rows (Montgomery or not).
    b has a's shape, or either operand holds one element (8 words) that
    every lane adds; any other pairing raises.  Operands are read in
    place when their lanes are contiguous (a view such as x[:, :h] of an
    (8, n) row, or x[:, :k] of an (8, K, n) stack).

    Contract: canonical inputs (< m).  The kernel adds once and subtracts
    m at most once (a + b < 2m); the plain version, which widens first,
    reduces any 8-word value.  Every value on the engine's path is the
    output of a kernel or of Engine.to_dev / const (v % m), so it holds."""
    return _addsub("field_add", field_add_plain, m, a, b)


def field_sub(m: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod m; the shapes, views and contract of field_add."""
    return _addsub("field_sub", field_sub_plain, m, a, b)


def field_neg(m: int, a: torch.Tensor) -> torch.Tensor:
    """-a mod m: field_sub from one broadcast zero."""
    return field_sub(m, torch.zeros((NWORDS, 1), dtype=torch.int32, device=a.device), a)


# ---------------- ntt_butterfly ---------------- #


def ntt_butterfly_plain(m: int, x: torch.Tensor, tw: torch.Tensor, half: int,
                        tw_stride: int) -> torch.Tensor:
    M = x.shape[1]
    xl = ff.words_to_limbs(x).reshape(NL, M // (2 * half), 2, half)
    w = ff.words_to_limbs(tw[:, 0: half * tw_stride: tw_stride])[:, None, :]
    e, o = xl[:, :, 0], xl[:, :, 1]
    t = ff.lmul(m, o, w)  # < 1.3m
    y = torch.stack((e + t, ff.lsub(m, e, t, 2)), dim=2)
    return ff.limbs_to_words(ff.canon(m, y.reshape(NL, M)))


def ntt_butterfly(m: int, x: torch.Tensor, tw: torch.Tensor, half: int,
                  tw_stride: int) -> torch.Tensor:
    """One radix-2 DIT stage over (8, M) rows split into blocks of 2*half
    lanes: (e, o) -> (e + w_j*o, e - w_j*o) with w_j = tw[:, j*tw_stride]."""
    M = x.shape[1]
    if x.dim() != 2 or M % (2 * half) or (half - 1) * tw_stride >= tw.shape[1]:
        raise ValueError(f"bad butterfly shape {tuple(x.shape)}, half={half}")
    if _is_cpu(x):
        return ntt_butterfly_plain(m, x, tw, half, tw_stride)
    x = x.contiguous()
    tw = tw.contiguous()
    kernels.check_cuda(x, tw)
    y = torch.empty_like(x)
    kernels.launch("ntt_butterfly", y, x, tw, M, half, tw.shape[1], tw_stride, ff.field_id(m))
    return y


# ---------------- ntt_pass ---------------- #

NTT_TILE_LOG = 10  # csrc/kernels.cu kNttTileLog: the elements a block of ntt_pass holds
NTT_COLS_LOG = 3  # kNttColsLog: a later pass's tile is 8 low offsets x 2^j rows


@cached(64)
def bit_reverse(log_n: int, device: torch.device) -> torch.Tensor:
    """The bit-reversal permutation of range(2^log_n), as int64 indices."""
    i = torch.arange(1 << log_n, dtype=torch.int64)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev.to(device)


def ntt_pass_plain(m: int, x: torch.Tensor, tw: torch.Tensor, log_n: int, s0: int, j: int,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    n = 1 << log_n
    if s0 == 0:
        x = x.reshape(NWORDS, -1, n)[:, :, bit_reverse(log_n, x.device)].reshape(NWORDS, -1)
    for s in range(s0 + 1, s0 + j + 1):
        x = ntt_butterfly_plain(m, x, tw.t(), 1 << (s - 1), n >> s)
    return x if scale is None else field_mul_plain(m, x, scale)


def ntt_pass(m: int, x: torch.Tensor, tw: torch.Tensor, log_n: int, s0: int, j: int,
             scale: torch.Tensor | None = None) -> torch.Tensor:
    """Radix-2 DIT stages s0 + 1 .. s0 + j of the size-2^log_n transforms
    laid one after another along the (8, k * 2^log_n) rows x.  Stage s is
    ntt_butterfly with half = 2^(s-1) and w_j = tw[j * n / 2^s]; tw is the
    (n/2, 8) element-major twiddle table (one twiddle's 8 words
    contiguous).  With s0 = 0 the pass first reads each transform in
    bit-reversed order; with scale (one element, (8, 1)) it ends in
    field_mul by it.  One launch holds a tile of min(8, 2^s0) * 2^j <=
    2^NTT_TILE_LOG elements; a pass past that, or past stage log_n,
    raises."""
    n = 1 << log_n
    c_log = min(s0, NTT_COLS_LOG)
    if x.dim() != 2 or x.shape[0] != NWORDS or x.shape[1] % n or log_n < 1 \
            or tw.shape != (n // 2, NWORDS) or s0 < 0 or j < 1 or s0 + j > log_n \
            or c_log + j > NTT_TILE_LOG \
            or (scale is not None and scale.shape != (NWORDS, 1)):
        raise ValueError(f"bad NTT pass: x {tuple(x.shape)}, tw {tuple(tw.shape)}, "
                         f"log_n={log_n}, s0={s0}, j={j}")
    if _is_cpu(x):
        return ntt_pass_plain(m, x, tw, log_n, s0, j, scale)
    x, tw = x.contiguous(), tw.contiguous()
    if scale is None:
        kernels.check_cuda(x, tw)
    else:
        scale = scale.contiguous()
        kernels.check_cuda(x, tw, scale)
    y = torch.empty_like(x)
    kernels.launch("ntt_pass", y, x, tw, scale, x.shape[1], log_n, s0, j, ff.field_id(m))
    return y


# ---------------- EC: plain formulas on lazy 26-bit limbs ---------------- #
#
# Inputs are canonical (an affine y may be p itself after negating 0).
# The comments give value bounds in units of the base-field modulus p,
# using p/R < 1/4 + 2^-128: a lazy product is below a*b/R + p.  Every
# subtraction adds a multiple of p at least as large as its subtrahend.


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _split(t, n):
    return torch.split(t, n, dim=1)


def _b3(m: int, like: torch.Tensor) -> torch.Tensor:
    return ff.words_to_limbs(ff.const_rows(3 * _B * R256 % m, like.device))


def _canon_pt(m, X, Y, Z):
    n = X.shape[1]
    return _split(ff.canon(m, _cat(X, Y, Z)), n)


def _padd_l(m, P, Q):
    """RCB alg. 7 (a = 0), _padd_kernel's formula."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    n = X1.shape[1]
    b3 = _b3(m, X1).expand(NL, n)
    t0, t1, t2, m3, m4, m5 = _split(ff.lmul(  # inputs < 2p: outputs < 2.01p
        m, _cat(X1, Y1, Z1, X1 + Y1, Y1 + Z1, X1 + Z1),
        _cat(X2, Y2, Z2, X2 + Y2, Y2 + Z2, X2 + Z2)), n)
    t3 = ff.lsub(m, m3, t0 + t1, 5)  # < 7.1p
    t4 = ff.lsub(m, m4, t1 + t2, 5)
    y3 = ff.lsub(m, m5, t0 + t2, 5)
    t0 = t0 + t0 + t0  # < 6.1p
    t2, y3 = _split(ff.lmul(m, _cat(t2, y3), _cat(b3, b3)), n)  # < 2.8p
    z3 = t1 + t2  # < 4.9p
    t1 = ff.lsub(m, t1, t2, 3)  # < 5.1p
    p0, p1, p2, p3, p4, p5 = _split(ff.lmul(  # < 7.1p * 7.1p / R + p < 14p
        m, _cat(t3, t4, t1, y3, z3, t0), _cat(t1, y3, z3, t0, t4, t3)), n)
    return _canon_pt(m, ff.lsub(m, p0, p1, 16), p2 + p3, p4 + p5)


def _pmadd_l(m, P, x2, y2):
    """Mixed add (Z2 = 1, 13 products), _pmadd_pack_kernel's formula;
    (x2, y2) is never the identity."""
    X1, Y1, Z1 = P
    n = X1.shape[1]
    b3 = _b3(m, X1).expand(NL, n)
    t0, t1, m3, u4, u5, t2 = _split(ff.lmul(  # inputs < 2p, < 3p: outputs < 2.6p
        m, _cat(X1, Y1, X1 + Y1, Z1, Z1, Z1), _cat(x2, y2, x2 + y2, y2, x2, b3)), n)
    t3 = ff.lsub(m, m3, t0 + t1, 6)  # < 8.6p
    t4 = Y1 + u4  # < 3.6p
    t5 = X1 + u5
    t0 = t0 + t0 + t0  # < 7.8p
    z3 = t1 + t2  # < 5.2p
    t1 = ff.lsub(m, t1, t2, 3)  # < 5.6p
    t5 = ff.lmul(m, t5, b3)  # < 2p
    p0, p1, p2, p3, p4, p5 = _split(ff.lmul(  # < 8.6p * 7.8p / R + p < 18p
        m, _cat(t3, t4, t1, t5, z3, t0), _cat(t1, t5, z3, t0, t4, t3)), n)
    return _canon_pt(m, ff.lsub(m, p0, p1, 18), p2 + p3, p4 + p5)


def _pdbl_l(m, P):
    """RCB alg. 9 (a = 0), _pdbl_kernel's formula."""
    X, Y, Z = P
    n = X.shape[1]
    b3 = _b3(m, X).expand(NL, n)
    t0, t1, t2, xy = _split(ff.lmul(  # inputs < p: outputs < 1.26p
        m, _cat(Y, Y, Z, X), _cat(Y, Z, Z, Y)), n)
    t2 = ff.lmul(m, t2, b3)  # < 1.32p
    z8 = 8 * t0  # < 10.1p, limbs < 2^29 + 8
    x3, z3 = _split(ff.lmul(m, _cat(t2, t1), _cat(z8, z8)), n)  # < 4.4p
    y3 = t0 + t2  # < 2.6p
    t0 = ff.lsub(m, t0, 3 * t2, 4)  # < 5.3p
    y3, x3b = _split(ff.lmul(m, _cat(t0, t0), _cat(y3, xy)), n)  # < 4.4p
    return _canon_pt(m, x3b + x3b, x3 + y3, z3)


def _pt_to_limbs(P: torch.Tensor):
    return tuple(ff.words_to_limbs(P[c].reshape(NWORDS, -1)) for c in range(3))


def _pt_to_words(Pl, shape) -> torch.Tensor:
    return torch.stack([ff.limbs_to_words(c).reshape(NWORDS, *shape) for c in Pl])


# ---------------- ec_padd ---------------- #


def ec_padd_plain(p_mod: int, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    return _pt_to_words(_padd_l(p_mod, _pt_to_limbs(P), _pt_to_limbs(Q)), P.shape[2:])


def ec_padd(p_mod: int, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete projective add of (3, 8, *S) point batches over the base
    field p_mod."""
    if P.shape != Q.shape or P.shape[:2] != (3, NWORDS):
        raise ValueError(f"bad point shapes {tuple(P.shape)} {tuple(Q.shape)}")
    if _is_cpu(P):
        return ec_padd_plain(p_mod, P, Q)
    P = P.contiguous()
    Q = Q.contiguous()
    kernels.check_cuda(P, Q)
    out = torch.empty_like(P)
    kernels.launch("ec_padd", out, P, Q, P.shape[2:].numel(), ff.field_id(p_mod))
    return out


# ---------------- ec_pmadd ---------------- #


def ec_pmadd_plain(p_mod: int, P: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    n = P.shape[2]
    xl = ff.words_to_limbs(xy[:NWORDS]).expand(NL, n)
    yl = ff.words_to_limbs(xy[NWORDS:]).expand(NL, n)
    return _pt_to_words(_pmadd_l(p_mod, _pt_to_limbs(P), xl, yl), P.shape[2:])


def ec_pmadd(p_mod: int, P: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Mixed add P + (x, y) of (3, 8, n) projective points and affine
    points xy (16, n), or one affine point (16, 1) that every lane adds:
    x words in rows 0-7, y words in rows 8-15 (Montgomery, never the
    identity)."""
    if P.dim() != 3 or P.shape[:2] != (3, NWORDS) or xy.dim() != 2 \
            or xy.shape[0] != 2 * NWORDS or xy.shape[1] not in (1, P.shape[2]):
        raise ValueError(f"bad mixed-add shapes {tuple(P.shape)} {tuple(xy.shape)}")
    if _is_cpu(P):
        return ec_pmadd_plain(p_mod, P, xy)
    n = P.shape[2]
    P = P.contiguous()
    xy = xy.contiguous()
    kernels.check_cuda(P, xy)
    out = torch.empty_like(P)
    kernels.launch("ec_pmadd", out, P, xy, n, 1 if xy.shape[1] == 1 and n != 1 else 0,
                   ff.field_id(p_mod))
    return out


# ---------------- ec_pdbl ---------------- #


def ec_pdbl_plain(p_mod: int, P: torch.Tensor) -> torch.Tensor:
    return _pt_to_words(_pdbl_l(p_mod, _pt_to_limbs(P)), P.shape[2:])


def ec_pdbl(p_mod: int, P: torch.Tensor) -> torch.Tensor:
    """Complete doubling of (3, 8, *S) projective points over the base
    field p_mod."""
    if P.shape[:2] != (3, NWORDS):
        raise ValueError(f"bad point shape {tuple(P.shape)}")
    if _is_cpu(P):
        return ec_pdbl_plain(p_mod, P)
    P = P.contiguous()
    kernels.check_cuda(P)
    out = torch.empty_like(P)
    kernels.launch("ec_pdbl", out, P, P.shape[2:].numel(), ff.field_id(p_mod))
    return out


# ---------------- ec_pmadd_scan ---------------- #


def ec_pmadd_scan_plain(p_mod: int, xy: torch.Tensor, idx: torch.Tensor,
                        neg: torch.Tensor) -> torch.Tensor:
    R, F = idx.shape
    xl = ff.words_to_limbs(xy[:NWORDS])
    yl = ff.words_to_limbs(xy[NWORDS:])
    zero = torch.zeros((NL, F), dtype=torch.int64, device=xy.device)
    one = ff.words_to_limbs(ff.mont_one(p_mod, xy.device)).expand(NL, F)
    acc = (zero, one, zero)
    outs = []
    for t in range(R):
        col = idx[t].long()
        x2, y2 = xl[:, col], yl[:, col]
        y2 = torch.where(neg[t].bool(), ff.lsub(p_mod, zero, y2, 1), y2)
        acc = _pmadd_l(p_mod, acc, x2, y2)
        outs.append(acc)
    return torch.stack([
        ff.limbs_to_words(torch.stack([o[c] for o in outs], dim=1)) for c in range(3)])


def ec_pmadd_scan(p_mod: int, xy: torch.Tensor, idx: torch.Tensor,
                  neg: torch.Tensor) -> torch.Tensor:
    """Per-lane running sums of sorted affine points.

    xy (16, npts): affine points, x words in rows 0-7 and y words in rows
    8-15 (Montgomery, never the identity).  idx (R, F) int32 point
    indices, neg (R, F) bool.  Lane f starts at the identity and at step t
    adds point idx[t, f] (negated where neg[t, f]); the result (3, 8, R, F)
    holds every inclusive prefix."""
    if xy.shape[0] != 2 * NWORDS or idx.shape != neg.shape or idx.dim() != 2:
        raise ValueError("bad scan shapes")
    if _is_cpu(xy):
        return ec_pmadd_scan_plain(p_mod, xy, idx, neg)
    R, F = idx.shape
    # the kernel gathers one point as four 16-byte loads: a point-major
    # (npts, 16) copy of the table, made once per call
    xy_pm = xy.t().contiguous()
    kernels.check_cuda(xy_pm)
    idx = idx.to(torch.int32).contiguous()
    neg = neg.to(torch.uint8).contiguous()
    if idx.device != xy.device or neg.device != xy.device:
        raise ValueError("scan operands on different devices")
    out = torch.empty((3, NWORDS, R, F), dtype=torch.int32, device=xy.device)
    kernels.launch("ec_pmadd_scan", out, xy_pm, idx, neg, R, F, xy.shape[1], ff.field_id(p_mod))
    return out


# ---------------- ec_smul ---------------- #


def ec_smul_plain(p_mod: int, xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """MSB-first double-and-add over ec_pdbl_plain, ec_pmadd_plain and a
    lanewise select."""
    n = k.shape[1]
    kw = k.to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros((3, NWORDS, n), dtype=torch.int32, device=k.device)
    acc[1] = ff.mont_one(p_mod, k.device)
    for i in range(SCALAR_BITS - 1, -1, -1):
        acc = ec_pdbl_plain(p_mod, acc)
        bit = ((kw[i // 32] >> (i % 32)) & 1) == 1
        acc = torch.where(bit, ec_pmadd_plain(p_mod, acc, xy), acc)
    return acc


def ec_smul(p_mod: int, xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k[:, i] * (x_i, y_i) for n lanes, as (3, 8, n) projective points.

    xy (16, n): affine bases, x words in rows 0-7 and y words in rows 8-15
    (Montgomery, never the identity), or (16, 1): one base for every lane.
    k (8, n): scalar words; bits 254..0 are read, bit 255 is ignored."""
    if k.dim() != 2 or k.shape[0] != NWORDS or xy.dim() != 2 \
            or xy.shape[0] != 2 * NWORDS or xy.shape[1] not in (1, k.shape[1]):
        raise ValueError(f"bad scalar-mul shapes {tuple(xy.shape)} {tuple(k.shape)}")
    if _is_cpu(k):
        return ec_smul_plain(p_mod, xy, k)
    n = k.shape[1]
    xy = xy.contiguous()
    k = k.contiguous()
    kernels.check_cuda(xy, k)
    out = torch.empty((3, NWORDS, n), dtype=torch.int32, device=k.device)
    kernels.launch("ec_smul", out, xy, k, n, 1 if xy.shape[1] == 1 and n != 1 else 0,
                   ff.field_id(p_mod))
    return out


# ---------------- composites of field_mul ---------------- #


def scan_mul(m: int, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive product scan along the lanes of (8, n) Montgomery rows:
    log2(n) Hillis-Steele rounds of field_mul."""
    n = x.shape[-1]
    one = ff.mont_one(m, x.device)
    sh = 1
    while sh < n:
        ones = one.expand(NWORDS, sh)
        if reverse:
            shifted = torch.cat((x[:, sh:], ones), -1)
        else:
            shifted = torch.cat((ones, x[:, :-sh]), -1)
        x = field_mul(m, x, shifted)
        sh *= 2
    return x


def batch_inv(m: int, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (8, n) Montgomery rows (inv(0) = 0):
    Montgomery's trick with a forward and a backward product scan and one
    host inversion of the total."""
    one = ff.mont_one(m, a.device)
    zero = ff.is_zero(a)
    a_safe = torch.where(zero, one, a)
    prefix = scan_mul(m, a_safe)
    suffix = scan_mul(m, a_safe, reverse=True)
    total = ff.from_rows(field_mul(m, prefix[:, -1:], ff.const_rows(1, a.device)))[0]
    tinv = field_mul(m, ff.const_rows(pow(total, -1, m), a.device),
                     ff.const_rows(R256 * R256 % m, a.device))
    pre_excl = torch.cat((one, prefix[:, :-1]), -1)
    suf_excl = torch.cat((suffix[:, 1:], one), -1)
    out = field_mul(m, field_mul(m, pre_excl, suf_excl), tinv)
    return torch.where(zero, torch.zeros_like(out), out)
