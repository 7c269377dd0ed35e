"""halo_tpu_torch.ops.mont and ops.poseidon: the kernel wrappers' plain
versions against exact ints, halo_tpu.curves and halo_tpu.poseidon, the
CUDA field constants against halo_tpu.fields, and (on a card only) each
kernel against its plain version, the Schnorr batch's verdicts on the
card against the CPU's, and the launch counts of many threads on streams
of their own.

Tolerance: zero.  Field values are compared as ints, points as affine
ints (projective coordinates of equal points may differ by a scale).
"""

import os
import random
import re
import sys
import threading
from pathlib import Path

import pytest
import torch

from halo_tpu.curves import PALLAS, VESTA, ec_add, ec_mul
from halo_tpu.fields import FP_MOD, FQ_MOD, two_adic_root_of_unity
from halo_tpu.poseidon.sponge import permute
from halo_tpu_torch import schnorr
from halo_tpu_torch.curves import PALLAS as T_PALLAS
from halo_tpu_torch.ops import ecrows, ff, kernels, mont, ntt, poseidon

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R256 = 1 << 256
CURVES = (PALLAS, VESTA)
MODS = (FP_MOD, FQ_MOD)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _vals(m, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(m) for _ in range(n - 3)] + [0, 1, m - 1]


def _points(cfg, count, seed):
    rng = random.Random(seed)
    return [ec_mul(cfg, cfg.generator, rng.randrange(1, cfg.r)) for _ in range(count)]


def _proj_rows(cfg, pts, device="cpu"):
    p = cfg.p
    X = [0 if q is None else q[0] * R256 % p for q in pts]
    Y = [R256 % p if q is None else q[1] * R256 % p for q in pts]
    Z = [0 if q is None else R256 % p for q in pts]
    return torch.stack([ff.to_rows(v, device) for v in (X, Y, Z)])


def _affine(cfg, P):
    p = cfg.p
    out = []
    for X, Y, Z in ecrows.to_projective_ints(P):
        out.append(None if Z % p == 0 else (X * pow(Z, -1, p) % p, Y * pow(Z, -1, p) % p))
    return out


def _edge_pairs(cfg):
    """identity, equal, opposite, negated and generic lanes."""
    a, b, c, d = _points(cfg, 4, 7)
    neg_a = (a[0], (-a[1]) % cfg.p)
    P = [None, a, None, a, a, neg_a, b, c]
    Q = [b, None, None, a, neg_a, neg_a, c, d]
    return P, Q


def _check_field_mul_plain_and_broadcast(m):
    a, b = _vals(m, 200, 1), _vals(m, 200, 2)
    ra, rb = ff.to_rows(a, "cpu"), ff.to_rows(b, "cpu")
    rinv = pow(R256, -1, m)
    assert ff.from_rows(mont.field_mul(m, ra, rb)) == [x * y * rinv % m for x, y in zip(a, b)]
    # mulc: one broadcast element, on either side
    c = b[7]
    want = [x * c * rinv % m for x in a]
    assert ff.from_rows(mont.field_mul(m, ra, rb[:, 7:8])) == want
    assert ff.from_rows(mont.field_mul(m, rb[:, 7:8], ra)) == want
    with pytest.raises(ValueError):
        mont.field_mul(m, ra, rb[:, :100])


def _check_ntt_butterfly_plain(m):
    half, blocks, stride = 8, 4, 2
    x = _vals(m, 2 * half * blocks, 3)
    tw = _vals(m, half * stride, 4)
    y = ff.from_rows(mont.ntt_butterfly(m, ff.to_rows(x, "cpu"), ff.to_rows(tw, "cpu"),
                                        half, stride))
    rinv = pow(R256, -1, m)
    for blk in range(blocks):
        for j in range(half):
            e, o = x[blk * 2 * half + j], x[blk * 2 * half + j + half]
            t = o * tw[j * stride] * rinv % m
            assert y[blk * 2 * half + j] == (e + t) % m
            assert y[blk * 2 * half + j + half] == (e - t) % m


def _dit_stages_host(m, v, log_n, s0, j, inverse):
    """Radix-2 DIT stages s0 + 1 .. s0 + j of each size-2^log_n transform
    along v, on ints: the input read bit-reversed when s0 = 0; stage s
    multiplies by powers of w^(n/2^s), w halo_tpu's 2^log_n root (its
    inverse for an inverse).  Montgomery words are R times values, and the
    butterflies and twiddles act on both alike, so v may be the words."""
    n = 1 << log_n
    w = two_adic_root_of_unity(m, log_n)
    w = pow(w, -1, m) if inverse else w
    out = []
    for base in range(0, len(v), n):
        a = v[base:base + n]
        if s0 == 0:
            a = [a[int(f"{i:0{log_n}b}"[::-1], 2)] for i in range(n)]
        for s in range(s0 + 1, s0 + j + 1):
            h, ws = 1 << (s - 1), pow(w, n >> s, m)
            for b in range(0, n, 2 * h):
                wk = 1
                for k in range(h):
                    e, t = a[b + k], a[b + k + h] * wk % m
                    a[b + k], a[b + k + h] = (e + t) % m, (e - t) % m
                    wk = wk * ws % m
        out += a
    return out


def _check_ntt_pass_plain(m):
    """ntt_pass (on the CPU: its plain version) against the radix-2 stages
    on ints, pass by pass over a (8, 3 * 2^6) batch of an inverse split
    (2, 3, 1), the n^-1 of its last pass included; plans the kernel
    cannot run raise."""
    log_n, n = 6, 64
    v = _vals(m, 3 * n, 5)
    x = ff.to_rows(v, "cpu")
    tw, n_inv = ntt._plan_dev(m, log_n, True, torch.device("cpu"))
    got, want = x, v
    for s0, j in ((0, 2), (2, 3), (5, 1)):
        got = mont.ntt_pass(m, got, tw, log_n, s0, j, n_inv if s0 == 5 else None)
        want = _dit_stages_host(m, want, log_n, s0, j, True)
        if s0 == 5:
            want = [a * pow(n, -1, m) % m for a in want]
        assert ff.from_rows(got) == want, (s0, j)
    for s0, j in ((0, 7), (5, 2)):  # past stage log_n
        with pytest.raises(ValueError):
            mont.ntt_pass(m, x, tw, log_n, s0, j)
    big = torch.zeros((8, 1 << 11), dtype=torch.int32)
    with pytest.raises(ValueError):  # a tile of 8 x 2^8 elements > 2^10
        mont.ntt_pass(m, big, big[:, :1 << 10].t(), 11, 3, 8)


def _check_ec_padd_plain_edge_lanes(cfg):
    P, Q = _edge_pairs(cfg)
    S = mont.ec_padd(cfg.p, _proj_rows(cfg, P), _proj_rows(cfg, Q))
    assert _affine(cfg, S) == [ec_add(cfg, x, y) for x, y in zip(P, Q)]


def _check_ec_pmadd_scan_plain(cfg):
    pts = _points(cfg, 5, 11)
    a = pts[0]
    # lanes: generic; equal then opposite (prefix returns to the identity);
    # negated points
    pts.append((a[0], (-a[1]) % cfg.p))
    xy = torch.cat([ff.to_rows([q[0] * R256 % cfg.p for q in pts], "cpu"),
                    ff.to_rows([q[1] * R256 % cfg.p for q in pts], "cpu")])
    idx = torch.tensor([[1, 0, 2], [2, 0, 2], [3, 5, 4], [4, 5, 1]], dtype=torch.int32)
    neg = torch.tensor([[0, 0, 1], [1, 0, 1], [0, 0, 0], [0, 1, 1]], dtype=torch.bool)
    out = mont.ec_pmadd_scan(cfg.p, xy, idx, neg)
    assert out.shape == (3, 8, 4, 3)
    for f in range(3):
        acc = None
        for t in range(4):
            q = pts[idx[t, f]]
            if neg[t, f]:
                q = (q[0], (-q[1]) % cfg.p)
            acc = ec_add(cfg, acc, q)
            assert _affine(cfg, out[:, :, t, f:f + 1]) == [acc], (t, f)


def _check_identity_and_select_rows():
    ident = ecrows.identity_rows(FQ_MOD, (2, 3), "cpu")
    assert ident.shape == (3, 8, 2, 3)
    assert _affine(PALLAS, ident.reshape(3, 8, 6)) == [None] * 6
    P = _proj_rows(PALLAS, _points(PALLAS, 2, 5))
    mask = torch.tensor([True, False])
    sel = ecrows.select_rows(mask, P, ecrows.identity_rows(FQ_MOD, (2,), "cpu"))
    assert _affine(PALLAS, sel)[1] is None and _affine(PALLAS, sel)[0] == _affine(PALLAS, P)[0]


def _check_field_cuh_constants():
    """The moduli, Montgomery one, 3b*R and -p^-1 mod 2^32 that the CUDA
    field core hard-codes match halo_tpu.fields."""
    src = (Path(kernels.CSRC) / "field.cuh").read_text()

    def table(name):
        body = re.search(rf"{name}\[2\](?:\[8\])? = \{{(.*?)\}};", src, re.S).group(1)
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)]
        return words

    def to_int(ws):
        return sum(w << (32 * i) for i, w in enumerate(ws))

    mods, ones, b3s = table("MOD"), table("ONE"), table("B3")
    for fid, m in enumerate((FP_MOD, FQ_MOD)):
        assert to_int(mods[8 * fid: 8 * fid + 8]) == m
        assert to_int(ones[8 * fid: 8 * fid + 8]) == R256 % m
        assert to_int(b3s[8 * fid: 8 * fid + 8]) == 15 * R256 % m
        assert table("N0")[fid] == (-pow(m, -1, 1 << 32)) % (1 << 32)
        assert ff.field_id(m) == fid


def _check_wrappers_take_plain_version_only_on_cpu():
    # a tensor neither on the CPU nor on a CUDA card is refused, never
    # computed by the plain version
    a = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    P = torch.zeros((3, 8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mont.field_mul(FP_MOD, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ntt_butterfly(FP_MOD, a, a, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ntt_pass(FP_MOD, a, torch.zeros((2, 8), dtype=torch.int32, device="meta"), 2, 0, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ec_padd(FQ_MOD, P, P)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ec_pmadd(FQ_MOD, P, torch.zeros((16, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ec_pdbl(FQ_MOD, P)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.ec_smul(FQ_MOD, torch.zeros((16, 1), dtype=torch.int32, device="meta"), a)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.field_add(FP_MOD, a, a[:, :1])
    with pytest.raises(ValueError, match="unsupported device"):
        mont.field_sub(FQ_MOD, a[:, :1], a)
    with pytest.raises(ValueError, match="unsupported device"):
        poseidon.permute_batch(FQ_MOD, P)


def _check_kernel_sources_not_built_on_import():
    # importing the wrappers builds nothing; the library path is derived
    # from the sources alone
    assert kernels.library_path().name.startswith("libhalo_kernels-")
    assert set(kernels.counts()) == {"field_mul", "ntt_butterfly", "ec_padd", "ec_pmadd_scan",
                                     "ec_pmadd", "ec_pdbl", "ec_smul", "field_add", "field_sub",
                                     "poseidon_permute", "ntt_pass"}


def _check_poseidon_permute_plain():
    """permute_ints on the CPU (the kernel's plain version) against
    halo_tpu's host permute: tests/test_ops_poseidon.py's 9 seeded states
    a field, the zero state first."""
    rng = random.Random(5)
    for m in MODS:
        states = [[rng.randrange(m) for _ in range(3)] for _ in range(9)]
        states[0] = [0, 0, 0]
        assert poseidon.permute_ints(m, states, "cpu") == [permute(list(st), m) for st in states]


# ---------------- on the card: each kernel against its plain version ----------------


def _subtract_pairs(m, count, seed):
    """Pairs whose Montgomery product (a*b + M*m) / 2^256, M = -a*b/m mod
    2^256, lands in [m, 2m): the field core's final subtract fires."""
    rng = random.Random(seed)
    minv = -pow(m, -1, R256) % R256
    out = []
    while len(out) < count:
        a, b = rng.randrange(m), rng.randrange(m)
        if (a * b + (a * b * minv % R256) * m) >> 256 >= m:
            out.append((a, b))
    return out


def _check_cuda_field_mul(cuda_device, m):
    a = ff.to_rows(_vals(m, 4099, 1), cuda_device)
    b = ff.to_rows(_vals(m, 4099, 2), cuda_device)
    before = kernels.counts()["field_mul"]
    got = mont.field_mul(m, a, b)
    assert kernels.counts()["field_mul"] == before + 1
    assert got.equal(mont.field_mul_plain(m, a, b))
    assert mont.field_mul(m, a, b[:, :1]).equal(mont.field_mul_plain(m, a, b[:, :1]))
    # edge values against each other, and products on the final subtract
    edge = [0, 1, m - 1]
    pairs = [(x, y) for x in edge for y in edge] + _subtract_pairs(m, 64, 9)
    xr = ff.to_rows([x for x, _ in pairs], cuda_device)
    yr = ff.to_rows([y for _, y in pairs], cuda_device)
    got = mont.field_mul(m, xr, yr)
    assert got.equal(mont.field_mul_plain(m, xr, yr))
    assert ff.from_rows(got) == [x * y * pow(R256, -1, m) % m for x, y in pairs]


def _check_cuda_field_add_sub(cuda_device, m):
    """field_add and field_sub against their plain versions: whole rows,
    either operand broadcast, lane-contiguous views read in place, the
    edge values (sums on the conditional subtract, differences that add m
    back), and a view the wrapper has to copy."""
    edge = [0, 1, m - 1]
    rng = random.Random(m % 991)
    hi = [rng.randrange(m // 2, m) for _ in range(32)]
    xs = [x for x in edge for _ in edge] + hi + [rng.randrange(m) for _ in range(4099 - 41)]
    ys = edge * 3 + hi[::-1] + [rng.randrange(m) for _ in range(4099 - 41)]
    a, b = ff.to_rows(xs, cuda_device), ff.to_rows(ys, cuda_device)
    stack_a, stack_b = a[:, :4096].reshape(8, 4, 1024), b[:, :4096].reshape(8, 4, 1024)
    forms = [(a, b), (a, b[:, 5:6]), (b[:, 5:6], a), (a[:, :2049], a[:, 2049:4098]),
             (stack_a[:, :3], stack_b[:, 1:]), (stack_a[:, 1:], b[:, 7:8]),
             (a[:, :4096].reshape(8, 64, 64).transpose(1, 2), stack_b.reshape(8, 64, 64))]
    for name, fn, plain in (("field_add", mont.field_add, mont.field_add_plain),
                            ("field_sub", mont.field_sub, mont.field_sub_plain)):
        for x, y in forms:
            launches, copies = kernels.counts()[name], kernels.copies()[name]
            got = fn(m, x, y)
            assert kernels.counts()[name] == launches + 1
            in_place = x[0].is_contiguous() and y[0].is_contiguous()
            assert kernels.copies()[name] == copies + (0 if in_place else 1)
            assert got.equal(plain(m, x, y)), (name, tuple(x.shape), tuple(y.shape))
    got = ff.from_rows(mont.field_neg(m, a))
    assert got == [(-x) % m for x in xs]


def _check_cuda_ntt_butterfly(cuda_device, m):
    x = ff.to_rows(_vals(m, 4096, 3), cuda_device)
    tw = ff.to_rows(_vals(m, 1024, 4), cuda_device)
    for half, stride in ((1, 512), (64, 8), (1024, 1)):
        got = mont.ntt_butterfly(m, x, tw, half, stride)
        assert got.equal(mont.ntt_butterfly_plain(m, x, tw, half, stride))


def _check_cuda_ntt_pass(cuda_device, m):
    """ntt_pass against its plain version word for word, pass by pass:
    through ntt.ntt's plans for n = 2^1 .. 2^20 (at most 3 launches a
    transform, later passes of 1 to 7 stages), and launched directly over
    the plan _passes(12, 5) (later passes of 2 stages); a k = 3 batch and
    an inverse at each size; no ntt_butterfly launch; a plan the kernel
    cannot hold is refused by its C entry."""
    g = torch.Generator(device=cuda_device).manual_seed(m % 1009)
    for log_n, k, forced in [(L, 3 if L in (6, 12, 18) else 1, None) for L in range(1, 21)] \
            + [(12, 2, ntt._passes(12, 5))]:
        n = 1 << log_n
        x = torch.randint(-2**31, 2**31 - 1, (8, k * n), generator=g, device=cuda_device,
                          dtype=torch.int32)
        x[7] &= 0x3FFFFFFF  # canonical: below 2^254 < m
        for inverse in (False, True):
            tw, n_inv = ntt._plan_dev(m, log_n, inverse, x.device)
            plan = forced or ntt._passes(log_n)
            scales = [None] * (len(plan) - 1) + [n_inv]
            before = kernels.counts()
            if forced is None:
                assert len(plan) <= 3, plan
                got = ntt.ntt(m, x.reshape(8, k, n), inverse).reshape(8, k * n)
            else:
                got = x
                for (s0, j), scale in zip(plan, scales):
                    got = mont.ntt_pass(m, got, tw, log_n, s0, j, scale)
            after = kernels.counts()
            assert after["ntt_pass"] - before["ntt_pass"] == len(plan)
            assert after["ntt_butterfly"] == before["ntt_butterfly"]
            y = x
            for (s0, j), scale in zip(plan, scales):
                y = mont.ntt_pass_plain(m, y, tw, log_n, s0, j, scale)
            assert got.equal(y), (log_n, k, plan, inverse)
    x = torch.zeros((8, 1 << 11), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="ntt_pass failed to launch"):
        kernels.launch("ntt_pass", x, x, x, None, 1 << 11, 11, 3, 8, ff.field_id(m))


def _check_cuda_ec_kernels(cuda_device, cfg):
    P, Q = _edge_pairs(cfg)
    Pr, Qr = _proj_rows(cfg, P, cuda_device), _proj_rows(cfg, Q, cuda_device)
    assert mont.ec_padd(cfg.p, Pr, Qr).equal(mont.ec_padd_plain(cfg.p, Pr, Qr))
    pts = _points(cfg, 16, 3)
    xy = torch.cat([ff.to_rows([q[0] * R256 % cfg.p for q in pts], cuda_device),
                    ff.to_rows([q[1] * R256 % cfg.p for q in pts], cuda_device)])
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 16, (6, 300), generator=g, dtype=torch.int32).to(cuda_device)
    neg = (torch.rand((6, 300), generator=g) < 0.5).to(cuda_device)
    got = mont.ec_pmadd_scan(cfg.p, xy, idx, neg)
    assert got.equal(mont.ec_pmadd_scan_plain(cfg.p, xy, idx, neg))
    # depths 16 and 64 with lane counts that leave dead lanes in the last
    # warp, and a batched commitment's width (one thread a lane)
    for R, F in ((16, 2049), (64, 16383), (2, 1 << 19)):
        idx = torch.randint(0, 16, (R, F), generator=g, dtype=torch.int32).to(cuda_device)
        neg = (torch.rand((R, F), generator=g) < 0.5).to(cuda_device)
        got = mont.ec_pmadd_scan(cfg.p, xy, idx, neg)
        assert got.equal(mont.ec_pmadd_scan_plain(cfg.p, xy, idx, neg)), (R, F)
    # ec_padd at each thread-group size it picks by width on 132 SMs: the
    # IVC step's 16,384 lanes and the narrowest two-thread width, 8,449
    # (G = 2); a _tree_sum level's width and an odd width (G = 4)
    for lanes in (16384, 8449, 2048, 1025):
        reps = lanes // Pr.shape[-1] + 1
        Pw = Pr.repeat(1, 1, reps)[..., :lanes].contiguous()
        Qw = Qr.roll(1, -1).repeat(1, 1, reps)[..., :lanes].contiguous()
        assert mont.ec_padd(cfg.p, Pw, Qw).equal(mont.ec_padd_plain(cfg.p, Pw, Qw)), lanes
    # ec_pmadd per lane and with one broadcast point, ec_pdbl on the edge lanes
    Qa = [a if a is not None else pts[0] for a in Q]
    Qxy = torch.cat([ff.to_rows([q[0] * R256 % cfg.p for q in Qa], cuda_device),
                     ff.to_rows([q[1] * R256 % cfg.p for q in Qa], cuda_device)])
    for operand in (Qxy, Qxy[:, 1:2].contiguous()):
        assert mont.ec_pmadd(cfg.p, Pr, operand).equal(mont.ec_pmadd_plain(cfg.p, Pr, operand))
    assert mont.ec_pdbl(cfg.p, Pr).equal(mont.ec_pdbl_plain(cfg.p, Pr))
    # ec_smul at a width of each thread-group size it builds (on 132 SMs:
    # 16,897 lanes G = 1, 8,449 G = 2, 1,025 G = 4), one broadcast base and
    # per-lane bases, the edge scalars first: 0, 1, 2, r - 1, r, r + 1,
    # r + 2, 2^255 - 1 and 2^256 - 1 (bit 255 is not read)
    r = cfg.r
    edge = [0, 1, 2, r - 1, r, r + 1, r + 2, (1 << 255) - 1, (1 << 256) - 1]
    rng = random.Random(cfg.p % 997)
    for lanes in (16897, 8449, 1025):
        k = ff.to_rows(edge + [rng.randrange(R256) for _ in range(lanes - len(edge))],
                       cuda_device)
        bases = xy.repeat(1, lanes // 16 + 1)[:, :lanes].contiguous()
        for operand in (bases, xy[:, :1].contiguous()):
            before = kernels.counts()["ec_smul"]
            got = mont.ec_smul(cfg.p, operand, k)
            assert kernels.counts()["ec_smul"] == before + 1
            assert got.equal(mont.ec_smul_plain(cfg.p, operand, k)), lanes
    want = [ec_mul(cfg, pts[0], kk % (1 << 255)) for kk in edge]
    assert _affine(cfg, got[..., :len(edge)]) == want


def test_plain_versions():
    for m in MODS:
        _check_field_mul_plain_and_broadcast(m)
        _check_ntt_butterfly_plain(m)
        _check_ntt_pass_plain(m)
    for cfg in CURVES:
        _check_ec_padd_plain_edge_lanes(cfg)
        _check_ec_pmadd_scan_plain(cfg)
    _check_identity_and_select_rows()
    _check_field_cuh_constants()
    _check_wrappers_take_plain_version_only_on_cpu()
    _check_kernel_sources_not_built_on_import()
    _check_poseidon_permute_plain()


def _check_cuda_poseidon_permute(cuda_device, m):
    """poseidon_permute against its plain version word for word at N = 1,
    7, 10 (one warp's states), 11 (a state in a second warp) and 8195
    (the zero state and p - 1 words first)."""
    rng = random.Random(m % 983)
    for n in (1, 7, 10, 11, 8195):
        vals = [0, 0, 0, m - 1, m - 1, m - 1] + [rng.randrange(m) for _ in range(3 * n)]
        st = ff.to_rows(vals[:3 * n], cuda_device).reshape(8, n, 3).permute(2, 0, 1).contiguous()
        before = kernels.counts()["poseidon_permute"]
        got = poseidon.permute_batch(m, st)
        assert kernels.counts()["poseidon_permute"] == before + 1
        assert got.equal(poseidon.poseidon_permute_plain(m, st)), n


def _check_cuda_schnorr_batch(cuda_device):
    """sign_batch and verify_batch on the card: the signatures verify on the
    host, and the verdicts (with a flipped s, a changed message and a
    swapped R) equal the CPU path's."""
    rng = random.Random(1001)
    cfg = T_PALLAS
    sk, pk = schnorr.generate_keypair(cfg, rng)
    msgs = [[rng.randrange(cfg.p) for _ in range(10)] for _ in range(6)]
    sigs = schnorr.sign_batch(cfg, sk, msgs, cuda_device, rng=rng)
    assert all(schnorr.verify(cfg, pk, m, s) for m, s in zip(msgs, sigs))
    sigs[1] = schnorr.SchnorrSignature(r=sigs[1].r, s=(sigs[1].s + 1) % cfg.r)
    msgs[3] = [(msgs[3][0] + 1) % cfg.p] + msgs[3][1:]
    sigs[4] = schnorr.SchnorrSignature(r=sigs[0].r, s=sigs[4].s)
    got = schnorr.verify_batch(cfg, pk, msgs, sigs, cuda_device)
    assert got == schnorr.verify_batch(cfg, pk, msgs, sigs, "cpu")
    assert got == [True, False, True, False, False, True]


def _check_cuda_launches_from_threads(cuda_device):
    """Sixteen threads, each on a stream of its own (as the provers of
    parallel/pipeline.py), launch field_mul 50 times each with a short
    switch interval: every result is right, each thread counts its own 50
    (kernels.thread_launches) and the total grows by exactly 800."""
    m, per, n_threads = FP_MOD, 50, 16
    a = ff.to_rows(_vals(m, 1024, 5), cuda_device)
    want = mont.field_mul_plain(m, a, a)
    before = kernels.counts()["field_mul"]
    mine, wrong = [], []

    def work():
        stream = torch.cuda.Stream(cuda_device)
        stream.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(stream):
            start = kernels.thread_launches("field_mul")
            outs = [mont.field_mul(m, a, a) for _ in range(per)]
            stream.synchronize()
            mine.append(kernels.thread_launches("field_mul") - start)
            wrong.extend(i for i, out in enumerate(outs) if not out.equal(want))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert mine == [per] * n_threads and not wrong
    assert kernels.counts()["field_mul"] == before + per * n_threads


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    for m in MODS:
        _check_cuda_field_mul(cuda_device, m)
        _check_cuda_field_add_sub(cuda_device, m)
        _check_cuda_ntt_butterfly(cuda_device, m)
        _check_cuda_ntt_pass(cuda_device, m)
        _check_cuda_poseidon_permute(cuda_device, m)
    for cfg in CURVES:
        _check_cuda_ec_kernels(cuda_device, cfg)
    _check_cuda_schnorr_batch(cuda_device)
    _check_cuda_launches_from_threads(cuda_device)
