"""The port's point kernels' plain versions (ec_pdbl, ec_pmadd, and the
ec_smul ladder over them) and the EC composites (scalar_mul_rows,
tree_sum_rows: msm_naive_rows; to_affine_rows), and the SRS derivation
and packed table built on them, against halo_tpu.curves, halo_tpu.srs and
halo_tpu.native.  The kernels themselves are held against these plain
versions on the card by chip_smoke.py and tests/test_torch_mont.py.

Tolerance: zero.  Points are compared as affine ints (projective
coordinates of equal points may differ by a scale), SRS tables as bytes.

One test runs every check on both curves: the number of tests the suite
collects sets pytest-xdist's batches under `--dist load`, and with them
which long JAX tests share a worker (ROADMAP, "Tier-1 budget").
"""

import os
import random

import pytest
import torch

from halo_tpu import native
from halo_tpu.curves import PALLAS, VESTA, ec_add, ec_mul, msm_host
from halo_tpu.srs import load_srs as jax_load_srs
from halo_tpu_torch import srs
from halo_tpu_torch.ops import ecrows, ff, mont

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R256 = 1 << 256
CURVES = (PALLAS, VESTA)


def _points(cfg, count, seed):
    rng = random.Random(seed)
    return [ec_mul(cfg, cfg.generator, rng.randrange(1, cfg.r)) for _ in range(count)]


def _affine_rows(cfg, pts):
    """Affine points (never the identity) -> (16, n) Montgomery rows."""
    p = cfg.p
    return torch.cat([ff.to_rows([q[0] * R256 % p for q in pts], "cpu"),
                      ff.to_rows([q[1] * R256 % p for q in pts], "cpu")])


def _proj_rows(cfg, pts):
    p = cfg.p
    X = [0 if q is None else q[0] * R256 % p for q in pts]
    Y = [R256 % p if q is None else q[1] * R256 % p for q in pts]
    Z = [0 if q is None else R256 % p for q in pts]
    return torch.stack([ff.to_rows(v, "cpu") for v in (X, Y, Z)])


def _neg(cfg, q):
    return (q[0], (-q[1]) % cfg.p)


def _check_pdbl_and_pmadd_plain_edge_lanes(cfg):
    """Lanes: identity + Q, P + P (doubling), P + (-P) (identity), generic;
    doubling of the identity, of a point, and of a generic point; and the
    broadcast form of the mixed add (one point for every lane)."""
    a, b, c, d = _points(cfg, 4, 7)
    P = [None, a, a, b, c]
    Q = [a, a, _neg(cfg, a), c, d]
    Pr = _proj_rows(cfg, P)
    got = ecrows.to_affine_ints(cfg.p, mont.ec_pmadd(cfg.p, Pr, _affine_rows(cfg, Q)))
    assert got == [ec_add(cfg, x, y) for x, y in zip(P, Q)]
    got = ecrows.to_affine_ints(cfg.p, mont.ec_pmadd(cfg.p, Pr, _affine_rows(cfg, [a])))
    assert got == [ec_add(cfg, x, a) for x in P]
    got = ecrows.to_affine_ints(cfg.p, mont.ec_pdbl(cfg.p, Pr))
    assert got == [ec_add(cfg, x, x) for x in P]
    # a doubled point that is then doubled again stays exact (lazy bounds)
    twice = mont.ec_pdbl(cfg.p, mont.ec_pdbl(cfg.p, Pr))
    assert ecrows.to_affine_ints(cfg.p, twice) == [ec_mul(cfg, x, 4) if x else None for x in P]
    with pytest.raises(ValueError):
        mont.ec_pmadd(cfg.p, Pr, _affine_rows(cfg, [a, b]))


def _edge_scalars(cfg):
    """0, 1, 2, r - 1, r (the P = -Q add: the identity), r + 1, r + 2 (the
    P = Q add inside the ladder), 2^255 - 1, and 2^255 - 1 with bit 255
    also set (not read: the same point)."""
    r = cfg.r
    return [0, 1, 2, r - 1, r, r + 1, r + 2, (1 << 255) - 1, (1 << 256) - 1]


def _check_scalar_mul_broadcast_and_to_affine_rows(cfg):
    """scalar_mul_rows (the plain ec_smul ladder on the CPU) of one
    broadcast base on the edge scalars against ec_mul (per-lane bases take
    them in _check_derive_srs_and_msm_naive_rows); to_affine_rows against
    to_affine_ints on the same points, and its ValueError on an identity
    lane."""
    ks = _edge_scalars(cfg)
    base = _points(cfg, 1, 9)[0]
    S = ecrows.scalar_mul_rows(cfg.p, _affine_rows(cfg, [base]), ff.to_rows(ks, "cpu"))
    assert S.shape == (3, 8, len(ks))
    want = [ec_mul(cfg, base, k % (1 << 255)) for k in ks]
    assert ecrows.to_affine_ints(cfg.p, S) == want
    # lanes 0 and 4 are the identity; the others normalise
    live = [i for i, q in enumerate(want) if q is not None]
    assert live == [1, 2, 3, 5, 6, 7, 8]
    S_live = S[:, :, live].contiguous()
    assert ecrows.to_affine_rows(cfg.p, S_live).equal(
        _affine_rows(cfg, ecrows.to_affine_ints(cfg.p, S_live)))
    with pytest.raises(ValueError, match="lane 3 is the identity"):
        ecrows.to_affine_rows(cfg.p, S[:, :, 1:])


def _check_derive_srs_and_msm_naive_rows(cfg):
    """derive_srs at n = 2^4 (one batched scalar_mul_rows of the generator,
    a broadcast base, then to_affine_rows) gives halo_tpu.srs's S, H and
    generators, and native.ec_batch_mul's points; srs_pack's table (the
    derivation's own) equals pack_points of those generators, the route
    it replaced, word for word.  Then scalar_mul_rows of 13 of those
    generators (per-lane bases) with the edge scalars and four random ones
    against ec_mul, and tree_sum_rows of the products (13 lanes: not a
    power of two) against msm_host: msm_naive_rows, as srs.msm_naive runs
    it."""
    n = 16
    mine = srs.derive_srs(cfg.name, n, "cpu")
    ref = jax_load_srs(cfg.name, n)
    assert (mine.S, mine.H) == (ref.S, ref.H)
    assert mine.gs_x.tobytes() == ref.gs_x.tobytes()
    assert mine.gs_y.tobytes() == ref.gs_y.tobytes()
    assert srs.load_sh(cfg.name) == (ref.S, ref.H)
    gs = ref.gs_ints(n)
    packed = ecrows.pack_points(cfg.p, [q[0] for q in gs], [q[1] for q in gs], "cpu")
    assert mine.table.equal(packed)
    assert srs.srs_pack(cfg.name, n, torch.device("cpu")).equal(packed)
    assert srs.srs_pack(cfg.name, 5, torch.device("cpu")).equal(packed[:, :5])
    if native.available():
        ks = [srs._hash_scalar(cfg, i) for i in (0, 1, 2, 3)]
        assert native.ec_batch_mul(cfg, ks, [cfg.generator] * 4) == [
            mine.S, mine.H, mine.g_affine(0), mine.g_affine(1)]

    rng = random.Random(cfg.p % 1000)
    pts = ref.gs_ints(13)
    ks = _edge_scalars(cfg) + [rng.randrange(cfg.r) for _ in range(4)]
    xy = ecrows.pack_points(cfg.p, [q[0] for q in pts], [q[1] for q in pts], "cpu")
    S = ecrows.scalar_mul_rows(cfg.p, xy, ff.to_rows(ks, "cpu"))
    ks = [k % (1 << 255) for k in ks]  # bit 255 is not read
    assert ecrows.to_affine_ints(cfg.p, S) == [ec_mul(cfg, q, k) for q, k in zip(pts, ks)]
    total = ecrows.tree_sum_rows(cfg.p, S)
    assert total.shape == (3, 8, 1)
    assert ecrows.to_affine_ints(cfg.p, total) == [msm_host(cfg, ks, pts)]


def test_ec_rows_and_derive_srs_match_jax_package():
    for cfg in CURVES:
        _check_pdbl_and_pmadd_plain_edge_lanes(cfg)
        _check_scalar_mul_broadcast_and_to_affine_rows(cfg)
        _check_derive_srs_and_msm_naive_rows(cfg)
