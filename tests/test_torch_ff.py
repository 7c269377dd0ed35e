"""halo_tpu_torch.ops.ff (plain field arithmetic on word rows) and the
field_add/field_sub/field_mul wrappers of ops/mont.py (their plain
versions, on the CPU) against Python ints and halo_tpu.ops.ff, on the
same seeded inputs.

Tolerance: zero.  This is exact modular arithmetic, compared as ints.

One test runs every check: the suite's test count sets pytest-xdist's
batches under `--dist load` (ROADMAP, "Tier-1 budget").
"""

import os
import random

import numpy as np
import pytest
import torch

from halo_tpu.fields import FP_MOD, FQ_MOD
from halo_tpu.ops import ff as jff
from halo_tpu_torch import convert
from halo_tpu_torch.ops import ff, mont

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R256 = 1 << 256
N = 256
MODS = (FP_MOD, FQ_MOD)


def _vals(m, seed):
    rng = random.Random(seed)
    return [rng.randrange(m) for _ in range(N - 4)] + [0, 1, m - 1, m - 2]


def _pair(m):
    a = _vals(m, 1)
    b = list(reversed(_vals(m, 2)))
    return a, b


def _check_rows_roundtrip(m):
    a = _vals(m, 3)
    rows = ff.to_rows(a, "cpu")
    assert rows.dtype == torch.int32 and rows.shape == (8, N)
    assert ff.from_rows(rows) == a
    assert ff.limbs_to_words(ff.words_to_limbs(rows)).equal(rows)
    # halo_tpu's (N, 16) limb arrays carry the same values
    arr = jff.ints_to_array(a)
    assert convert.limbs16_to_rows(arr).equal(rows)
    assert np.array_equal(convert.rows_to_limbs16(rows), arr)


def _np_vals(m, k, seed):
    """k values below m made from seeded numpy words."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(k, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % m for row in words]


def _addsub_operands(m):
    """N lane pairs: 0, 1, m - 1 against each other, pairs whose sum needs
    the conditional subtract, pairs whose difference needs m added back,
    then seeded values."""
    edge = [0, 1, m - 1]
    hi = [x for x in _np_vals(m, 64, 5) if x >= m // 2][:16]
    lo = _np_vals(m, 32, 6)
    a = [x for x in edge for _ in edge] + hi + lo[:16]
    b = edge * 3 + list(reversed(hi)) + [x + (m - x) // 2 for x in lo[:16]]
    assert any(x + y >= m for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))
    k = N - len(a)
    return a + _np_vals(m, k, 7), b + _np_vals(m, k, 8)


def _check_add_sub_vs_ints_and_jax(m):
    """mont.field_add/field_sub/field_neg (on the CPU: their plain
    versions) against ints and halo_tpu.ops.ff.add_jit/sub_jit, on whole
    rows, with either operand one broadcast element, on word-strided
    views, and on the edge values."""
    ctx = jff.ctx_for(m)
    a, b = _addsub_operands(m)
    ra, rb = ff.to_rows(a, "cpu"), ff.to_rows(b, "cpu")

    def check(ta, tb, va, vb):
        """ta, tb: operand rows; va, vb: each lane's values, broadcast
        operands expanded."""
        aa, bb = jff.ints_to_array(va), jff.ints_to_array(vb)
        for fn, sign, jfn in ((mont.field_add, 1, jff.add_jit), (mont.field_sub, -1, jff.sub_jit)):
            got = ff.from_rows(fn(m, ta, tb))
            assert got == [(x + sign * y) % m for x, y in zip(va, vb)]
            assert got == jff.array_to_ints(np.asarray(jfn(ctx, aa, bb)))

    q = N // 4
    check(ra, rb, a, b)
    # one broadcast element on either side, as a view of a row (z[:, :1])
    check(ra, rb[:, 7:8], a, [b[7]] * N)
    check(rb[:, 7:8], ra, [b[7]] * N, a)
    # views whose lanes are contiguous at a word stride other than their
    # lane count: cs[:, :h] against cs[:, h:2h] (the IPA fold) and
    # w[:, :k] of an (8, K, n) stack (w_big[:, :S_POLYS], ws_dev[:, 0:3])
    check(ra[:, :N // 2], ra[:, N // 2:], a[:N // 2], a[N // 2:])
    check(ra.reshape(8, 4, q)[:, :3], rb.reshape(8, 4, q)[:, 1:], a[:3 * q], b[q:])
    check(ra.reshape(8, 4, q)[:, 1:], rb[:, 3:4], a[q:], [b[3]] * (3 * q))
    assert ff.from_rows(mont.field_neg(m, ra)) == [(-x) % m for x in a]
    assert ff.from_rows(mont.field_neg(m, ra)) == jff.array_to_ints(
        np.asarray(jff.sub_jit(ctx, jff.ints_to_array([0] * N), jff.ints_to_array(a))))
    # any other shape pairing raises, as field_mul's does
    for x, y in ((ra, rb[:, :100]), (ra.reshape(8, 4, q), rb.reshape(8, q, 4)),
                 (ra[:, :2], rb[:, :3])):
        for fn in (mont.field_add, mont.field_sub):
            with pytest.raises(ValueError):
                fn(m, x, y)


def _check_mont_mul_vs_ints_and_jax(m):
    a, b = _pair(m)
    got = ff.from_rows(mont.field_mul(m, ff.to_rows(a, "cpu"), ff.to_rows(b, "cpu")))
    rinv = pow(R256, -1, m)
    assert got == [x * y * rinv % m for x, y in zip(a, b)]
    ctx = jff.ctx_for(m)
    jgot = jff.mont_mul_jit(ctx, jff.ints_to_array(a), jff.ints_to_array(b))
    assert got == jff.array_to_ints(np.asarray(jgot))


def _check_to_mont_vs_jax(m):
    a = _vals(m, 4)
    r2 = ff.const_rows(R256 * R256 % m, "cpu")
    got = ff.from_rows(mont.field_mul(m, ff.to_rows(a, "cpu"), r2))
    assert got == [x * R256 % m for x in a]
    jgot = jff.to_mont_jit(jff.ctx_for(m), jff.ints_to_array(a))
    assert got == jff.array_to_ints(np.asarray(jgot))
    # the Montgomery rows are the JAX package's Montgomery limbs, bit for bit
    assert convert.limbs16_to_rows(np.asarray(jgot)).equal(ff.to_rows(got, "cpu"))


def _check_lazy_limbs_edge_values(m):
    """Sums and differences far from canonical (the plain EC formulas keep
    values lazy up to ~2^259) still reduce exactly."""
    a, b = _pair(m)
    la = ff.words_to_limbs(ff.to_rows(a, "cpu"))
    lb = ff.words_to_limbs(ff.to_rows(b, "cpu"))
    big = la + la + la + lb  # < 4m
    prod = ff.lmul(m, big, ff.lsub(m, la, lb, 8))  # (< 4m) * (< 9m)
    rinv = pow(R256, -1, m)
    want = [(3 * x + y) * (x - y + 8 * m) * rinv % m for x, y in zip(a, b)]
    assert ff.from_rows(ff.limbs_to_words(ff.canon(m, prod))) == want


def _check_scalar_helpers(m):
    assert ff.mont_inv(m, 0) == 0
    x = 12345678901234567890
    assert ff.mont_inv(m, x) * x % m == 1
    assert ff.unmont_int(ff.mont_int(x, m), m) == x
    assert ff.from_rows(ff.mont_one(m, "cpu")) == [R256 % m]
    with pytest.raises(ValueError):
        ff.field_id(97)


def test_plain_field_ops_vs_ints_and_jax():
    for m in MODS:
        _check_rows_roundtrip(m)
        _check_lazy_limbs_edge_values(m)
        _check_scalar_helpers(m)
        _check_add_sub_vs_ints_and_jax(m)
        _check_mont_mul_vs_ints_and_jax(m)
        _check_to_mont_vs_jax(m)
