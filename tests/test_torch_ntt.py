"""halo_tpu_torch.ops.ntt against halo_tpu.hostpoly.ntt_host (ark-poly's
natural-order evaluation), forward and inverse, at n <= 2^10; and the
pass plan (_passes) runs every stage once, in order, in passes the
kernel can hold.  On the CPU a plan of any split computes the same plain
code, so whether a later pass indexes its twiddles right is the CUDA
test's to show (test_torch_mont.py).

Tolerance: zero (exact field values compared as ints).

One test runs every check: the suite's test count sets pytest-xdist's
batches under `--dist load` (ROADMAP, "Tier-1 budget").
"""

import os
import random

import torch

from halo_tpu.curves import PALLAS, VESTA
from halo_tpu.fields import FP_MOD, FQ_MOD
from halo_tpu.hostpoly import ntt_host
from halo_tpu_torch.ops import ff, mont, ntt
from halo_tpu_torch.plonk.engine import Engine

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R256 = 1 << 256


def _mont_rows(vals, m):
    return ff.to_rows([v * R256 % m for v in vals], "cpu")


def _unmont(rows, m):
    rinv = pow(R256, -1, m)
    return [v * rinv % m for v in ff.from_rows(rows)]


def test_ntt_matches_host():
    for m in (FP_MOD, FQ_MOD):
        for log_n in (0, 1, 2, 5, 10):
            for inverse in (False, True):
                n = 1 << log_n
                rng = random.Random(log_n * 7 + inverse)
                v = [rng.randrange(m) for _ in range(n)]
                got = _unmont(ntt.ntt(m, _mont_rows(v, m), inverse), m)
                assert got == ntt_host(m, v, inverse), (hex(m)[-8:], log_n, inverse)
    assert ntt._passes(20) == [(0, 10), (10, 5), (15, 5)]
    assert ntt._passes(10, 2) == [(0, 2)] + [(s, 1) for s in range(2, 10)]
    for log_n in range(1, 25):
        for tile_log in range(1, mont.NTT_TILE_LOG + 1):
            _check_pass_plan(log_n, tile_log)
    for cfg in (PALLAS, VESTA):
        _check_batched_roundtrip_and_extension(cfg)


def _check_pass_plan(log_n, tile_log):
    """Stages 1 .. log_n, each once and in order; the first pass starts at
    stage 1 (it reads bit-reversed) with a tile of 2^min(log_n, tile_log);
    a later pass runs at most max(1, tile_log - 3) stages over 8 columns,
    within the kernel's tile; at the kernel's tile_log, at most 3 passes
    up to 2^24."""
    plan = ntt._passes(log_n, tile_log)
    assert plan[0] == (0, min(log_n, tile_log)), (log_n, tile_log, plan)
    assert [s0 for s0, _ in plan] == [sum(j for _, j in plan[:i]) for i in range(len(plan))]
    assert sum(j for _, j in plan) == log_n, (log_n, tile_log, plan)
    for s0, j in plan[1:]:
        assert 1 <= j <= max(1, tile_log - mont.NTT_COLS_LOG), (log_n, tile_log, plan)
        assert mont.NTT_COLS_LOG + j <= mont.NTT_TILE_LOG
    if tile_log == mont.NTT_TILE_LOG:
        assert len(plan) <= 3, (log_n, plan)


def _check_batched_roundtrip_and_extension(cfg):
    """A (8, k, n) batch transforms row by row; intt inverts ntt; the
    extended evaluation agrees with the host NTT of the zero-padded poly."""
    m = cfg.r
    eng = Engine(cfg, "cpu")
    rng = random.Random(3)
    polys = [[rng.randrange(m) for _ in range(64)] for _ in range(3)]
    dev = eng.to_dev_batch(polys)
    evals = eng.ntt(dev)
    assert evals.shape == (8, 3, 64)
    for i, p in enumerate(polys):
        assert eng.to_ints(evals[:, i]) == ntt_host(m, p)
    assert eng.intt(evals).equal(dev)
    ext = eng.ntt_extended(dev, 256)
    assert eng.to_ints(ext[:, 1]) == ntt_host(m, polys[1] + [0] * 192)
