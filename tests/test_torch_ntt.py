"""halo_tpu_torch.ops.ntt against halo_tpu.hostpoly.ntt_host (ark-poly's
natural-order evaluation), forward and inverse, at n <= 2^10; and the
pass plan (_passes) runs every stage once, in order, in passes the
kernel can hold.  On the CPU a plan of any split computes the same plain
code, so whether a later pass indexes its twiddles right is the CUDA
test's to show (test_torch_mont.py).  The port's 4-step distributed NTT
(halo_tpu_torch.parallel.ntt) on Mesh((cpu,) * d), d = 1, 2, 4, 8,
forward, inverse and in the transposed layout, at tests/test_parallel.py's
n = 128, against ntt.ntt, and at d = 2, 4, 8 in every layout against
halo_tpu.parallel.ntt.ntt_distributed on the JAX virtual mesh of the same
d (tests/conftest.py's 8 host devices, in child processes: pytest.ini on
XLA:CPU's compile defect); and a mesh Engine's ntt, intt and ntt_extended
against the plain Engine's.

Tolerance: zero (exact field values compared as ints).

One test runs every check: the suite's test count sets pytest-xdist's
batches under `--dist load` (ROADMAP, "Tier-1 budget").
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import torch

from halo_tpu.curves import PALLAS, VESTA
from halo_tpu.fields import FP_MOD, FQ_MOD
from halo_tpu.hostpoly import ntt_host
from halo_tpu_torch.ops import ff, mont, ntt
from halo_tpu_torch.parallel import ntt as pntt
from halo_tpu_torch.parallel.mesh import Mesh, gather
from halo_tpu_torch.plonk.engine import Engine

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R256 = 1 << 256
ROOT = Path(__file__).resolve().parents[1]


def _mont_rows(vals, m):
    return ff.to_rows([v * R256 % m for v in vals], "cpu")


def _unmont(rows, m):
    rinv = pow(R256, -1, m)
    return [v * rinv % m for v in ff.from_rows(rows)]


def test_ntt_matches_host():
    halo = _start_halo_distributed((2, 4, 8))  # the JAX side compiles meanwhile
    try:
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
        for d in (1, 2, 4, 8):
            _check_distributed_matches_single(d)
        _check_distributed_matches_halo(halo)
        _check_mesh_engine(VESTA)
    finally:
        for child in halo.values():
            child.kill()


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


def _inputs(d):
    """The shard count d's 128 seeded values (tests/test_parallel.py's n)."""
    rng = random.Random(d)
    return [rng.randrange(FP_MOD) for _ in range(128)]


def _distributed(d, inverse, natural):
    """(input rows, parallel.ntt.ntt_distributed of them on
    Mesh((cpu,) * d) joined) of _inputs(d)."""
    m = FP_MOD
    x = _mont_rows(_inputs(d), m)
    got = gather(pntt.ntt_distributed(m, Mesh((torch.device("cpu"),) * d), x, inverse, natural),
                 "cpu")
    return x, got


_LAYOUTS = ((False, True), (True, True), (False, False))  # (inverse, natural_order)


def _check_distributed_matches_single(d):
    """Forward, inverse and natural_order=False (grid row j1 = shard j1,
    A[j2 d + j1] at j2) equal ntt.ntt word for word."""
    n = 128
    for inverse, natural in _LAYOUTS:
        x, got = _distributed(d, inverse, natural)
        single = ntt.ntt(FP_MOD, x, inverse)
        if not natural:
            single = single.reshape(8, n // d, d).transpose(1, 2).reshape(8, n)
        assert got.equal(single), (d, inverse, natural)


# halo_tpu.parallel.ntt.ntt_distributed of argv[2]'s layouts on the first
# argv[3] JAX devices, of argv[4]'s values; prints their Montgomery ints.
# The three transforms (distributed_ntt_fn, what ntt_distributed runs) go
# through one jit: one XLA compile.
_HALO_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from halo_tpu.ops import ff
from halo_tpu.parallel import mesh as jmesh, ntt as jntt

vals = json.loads(sys.argv[4])
mesh = jmesh.data_mesh(int(sys.argv[3]))
x = ff.ints_to_array([v * (1 << 256) % ff.FP_CTX.m for v in vals])
fns = [jntt.distributed_ntt_fn(ff.FP_CTX, mesh, len(vals).bit_length() - 1, inverse, natural)
       for inverse, natural in json.loads(sys.argv[2])]
wants = jax.jit(lambda a: tuple(fn(a) for fn in fns))(jmesh.shard_leading(mesh, x))
print(json.dumps([ff.array_to_ints(np.asarray(w)) for w in wants]))
"""


def _start_halo_distributed(shard_counts):
    """Start halo_tpu.parallel.ntt.ntt_distributed of _inputs(d) in every
    layout, one child process a shard count d, all at once, in
    tests/conftest.py's environment (the CPU platform, 8 host devices).
    Out of this process, its large executables do not pile up where the
    next XLA:CPU compile could crash (pytest.ini); running meanwhile, its
    compiles (~31 s each) cost the suite little wall time."""
    return {d: subprocess.Popen([sys.executable, "-c", _HALO_CHILD, str(ROOT), json.dumps(_LAYOUTS),
                                 str(d), json.dumps(_inputs(d))],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
            for d in shard_counts}


def _check_distributed_matches_halo(halo):
    """parallel.ntt.ntt_distributed in each layout against
    halo_tpu.parallel.ntt.ntt_distributed's (_start_halo_distributed) at
    each shard count, on the same Montgomery values (R = 2^256 in both)."""
    m = FP_MOD
    rinv = pow(R256, -1, m)
    for d, child in halo.items():
        out, err = child.communicate(timeout=600)
        assert child.returncode == 0, err[-4000:]
        wants = json.loads(out.strip().splitlines()[-1])
        for (inverse, natural), want in zip(_LAYOUTS, wants, strict=True):
            _, got = _distributed(d, inverse, natural)
            assert _unmont(got, m) == [v * rinv % m for v in want], (d, inverse, natural)


def _check_mesh_engine(cfg):
    """A mesh Engine's NTTs (4-step where _mesh_ntt_ok holds) equal the
    plain Engine's, batched; below d^2 the mesh engine runs ntt.ntt."""
    m = cfg.r
    plain, meshed = Engine(cfg, "cpu"), Engine(cfg, "cpu", Mesh(("cpu",) * 4))
    rng = random.Random(5)
    dev = plain.to_dev_batch([[rng.randrange(m) for _ in range(64)] for _ in range(2)])
    assert meshed._mesh_ntt_ok(64) and meshed._mesh_ntt_ok(16) and not meshed._mesh_ntt_ok(8)
    assert not plain._mesh_ntt_ok(64)
    assert meshed.ntt(dev).equal(plain.ntt(dev))
    assert meshed.intt(dev).equal(plain.intt(dev))
    assert meshed.ntt_extended(dev, 256).equal(plain.ntt_extended(dev, 256))
    assert meshed.ntt(dev[:, :, :8]).equal(plain.ntt(dev[:, :, :8]))
