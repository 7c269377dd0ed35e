"""halo_tpu_torch.ops.msm2 (the bucket MSM over the scan and padd
kernels' plain versions) against halo_tpu.native.msm and
halo_tpu.curves.msm_host, single and batched, at n <= 2^10; and the
Schnorr batch, whose verifier is a fixed-base MSM over the scan
(halo_tpu_torch.schnorr, ops/schnorr_batch.py), against halo_tpu.schnorr:
seeded keys and signatures, the batch hash, and the verdicts against the
host verify on both curves, tampered signatures included.  The sharded
MSMs of halo_tpu_torch.parallel.msm on Mesh((cpu,) * d), d = 2, 4, 8,
against halo_tpu.curves.msm_host; parallel.pipeline.split_mesh against
halo_tpu.parallel.pipeline.split_mesh's partition; run_disjoint of a
Pallas and a Vesta MSM against the host (tests/test_parallel.py:112-135).

Tolerance: zero (affine points compared as ints).

One test runs every check: the suite's test count sets pytest-xdist's
batches under `--dist load` (ROADMAP, "Tier-1 budget").
"""

import os
import random

import torch

from halo_tpu import native
from halo_tpu import schnorr as hschnorr
from halo_tpu.curves import PALLAS, VESTA, ec_mul, msm_host
from halo_tpu.ops import schnorr_batch as hschnorr_batch
from halo_tpu.parallel import mesh as jmesh
from halo_tpu.parallel import pipeline as jpipeline
from halo_tpu.srs import load_srs
from halo_tpu_torch import convert, schnorr, srs
from halo_tpu_torch.ops import ecrows, ff, msm2, schnorr_batch
from halo_tpu_torch.parallel import msm as pmsm
from halo_tpu_torch.parallel import pipeline
from halo_tpu_torch.parallel.mesh import Mesh

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CURVES = (PALLAS, VESTA)


def _points(cfg, n, seed):
    rng = random.Random(seed)
    base = [ec_mul(cfg, cfg.generator, rng.randrange(1, cfg.r)) for _ in range(min(n, 32))]
    return [base[(i * 7) % len(base)] for i in range(n)]


def _scalars(cfg, n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(cfg.r) for _ in range(n)]
    if n > 4:
        ks[1], ks[2], ks[3] = 0, 1, cfg.r - 1
    return ks


def _host_msm(cfg, ks, pts):
    return native.msm(cfg, ks, pts) if native.available() else msm_host(cfg, ks, pts)


def _check_msm_explicit_points(cfg, n):
    pts = _points(cfg, n, n)
    if n > 4:
        pts[4] = None  # the identity takes a placeholder point and a zero digit
    ks = _scalars(cfg, n, n + 1)
    assert msm2.msm2(cfg, ks, pts, "cpu") == msm_host(cfg, ks, pts)


def _check_msm_srs_1024(cfg):
    n = 1024
    ks = _scalars(cfg, n, 9)
    gs = load_srs(cfg.name, n).gs_ints(n)
    assert msm2.msm2_srs(cfg, ks, "cpu") == _host_msm(cfg, ks, gs)


def _check_msm_batched_with_point_maps(c_bits):
    """k MSMs in one pipeline pass, each over its own subset of the table
    (the IPA fold's index maps), at both window widths."""
    cfg = PALLAS
    n_pts, n, k = 64, 32, 3
    table = _points(cfg, n_pts, 4)
    xy = ecrows.pack_points(cfg.p, [q[0] for q in table], [q[1] for q in table], "cpu")
    rng = random.Random(c_bits)
    pidx = torch.tensor([rng.sample(range(n_pts), n) for _ in range(k)])
    ks = [_scalars(cfg, n, 20 + i) for i in range(k)]
    K = torch.stack([ff.to_rows(s, "cpu") for s in ks], 1)
    got = msm2.msm_multi(cfg, xy, K, pidx=pidx, c_bits=c_bits)
    want = [msm_host(cfg, ks[i], [table[j] for j in pidx[i].tolist()]) for i in range(k)]
    assert got == want


def _check_srs_rows_multi_pads_to_pow2(cfg):
    n_req = 100  # pads to 128 SRS points with zero scalars
    ks = [_scalars(cfg, n_req, 30 + i) for i in range(2)]
    K = torch.stack([ff.to_rows(s, "cpu") for s in ks], 1)
    gs = load_srs(cfg.name, 128).gs_ints(n_req)
    assert msm2.msm2_srs_rows_multi(cfg, K) == [_host_msm(cfg, s, gs) for s in ks]


def _check_derived_srs_matches_load_srs(cfg):
    """The port's SRS derivation (scalar_mul_rows: the plain ec_smul ladder
    over ec_pdbl and ec_pmadd) is byte-equal to halo_tpu.srs.load_srs, and
    the packed device table to convert.srs_rows."""
    n = 256
    mine = srs.load_srs(cfg.name, n, "cpu")
    ref = load_srs(cfg.name, n)
    assert (mine.S, mine.H) == (ref.S, ref.H)
    assert mine.gs_x.tobytes() == ref.gs_x.tobytes()
    assert mine.gs_y.tobytes() == ref.gs_y.tobytes()
    assert convert.srs_rows(ref, 16, "cpu").equal(srs.srs_pack(cfg.name, 16, torch.device("cpu")))


def _check_schnorr_batch_matches_halo(cfg, n, tamper):
    """Seeded generate_keypair/sign_batch equal halo_tpu.schnorr's (r and
    s); the batch hash equals halo_tpu's; verify_batch's verdicts equal
    halo_tpu.schnorr.verify's after the tamperings (bad s, bad message,
    another signature's R: tests/test_schnorr_batch.py:43-56)."""
    sk, pk = schnorr.generate_keypair(cfg, random.Random(1001))
    assert (sk, pk) == hschnorr.generate_keypair(cfg, random.Random(1001))
    rng = random.Random(9)
    msgs = [[rng.randrange(cfg.p) for _ in range(10)] for _ in range(n)]
    sigs = schnorr.sign_batch(cfg, sk, msgs, "cpu", rng=random.Random(9))
    ref = hschnorr.sign_batch(cfg, sk, msgs, random.Random(9))
    assert [(s.r, s.s) for s in sigs] == [(s.r, s.s) for s in ref]
    r_pts = [s.r for s in sigs]
    assert schnorr_batch.hash_message_batch(cfg, pk, r_pts, msgs, "cpu") == \
        hschnorr_batch.hash_message_batch(cfg, pk, r_pts, msgs)
    if "s" in tamper:
        sigs[1] = schnorr.SchnorrSignature(r=sigs[1].r, s=(sigs[1].s + 1) % cfg.r)
    if "message" in tamper:
        msgs[3] = [(msgs[3][0] + 1) % cfg.p] + msgs[3][1:]
    if "R" in tamper:
        sigs[4] = schnorr.SchnorrSignature(r=sigs[0].r, s=sigs[4].s)
    want = [hschnorr.verify(cfg, pk, m, hschnorr.SchnorrSignature(r=s.r, s=s.s))
            for m, s in zip(msgs, sigs)]
    assert schnorr.verify_batch(cfg, pk, msgs, sigs, "cpu") == want
    return want


def test_msm_matches_host():
    for cfg in CURVES:
        for n in (1, 5, 64, 300):
            _check_msm_explicit_points(cfg, n)
        _check_msm_srs_1024(cfg)
        _check_srs_rows_multi_pads_to_pow2(cfg)
    for c_bits in (4, 8):
        _check_msm_batched_with_point_maps(c_bits)
    for cfg in CURVES:
        _check_derived_srs_matches_load_srs(cfg)
    # Pallas (r > p: no shift of the challenge) with the three tamperings;
    # Vesta (r < p: the challenge's >> 1) with one
    assert _check_schnorr_batch_matches_halo(PALLAS, 6, ("s", "message", "R")) == \
        [True, False, True, False, False, True]
    assert _check_schnorr_batch_matches_halo(VESTA, 3, ("s",)) == [True, False, True]
    for d, cfg in ((2, PALLAS), (4, VESTA), (8, PALLAS)):
        _check_sharded_msms(cfg, d)
    _check_split_mesh_and_run_disjoint()


def _cpu_mesh(d):
    return Mesh((torch.device("cpu"),) * d)


def _check_sharded_msms(cfg, d):
    """msm2_sharded (explicit points, an identity among them) and
    msm2_srs_rows_sharded (k = 2 SRS MSMs) of n = 64 over d shards equal
    halo_tpu.curves.msm_host on the same points."""
    n = 64
    pts = _points(cfg, n, d)
    pts[5] = None
    ks = _scalars(cfg, n, d + 1)
    assert pmsm.msm2_sharded(cfg, _cpu_mesh(d), ks, pts) == msm_host(cfg, ks, pts)
    kss = [_scalars(cfg, n, 40 + i) for i in range(2)]
    K = torch.stack([ff.to_rows(s, "cpu") for s in kss], 1)
    gs = load_srs(cfg.name, n).gs_ints(n)
    assert pmsm.msm2_srs_rows_sharded(cfg, _cpu_mesh(d), K) == [msm_host(cfg, s, gs) for s in kss]


def _check_split_mesh_and_run_disjoint():
    """split_mesh gives halo_tpu's partition (device indices against JAX
    device ids) for meshes of 8, 3 and 1 devices into 2 and 3 parts; the
    CUDA devices are descriptors only, nothing runs on them.  Then a
    Pallas and a Vesta MSM at once on the two halves of an 8-shard CPU
    mesh."""
    for n_dev in (8, 3, 1):
        mine = Mesh(tuple(torch.device("cuda", i) for i in range(n_dev)))
        for k in (2, 3):
            got = [[dev.index for dev in sub.devices] for sub in pipeline.split_mesh(mine, k)]
            want = [[dev.id for dev in sub.devices.flat]
                    for sub in jpipeline.split_mesh(jmesh.data_mesh(n_dev), k)]
            assert got == want, (n_dev, k)
    subs = pipeline.split_mesh(_cpu_mesh(8), 2)
    assert [len(sub) for sub in subs] == [4, 4]
    jobs = []
    for cfg in (PALLAS, VESTA):
        rng = random.Random(cfg.name)
        pts = [ec_mul(cfg, cfg.generator, rng.randrange(1, cfg.r)) for _ in range(64)]
        jobs.append((cfg, [rng.randrange(cfg.r) for _ in range(64)], pts))
    got = pipeline.run_disjoint(_cpu_mesh(8), [
        lambda sub, job=job: pmsm.msm2_sharded(job[0], sub, job[1], job[2]) for job in jobs])
    assert got == [msm_host(cfg, ks, pts) for cfg, ks, pts in jobs]
