#!/usr/bin/env python3
"""Drive halo_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--log-rows 14] [--seed 11]

Phases, one line each; any failure raises (exit code != 0):

  1. device   the card's name and power limit (nvidia-smi); needs CUDA
  2. build    nvcc builds csrc/kernels.cu from this checkout; then the
              SRS of the main path is loaded or derived (timed)
  3. kernels  each kernel against its plain torch version on the card, at
              the main path's shapes; results must be equal (exact
              arithmetic: max_abs_err must be 0) and canonical (< p)
  4. golden   the port's prover on the card reproduces
              tests/fixtures/proof_{pallas,vesta}.bin byte for byte
  5. main     a Pallas Poseidon-chain circuit of 2^log_rows rows (bench.py's
              circuit): a warm-up trace and proof, then the counted and
              timed run: port trace, proof, verify (halo_tpu's succinct
              verifier + the port's decider); the proof must equal the
              warm-up's, and the decider MSM the host MSM's
              (halo_tpu.native, through halo_tpu_torch.srs.host_msm).
              Every kernel's launch count over the counted run must be > 0.

The last three lines: the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  The script imports torch and halo_tpu_torch
only, never jax or halo_tpu itself; the run fails if any jax module was
loaded.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

REPLACES = {
    "field_mul": "halo_tpu/ops/pallas_mont.py:256",
    "ntt_butterfly": "halo_tpu/ops/pallas_mont.py:459",
    "ec_padd": "halo_tpu/ops/pallas_mont.py:261",
    "ec_pmadd_scan": "halo_tpu/ops/pallas_mont.py:355",
}


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def poseidon_chain(target_rows: int, seed: int):
    """bench.py's circuit (bench.py:227-250): 12 rows per permutation."""
    from halo_tpu_torch.plonk.circuit import TRACE_CURVE, CircuitSpec, TraceBuilder

    rng = random.Random(seed)
    spec = CircuitSpec()
    w = [spec.fp_witness() for _ in range(3)]
    wires = tuple(w)
    for _ in range(max(1, (target_rows - 8) // 12)):
        for i in range(11):
            wires = spec.poseidon(i, wires)
        wires = spec.poseidon_finish(wires)
    spec.output_gate(wires[0])
    tb = TraceBuilder(spec)
    for wi in w:
        tb.witness(wi, rng.randrange(TRACE_CURVE[0].r))
    return tb


def golden_builder():
    """The circuit of tests/test_serde_proof.py:24-45."""
    from halo_tpu_torch.plonk.circuit import FP, FQ, CircuitSpec, TraceBuilder

    spec = CircuitSpec()
    vals = {}
    for fid in (FP, FQ):
        x = spec.witness(fid)
        y = spec.witness(fid)
        spec.output_gate(spec.mul_gate(spec.add_gate(x, y), x))
        vals[fid] = (x, y)
    tb = TraceBuilder(spec)
    tb.witness(vals[FP][0], 3)
    tb.witness(vals[FP][1], 41)
    tb.witness(vals[FQ][0], 7)
    tb.witness(vals[FQ][1], 11)
    return tb


def _kernels_vs_plain(dev, log_rows: int, seed: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from halo_tpu_torch.ops import ecrows, ff, mont, msm2
    from halo_tpu_torch.plonk.circuit import TRACE_CURVE
    from halo_tpu_torch.srs import srs_pack

    rng = random.Random(seed)
    cfg = TRACE_CURVE[0]
    m = cfg.r  # scalar field: the engine's muls and NTTs
    p = cfg.p  # base field: the MSM's EC kernels
    n = 1 << log_rows
    big_n = 8 * n  # the extended domain of the prover's NTTs
    out = {}

    def rows(mod, k):
        return ff.to_rows([rng.randrange(mod) for _ in range(k)], dev)

    def report(name, got, want, modulus, ms, plain_ms):
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain differ (max_abs_err {err})")
        words = (got if got.dim() == 2 else got.transpose(0, 1)).reshape(8, -1)
        vals = ff.from_rows(words[:, :: max(1, words.shape[1] // 4096)])
        if max(vals) >= modulus:
            raise AssertionError(f"{name}: output not canonical")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        _phase("kernels", f"{name}: equal to plain, {tuple(got.shape)}; "
                          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # field_mul at the 8n extended domain; also the broadcast (mulc) form
    a, b = rows(m, big_n), rows(m, big_n)
    got = mont.field_mul(m, a, b)
    report("field_mul", got, mont.field_mul_plain(m, a, b), m,
           _time_ms(lambda: mont.field_mul(m, a, b), 20),
           _time_ms(lambda: mont.field_mul_plain(m, a, b), 3))
    if not mont.field_mul(m, a, b[:, :1]).equal(mont.field_mul_plain(m, a, b[:, :1])):
        raise AssertionError("field_mul: broadcast form differs from plain")

    # one butterfly stage over the 8n domain (half = 2^10 of a 2^(log n) table)
    half, tw = min(1 << 10, big_n // 2), rows(m, big_n // 2)
    stride = (big_n // 2) // half
    got = mont.ntt_butterfly(m, a, tw, half, stride)
    report("ntt_butterfly", got, mont.ntt_butterfly_plain(m, a, tw, half, stride), m,
           _time_ms(lambda: mont.ntt_butterfly(m, a, tw, half, stride), 20),
           _time_ms(lambda: mont.ntt_butterfly_plain(m, a, tw, half, stride), 3))

    # ec_padd on SRS generators: the identity, equal and opposite lanes a
    # complete formula must get right, then the bucket-assembly width of a
    # 16-poly commitment (512 windows x 129 buckets)
    xy = srs_pack(cfg.name, n, dev)
    one = ff.mont_one(p, dev)

    def proj(lo, hi):
        return torch.stack((xy[:8, lo:hi], xy[8:, lo:hi], one.expand(8, hi - lo)))

    def affine(S):
        X, Y, Z = (ff.from_rows(S[c]) for c in range(3))
        return [None if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
                for x, y, z in zip(X, Y, Z)]

    ident = ecrows.identity_rows(p, (1,), dev)
    A, B = proj(0, 1), proj(1, 2)
    neg_a = torch.stack((A[0], ff.neg(p, A[1]), A[2]))
    P = torch.cat((ident, A, A, A, ident, proj(2, 34)), -1)
    Q = torch.cat((B, ident, A, neg_a, ident, proj(34, 66)), -1)
    S = affine(mont.ec_padd(p, P, Q))
    on_curve = all(q is not None and (q[1] ** 2 - q[0] ** 3 - 5) % p == 0
                   for q in [S[2]] + S[5:])
    if S[0] != affine(B)[0] or S[1] != affine(A)[0] or S[3:5] != [None, None] or not on_curve:
        raise AssertionError("ec_padd: wrong sum on an edge lane")
    reps = (512 * 129) // P.shape[-1] + 1
    Pw, Qw = P.repeat(1, 1, reps), Q.repeat(1, 1, reps)
    report("ec_padd", mont.ec_padd(p, Pw, Qw), mont.ec_padd_plain(p, Pw, Qw), p,
           _time_ms(lambda: mont.ec_padd(p, Pw, Qw), 20),
           _time_ms(lambda: mont.ec_padd_plain(p, Pw, Qw), 3))

    # ec_pmadd_scan at a commitment's scan shape: 2^log_rows SRS points,
    # one poly's windows (c = 8: 32) x its lanes, R steps
    L = msm2.choose_lanes(n)
    R, F = n // L, 32 * L
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n, (R, F), generator=g, dtype=torch.int32).to(dev)
    neg = (torch.rand((R, F), generator=g) < 0.5).to(dev)
    report("ec_pmadd_scan", mont.ec_pmadd_scan(p, xy, idx, neg),
           mont.ec_pmadd_scan_plain(p, xy, idx, neg), p,
           _time_ms(lambda: mont.ec_pmadd_scan(p, xy, idx, neg), 5),
           _time_ms(lambda: mont.ec_pmadd_scan_plain(p, xy, idx, neg), 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-rows", type=int, default=14)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if args.log_rows < 7:
        ap.error("--log-rows must be at least 7")

    if not (ROOT / "halo_tpu_torch" / "csrc" / "kernels.cu").exists():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import torch

    from halo_tpu_torch import device as devmod
    from halo_tpu_torch import pcdl, srs
    from halo_tpu_torch.ops import kernels, msm2
    from halo_tpu_torch.plonk import protocol, trace
    from halo_tpu_torch.plonk.circuit import TRACE_CURVE

    # 1. device
    dev = devmod.cuda()
    card = devmod.card_line()
    _phase("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    kernels.build()
    _phase("build", f"nvcc build + load {kernels.BUILD_SECONDS:.2f} s ({kernels.library_path().name})")

    # the SRS of the main path (derived from its hash-to-curve formula
    # when no cached copy is at hand); the kernels phase draws points from it
    cfg = TRACE_CURVE[0]
    n = 1 << args.log_rows
    t0 = time.perf_counter()
    srs.load_srs(cfg.name, n)
    _phase("srs", f"{cfg.name}, 2^{args.log_rows} generators: {time.perf_counter() - t0:.2f} s")

    # 3. kernels vs plain
    stats = _kernels_vs_plain(dev, args.log_rows, args.seed)

    # 4. golden bytes
    t0 = time.perf_counter()
    traces = trace.trace_pair(golden_builder(), dev)
    for which, tr, curve in zip(("pallas", "vesta"), traces, TRACE_CURVE):
        circuit, x, w = tr.consume()
        proof = protocol.naive_prover(curve, circuit, x, w, dev)
        gold = (ROOT / "tests" / "fixtures" / f"proof_{which}.bin").read_bytes()
        if proof.to_bytes(curve) != gold:
            raise AssertionError(f"golden {which} proof bytes differ")
        protocol.verify(curve, proof, circuit, x, dev)
    _phase("golden", f"proof_pallas.bin and proof_vesta.bin reproduced byte for byte "
                     f"and verified ({time.perf_counter() - t0:.2f} s)")

    # 5. main path
    fp_data, _ = poseidon_chain(n, args.seed).trace()
    if fp_data.rows != n:
        raise AssertionError(f"circuit has {fp_data.rows} rows, wanted {n}")

    # warm-up: one trace and proof, outside the counted and timed run
    t0 = time.perf_counter()
    circuit, x, w = trace.Trace.new(cfg, fp_data, dev).consume()
    warm = protocol.naive_prover(cfg, circuit, x, w, dev).to_bytes(cfg)
    t_warm = time.perf_counter() - t0

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = trace.Trace.new(cfg, fp_data, dev)
    devmod.sync(dev)
    t_trace = time.perf_counter() - t0
    circuit, x, w = tr.consume()
    t0 = time.perf_counter()
    proof = protocol.naive_prover(cfg, circuit, x, w, dev)
    devmod.sync(dev)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    protocol.verify(cfg, proof, circuit, x, dev)
    t_verify = time.perf_counter() - t0
    launches = kernels.counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if proof.to_bytes(cfg) != warm:
        raise AssertionError("two proofs of the same witness differ")

    # the decider's MSM, once more, against the host MSM
    acc = proof.acc_next.q
    h, U = pcdl.succinct_check(cfg, acc.C, acc.d, acc.z, acc.v, acc.pi)
    coeffs = h.coeffs()
    mine = msm2.msm2_srs(cfg, coeffs, dev)
    if mine != U or srs.host_msm(cfg, coeffs) != mine:
        raise AssertionError("decider MSM disagrees with the host MSM")
    _phase("main", f"{cfg.name} Poseidon chain, 2^{args.log_rows} rows: "
                   f"trace {t_trace:.3f} s, prove {t_prove:.3f} s, verify {t_verify:.3f} s "
                   f"(warm-up trace + prove {t_warm:.2f} s); peak device memory "
                   f"{peak_gib:.2f} GiB; proof {len(warm)} bytes verified; decider MSM "
                   f"equal to the host MSM")
    _phase("main", f"kernel launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    jax_mods = sorted(k for k, v in sys.modules.items()
                      if v is not None and k.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise AssertionError(f"the run imported jax: {jax_mods[:5]}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "halo_tpu_torch/csrc/kernels.cu",
         "replaces": REPLACES[name], "launches": launches[name], **stats[name]}
        for name in kernels.NAMES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
