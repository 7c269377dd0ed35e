#!/usr/bin/env python3
"""Compare the port's kernels of two source trees on one card, in turns.

    python3 -m halo_tpu_torch.kernel_ab --trees PARENT . .:seq PARENT \
        [--profile-steps 2] [--prove-reps 1] [--out build/kernel_ab.json]
    python3 -m halo_tpu_torch.kernel_ab --summarize build/kernel_ab.json

PARENT is an unpacked checkout of another commit (`git archive`).  A tree
given as PATH:seq runs with HALO_TPU_IVC_SEQUENTIAL=1 (its IVC provers one
after the other on any mesh); the variable is removed for every other
tree (frontend/ivc.py at_once decides).  For each tree, in the order given, a fresh process imports halo_tpu_torch from that
tree (its kernels build into <tree>/build/) and measures, on the same
seeded inputs:

  - each kernel the tree has at the shapes the main paths launch it at
    (the 2^14 proof, the IVC step at 2^16, the IPA rounds, a batched
    commitment, the SRS derivations, the Schnorr batch's hash), as
    host-paced time and as device time per launch (measure.py's timers,
    which chip_smoke.py uses too); field_add, field_sub and
    poseidon_permute only where the tree has them; and whole NTTs (ntt.ntt
    at the IVC step's 16n and 8n and a 3-poly batch), on whichever
    kernels the tree runs them;
  - the paths every tree has: ecrows.scalar_mul_rows at the SRS shapes
    (65,538 and 16,386 lanes, one broadcast base) and at 1,025 lanes with
    per-lane bases, host-paced and as traced device time
    (measure.traced_device_ms: a graph cannot capture the older trees'
    composite); srs.derive_srs wall seconds per curve at 2^16, after one
    warm-up derivation at 2^4;
  - the registers of each kernel (cudaFuncGetAttributes), its local
    (spill) bytes where the tree reports them, and the SASS instructions
    of each kernel (cuobjdump -sass of the built library);
  - one 2^14-row proof and --prove-reps warm ones (measure.poseidon_chain,
    chip_smoke.py's circuit): trace and prove seconds, and the proof's
    round5.open+accumulate seconds (profile_ivc.phase_times);
  - where the tree has the Schnorr batch: sig/s of 7 warm verify_batch
    calls of 8,192 seeded signatures on Pallas;
  - with --profile-steps N: this checkout's profile_ivc.py, run against
    the tree's package: IVCState.init, N steps, the last one traced
    (wall, device busy, idle share, the streams' overlap, peak device
    memory, each kernel's device time, torch's own kernels, the host's
    launch, sync, copy and any() calls, each step's
    round5.open+accumulate per curve).

A worker runs this file as a script with the tree first on sys.path, and
loads this checkout's measure.py and profile_ivc.py by path: the trees
may predate them, and both import only what every tree has.

Every input is made on the card from one seed.  One JSON object per tree
goes to --out, and to stdout a table of the kernel times (median per
tree: device / host-paced ms; a kernel only where the tree has it), the
SRS path's numbers of every run, and, per traced step, each kernel's device
seconds beside the sum of its bounds over the step's launches
(measure.work and measure.bound at each recorded shape).  Needs one CUDA
card; compares only numbers taken in the same call.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent  # this checkout's halo_tpu_torch/
SEED = 11
PROVE_LOG_ROWS = 14
SCHNORR_N = 8192  # chip_smoke.py's batch (bench.py:381)
SCHNORR_CALLS = 7


def _shapes():
    """(label, kernel, args): every shape is one the main paths launch."""
    out = [("field_mul 8x2^19 (IVC NTT domain)", "field_mul", {"n": 1 << 19}),
           ("field_mul 8x2^17 (2^14 NTT domain)", "field_mul", {"n": 1 << 17}),
           ("field_mul 8x2^16 x 1 bcast (IPA fold)", "field_mul", {"n": 1 << 16, "bcast": True}),
           ("field_add 8x2^19 (IVC gate constraints)", "field_add", {"n": 1 << 19}),
           ("field_sub 8x2^19 (IVC gate constraints)", "field_sub", {"n": 1 << 19}),
           ("field_add 8x2^17 (2^14 gate constraints)", "field_add", {"n": 1 << 17}),
           ("field_sub 8x2^19 x 1 bcast (1 - x)", "field_sub", {"n": 1 << 19, "bcast": True}),
           ("field_add 8x2^15 (IPA fold, first round)", "field_add", {"n": 1 << 15}),
           ("ntt_butterfly 8x2^19 half 1024", "ntt_butterfly", {"n": 1 << 19, "half": 1024}),
           ("ntt_butterfly 8x2^17 half 1024", "ntt_butterfly", {"n": 1 << 17, "half": 1024}),
           ("ntt transform 8x2^20 (16n at 2^16)", "ntt", {"n": 1 << 20, "k": 1}),
           ("ntt transform 8x3x2^18 batch", "ntt", {"n": 1 << 18, "k": 3}),
           ("intt transform 8x2^19 (8n at 2^16)", "ntt", {"n": 1 << 19, "k": 1, "inverse": True}),
           ("poseidon_permute 3x8x8192 (Schnorr batch)", "poseidon_permute", {"n": 8192}),
           ("poseidon_permute 3x8x2^16", "poseidon_permute", {"n": 1 << 16})]
    for n in (66082, 16512, 2048, 1024, 512, 64, 2):
        out.append((f"ec_padd {n} lanes", "ec_padd", {"n": n}))
    for n in (65538, 16386):
        out.append((f"ec_pmadd {n} lanes", "ec_pmadd", {"n": n}))
        out.append((f"ec_pdbl {n} lanes", "ec_pdbl", {"n": n}))
        out.append((f"ec_smul {n} lanes bcast", "ec_smul", {"n": n, "bcast": True}))
    out.append(("ec_smul 1025 lanes", "ec_smul", {"n": 1025}))
    for R, F in ((64, 32768), (64, 8192), (64, 16384), (16, 16384), (16, 4096), (16, 2048),
                 (16, 128), (64, 524288)):
        out.append((f"ec_pmadd_scan R {R} x F {F}", "ec_pmadd_scan", {"R": R, "F": F}))
    return out


def _sass_counts(lib: Path) -> dict:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    counts, ops = collections.Counter(), collections.defaultdict(collections.Counter)
    fn = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            counts[fn] += 1
            ops[fn][m.group(1).split(".")[0]] += 1
    return {"instructions": dict(counts),
            "field_mul_ops": {f: dict(c.most_common(12)) for f, c in ops.items()
                              if "field_mul" in f}}


def _load(name: str):
    """This checkout's halo_tpu_torch/<name>.py as halo_tpu_torch.<name>,
    into whichever halo_tpu_torch package is imported."""
    spec = importlib.util.spec_from_file_location(f"halo_tpu_torch.{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _work(measure, name: str, key: str, npts: int) -> tuple[int, int]:
    """measure.work at one of profile_ivc.py's launch-shape keys."""
    w = key.split()
    if name in ("field_mul", "field_add", "field_sub"):
        return measure.work(name, int(w[0]), bcast=len(w) > 1)
    if name == "ntt_butterfly":
        return measure.work(name, int(w[0]), half=int(w[2]))
    if name == "ntt_pass":
        return measure.work(name, int(w[0]), s0=int(w[4]), j=int(w[6]), bcast=len(w) > 7)
    if name == "ec_pmadd_scan":
        return measure.work(name, R=int(w[1]), F=int(w[3]), npts=npts)
    if name == "ec_smul":
        return measure.work(name, int(w[0]), bcast=len(w) > 1)
    return measure.work(name, int(w[0]))


def step_bounds(launch_shapes: dict, npts: int = 1 << 16) -> dict:
    """Seconds of the least device time summed over a traced step's
    launches, keyed as profile_ivc.py records them."""
    from halo_tpu_torch import measure

    return {name: sum(count * measure.bound(*_work(measure, name, key, npts))[0] / 1e3
                      for key, count in shapes.items())
            for name, shapes in launch_shapes.items()}


def summarize(results: list) -> None:
    """Per tree: each kernel's device seconds in the traced step, its
    launches, the sum of its bounds and the difference (lost seconds)."""
    for r in results:
        if "profile" not in r:
            continue
        pr = r["profile"]
        bounds = step_bounds(pr["launch_shapes"])
        print(f"{r['tree']}: traced step {pr['step'] - 1}->{pr['step']}, wall {pr['wall_s']:.3f} s, "
              f"device busy {pr['device_busy_s']:.4f} s, idle share {pr['idle_share']:.4f}"
              + (f", streams' overlap {pr['stream_overlap_s']:.4f} s, stream busy "
                 f"{pr['stream_busy_s']}, peak {pr['peak_memory_gib']:.2f} GiB"
                 if "stream_overlap_s" in pr else ""))
        for name, k in pr["port_kernels"].items():
            if k["calls"]:
                print(f"  {name}: {k['device_s']:.4f} s over {k['calls']} launches, bound "
                      f"{bounds[name]:.4f} s, lost {k['device_s'] - bounds[name]:.4f} s")
        if "other_kernels" in pr:
            o = pr["other_kernels"]
            print(f"  other (torch) kernels: {o['device_s']:.4f} s over {o['calls']} launches")
            print("  host calls: " + ", ".join(f"{k} {v['calls']} ({v['host_s']:.3f} s)"
                                               for k, v in pr["host_calls"].items()))
            print(f"  round5.open+accumulate s per step: {pr['round5_open_accumulate_s']}")


def worker(tree: Path, profile_steps: int, prove_reps: int) -> dict:
    sys.path[0] = str(tree)  # in place of this script's directory
    import torch

    from halo_tpu_torch import device as devmod
    from halo_tpu_torch import srs
    from halo_tpu_torch.curves import PALLAS
    from halo_tpu_torch.fields import FQ_MOD, R256
    from halo_tpu_torch.ops import ecrows, ff, kernels, mont, ntt

    try:
        from halo_tpu_torch.ops import poseidon
    except ImportError:  # a tree from before the Schnorr batch
        poseidon = None

    measure = _load("measure")
    dev = devmod.cuda()
    t0 = time.perf_counter()
    kernels.build()
    out = {"tree": str(tree), "card": devmod.card_line(), "build_s": time.perf_counter() - t0,
           "registers": kernels.registers(), "sass": _sass_counts(kernels.library_path())}
    if hasattr(kernels, "local_bytes"):
        out["local_bytes"] = kernels.local_bytes()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = FQ_MOD  # the Pallas base field (EC kernels) and Vesta scalar field

    def fe(*shape):  # canonical words: values below 2^254 < p
        w = torch.randint(-2**31, 2**31 - 1, (8, *shape), generator=gen, device=dev,
                          dtype=torch.int32)
        w[7] &= 0x3FFFFFFF
        return w

    npts = 1 << 16
    table = torch.cat((fe(npts), fe(npts)))
    times = {}
    for label, name, a in _shapes():
        if name == "ntt":  # a whole transform, whichever kernels the tree runs it on
            x = fe(a["k"], a["n"])
            fn = lambda x=x, inv=a.get("inverse", False): ntt.ntt(p, x, inv)  # noqa: E731
            iters = 5
        elif name == "poseidon_permute":
            if poseidon is None:
                continue
            st = fe(3 * a["n"]).reshape(8, 3, a["n"]).permute(1, 0, 2).contiguous()
            fn = lambda st=st: poseidon.permute_batch(p, st)  # noqa: E731
            iters = 5
        elif not hasattr(mont, name):
            continue
        elif name in ("field_mul", "field_add", "field_sub", "ntt_butterfly"):
            x = fe(a["n"])
            if name != "ntt_butterfly":
                y = fe(1) if a.get("bcast") else fe(a["n"])
                if name == "field_sub" and a.get("bcast"):
                    x, y = y, x  # the broadcast operand first, as in 1 - x
                fn = lambda x=x, y=y, f=getattr(mont, name): f(p, x, y)  # noqa: E731
            else:
                tw = fe(a["n"] // 2)
                stride = (a["n"] // 2) // a["half"]
                fn = lambda x=x, tw=tw, s=stride, h=a["half"]: mont.ntt_butterfly(p, x, tw, h, s)  # noqa: E731
            iters = 20
        elif name == "ec_smul":
            xy = torch.cat((fe(1), fe(1))) if a.get("bcast") else table[:, :a["n"]].contiguous()
            k = fe(a["n"])
            fn = lambda xy=xy, k=k: mont.ec_smul(p, xy, k)  # noqa: E731
            iters = 3
        elif name == "ec_pmadd_scan":
            idx = torch.randint(0, npts, (a["R"], a["F"]), generator=gen, device=dev,
                                dtype=torch.int32)
            neg = (torch.rand((a["R"], a["F"]), generator=gen, device=dev) < 0.5).to(torch.uint8)
            fn = lambda idx=idx, neg=neg: mont.ec_pmadd_scan(p, table, idx, neg)  # noqa: E731
            iters = 2 if a["F"] > 100000 else 5
        else:
            P = torch.stack((fe(a["n"]), fe(a["n"]), fe(a["n"])))
            if name == "ec_padd":
                Q = torch.stack((fe(a["n"]), fe(a["n"]), fe(a["n"])))
                fn = lambda P=P, Q=Q: mont.ec_padd(p, P, Q)  # noqa: E731
            elif name == "ec_pmadd":
                xy = torch.cat((fe(a["n"]), fe(a["n"])))
                fn = lambda P=P, xy=xy: mont.ec_pmadd(p, P, xy)  # noqa: E731
            else:
                fn = lambda P=P: mont.ec_pdbl(p, P)  # noqa: E731
            iters = 20
        paced_ms = measure.host_paced_ms(fn, iters)
        times[label] = {"device_ms": measure.device_ms(fn, iters), "paced_ms": paced_ms}
        torch.cuda.empty_cache()
    out["times"] = times

    # the SRS path of every tree: the scalar multiplication and a whole
    # derivation (Pallas: its base field is p)
    r2 = ff.const_rows(R256 * R256 % PALLAS.p, dev)  # the generator in Montgomery rows
    g = torch.cat([mont.field_mul(PALLAS.p, ff.to_rows([c], dev), r2) for c in PALLAS.generator])
    paths = {}
    for n, bcast in ((65538, True), (16386, True), (1025, False)):
        xy = g if bcast else table[:, :n].contiguous()
        k = fe(n)
        fn = lambda xy=xy, k=k: ecrows.scalar_mul_rows(p, xy, k)  # noqa: E731
        label = f"scalar_mul_rows {n} lanes{' bcast' if bcast else ''}"
        paths[label] = {"paced_ms": measure.host_paced_ms(fn, 3),
                        "device_ms": measure.traced_device_ms(fn, 3)}
        torch.cuda.empty_cache()
    for name in ("pallas", "vesta"):
        srs.derive_srs(name, 16, dev)
        devmod.sync(dev)
        t0 = time.perf_counter()
        srs.derive_srs(name, 1 << 16, dev)
        devmod.sync(dev)
        paths[f"derive_srs {name} 2^16"] = {"wall_s": time.perf_counter() - t0}
    out["paths"] = paths

    # 2^14-row proofs of chip_smoke.py's circuit
    from halo_tpu_torch.plonk import protocol, trace

    profile_ivc = _load("profile_ivc")
    data, _ = measure.poseidon_chain(1 << PROVE_LOG_ROWS, SEED).trace()
    runs = []
    for _ in range(1 + prove_reps):
        t0 = time.perf_counter()
        tr = trace.Trace.new(PALLAS, data, dev)
        devmod.sync(dev)
        t_trace = time.perf_counter() - t0
        circuit, x, w = tr.consume()
        with profile_ivc.phase_times() as phases:
            t0 = time.perf_counter()
            protocol.naive_prover(PALLAS, circuit, x, w, dev)
            devmod.sync(dev)
            t_prove = time.perf_counter() - t0
        runs.append({"trace_s": t_trace, "prove_s": t_prove,
                     "round5_s": profile_ivc.phase_by_curve(phases)["pallas"][0]})
    out["prove"] = {"log_rows": PROVE_LOG_ROWS, "first": runs[0], "warm": runs[1],
                    "warm_runs": runs[1:]}

    # the Schnorr batch, where the tree has it: warm verify_batch of
    # SCHNORR_N seeded signatures (Pallas, 10-field messages), after one
    # call that builds the key's tables
    try:
        from halo_tpu_torch import schnorr
    except ImportError:
        schnorr = None
    if schnorr is not None and hasattr(schnorr, "verify_batch"):
        rng = random.Random(SEED)
        sk, pk = schnorr.generate_keypair(PALLAS, rng)
        msgs = [[rng.randrange(PALLAS.p) for _ in range(10)] for _ in range(SCHNORR_N)]
        sigs = schnorr.sign_batch(PALLAS, sk, msgs, dev, rng=rng)
        walls = []
        for _ in range(1 + SCHNORR_CALLS):
            t0 = time.perf_counter()
            if not all(schnorr.verify_batch(PALLAS, pk, msgs, sigs, dev)):
                raise AssertionError("verify_batch rejected a fresh signature")
            walls.append(time.perf_counter() - t0)
        rates = [SCHNORR_N / w for w in walls[1:]]
        out["schnorr"] = {"n": SCHNORR_N, "sig_per_s": rates,
                          "median_sig_per_s": statistics.median(rates)}

    if profile_steps:
        out["profile"] = profile_ivc.profile_step(dev, profile_steps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--worker", type=Path)
    ap.add_argument("--profile-steps", type=int, default=0)
    ap.add_argument("--prove-reps", type=int, default=1, help="warm proofs after the first")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_ab.json"))
    ap.add_argument("--summarize", type=Path,
                    help="print the traced steps' kernel table of an earlier --out file")
    args = ap.parse_args()
    if args.summarize:
        summarize(json.loads(args.summarize.read_text()))
        return 0
    if args.worker:
        res = worker(args.worker.resolve(), args.profile_steps, args.prove_reps)
        print("AB_RESULT " + json.dumps(res), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees is required")
    results = []
    for spec in args.trees:
        path, _, mode = str(spec).partition(":")
        tree = Path(path)
        env = {k: v for k, v in os.environ.items() if k != "HALO_TPU_IVC_SEQUENTIAL"}
        if mode:
            if mode != "seq":
                raise SystemExit(f"{spec}: the only tree mode is PATH:seq")
            env["HALO_TPU_IVC_SEQUENTIAL"] = "1"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree.resolve()),
               "--profile-steps", str(args.profile_steps), "--prove-reps", str(args.prove_reps)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, env=env)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if res.returncode != 0 or not lines:
            print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"worker for {spec} failed ({res.returncode})")
        results.append(json.loads(lines[0][len("AB_RESULT "):]))
        r = results[-1]
        r["tree"] = str(tree.resolve()) + (f":{mode}" if mode else "")
        extra = ""
        if "profile" in r:
            pr = r["profile"]
            split = pr["split_s"]
            extra = (f"; untraced steps s {[round(w, 3) for w in pr.get('untraced_steps_s', [])]}, "
                     f"traced step wall {pr['wall_s']:.3f} s (prove "
                     f"{split.get('prove', float('nan')):.3f} s: pallas "
                     f"{split['prove_pallas']:.3f}, vesta {split['prove_vesta']:.3f}), busy "
                     f"{pr['device_busy_s']:.4f} s, idle {pr['idle_share']:.4f}, streams' overlap "
                     f"{pr['stream_overlap_s']:.4f} s, peak {pr['peak_memory_gib']:.2f} GiB")
        if "schnorr" in r:
            extra += (f"; verify_batch of {r['schnorr']['n']}: median "
                      f"{r['schnorr']['median_sig_per_s']:.1f} sig/s of "
                      f"{[round(v, 1) for v in r['schnorr']['sig_per_s']]}")
        warm = r["prove"]["warm_runs"]
        print(f"[{len(results)}] {tree}: {r['card']}; build {r['build_s']:.2f} s; warm 2^14 "
              f"trace s {[round(w['trace_s'], 3) for w in warm]}, prove s "
              f"{[round(w['prove_s'], 3) for w in warm]} (round5.open+accumulate s "
              f"{[w['round5_s'] for w in warm]}){extra}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    by_tree = collections.defaultdict(list)
    for r in results:
        by_tree[r["tree"]].append(r)
    labels = list(dict.fromkeys(label for r in results for label in r["times"]))
    for label in labels:
        cells = []
        for tree, rs in by_tree.items():
            have = [r["times"][label] for r in rs if label in r["times"]]
            if have:
                dev_ms = statistics.median(t["device_ms"] for t in have)
                paced = statistics.median(t["paced_ms"] for t in have)
                cells.append(f"{Path(tree).name or tree}: {dev_ms:.4f} / {paced:.4f}")
        print(f"{label}: " + "; ".join(cells))
    for label in results[0].get("paths", {}):
        cells = []
        for tree, rs in by_tree.items():
            vals = [r["paths"][label] for r in rs]
            cells.append(f"{Path(tree).name or tree}: " + ", ".join(
                f"{key} {[round(v[key], 4) for v in vals]}" for key in vals[0]))
        print(f"{label}: " + "; ".join(cells))
    summarize(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
