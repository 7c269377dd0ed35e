#!/usr/bin/env python3
"""Drive halo_tpu_torch's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--log-rows 14] [--ivc-steps 2] [--seed 11]

Phases, one line each or more; any failure raises (exit code != 0), and no
phase falls back to the CPU or to a plain version:

  1. device   the card's name and power limit (nvidia-smi); needs CUDA
  2. build    nvcc builds csrc/kernels.cu from this checkout
  3. srs      the Pallas SRS of the PLONK path (2^log_rows generators),
              derived on the card: one ec_smul launch (scalar_mul_rows of
              the generator), the affine normalisation on the card
              (to_affine_rows), one copy to the host; counted, with its
              split (hash, scalars to the card, ec_smul, to_affine_rows,
              copy to the host, total); S, H, 64 seeded generators and the
              last one must equal host ec_mul of their hash scalars
  4. kernels  each kernel against its plain torch version on the card, at
              the shapes of the srs and plonk paths (2^log_rows); results
              must be equal (exact arithmetic: max_abs_err must be 0) and
              canonical (< p).  field_add and field_sub run at the 8n
              extended domain (timed), at (8, 2^19) and at (8, 2^log_rows),
              with either operand one broadcast element, on views whose
              lanes are contiguous at another word stride (cs[:, :h], and
              w[:, :7] of an (8, 8, n) stack), and on the edge values 0, 1,
              p - 1 and pairs whose sum needs the conditional subtract or
              whose difference needs p added back (both fields).  ec_smul runs at the SRS shape (2^log_rows
              + 2 lanes, one broadcast base) and at 1025 and 8449 lanes
              with per-lane bases (four and two threads a lane), each with
              the edge scalars 0, 1, 2, r - 1, r, r + 1, r + 2, 2^255 - 1
              and 2^256 - 1 (bit 255 is not read).  The one-step forms
              ec_pmadd and ec_pdbl, which no path launches, run at the SRS
              shape (2^log_rows + 2 lanes) with identity, P = Q and P = -Q lanes,
              and so does ntt_butterfly, ntt_pass's one-stage form; ntt_pass
              runs every pass of ntt.ntt's plans, each held against its
              plain version, for a forward transform at (8, 16 * 2^log_rows)
              (2^20 at the IVC shape), a forward (8, 3, 4 * 2^log_rows)
              batch and an inverse at (8, 8 * 2^log_rows), each at most 3
              launches, each timed whole and pass by pass against its bound;
              ec_padd on the v1 kernel's cases and field_mul on canonical
              inputs stand for the v1 kernels; field_mul's broadcast form
              is also timed at (8, 2^log_rows) x (8, 1), the IPA fold's
              shape at 2^16 (the kernels line's field_mul "bcast").  Also
              held equal: field_mul on 0, 1, p - 1 and on pairs whose
              product needs the final conditional subtract (both fields),
              ec_padd at each
              thread-group size it picks by width (16384 and 8449 lanes:
              two threads a lane; a _tree_sum width, 2048, and an odd
              width, 1025: four; the timed width: one), the scan at
              depths 16 (an MSM of <= 4096 points) and 64 (IPA rounds)
              with odd lane counts (R 16 x F 2049, R 64 x F 16383) and,
              at 2^16, a 16-poly batched commitment's 2^19 lanes
  5. golden   the port's prover reproduces tests/fixtures/proof_{pallas,
              vesta}.bin byte for byte
  6. plonk    a Pallas Poseidon-chain circuit of 2^log_rows rows (bench.py's
              circuit): a warm-up proof, then the counted and timed run:
              trace, proof (with its round5.open+accumulate phase: the pair
              open of r and r_omega and the accumulation), verify.  The
              proof must equal the warm-up's and the decider MSM the naive
              MSM (srs.msm_naive)
  7. ivc      IVCState.init from tests/fixtures/ivc_consts.json and
              --ivc-steps steps of the 2^16-row IVC chain (both curves'
              proofs, one after the other on one card, the measured
              default), each verified; the SRS of both
              curves at 2^16 is derived first, inside the counted run; each
              step's line gives the provers' joint wall and each one's,
              each curve's round5.open+accumulate and the step's peak
              device memory.  Step 1's proofs must equal
              tests/fixtures/ivc_step1_{pallas,vesta}.bin where those
              exist.  Then the last step's two circuits are proved again
              the other way (at once, each in its own thread on its own
              stream, parallel/pipeline.py), on every card when there are two
              or more (each prover on half of them, its NTTs and
              commitments sharded): the same bytes, 7107 each, both
              verified; its wall and peak memory beside the step's
  8. mesh     the parallel layer on Mesh((card, card)), two logical
              shards of the card (every card when there are two or more):
              the 4-step NTT (parallel/ntt.py) forward at (8, 2^20), the
              inverse at (8, 2^19) and the transposed layout at (8, 2^20),
              each equal to ntt.ntt word for word, with its launches and
              device ms beside ntt.ntt's; the sharded commitment
              (parallel/msm.py) of an (8, 3, 2^16) stack, equal to
              msm2_srs_rows_multi's points; then the counted run: the
              last IVC step's 2^16-row Pallas circuit proved on a mesh
              Engine (4-step NTTs, sharded commitments), its bytes equal
              to the step's single-device proof, verified, its wall beside
              the single-device one.  Shards on one card exchange nothing
              between cards: those times measure no traffic between cards
  9. kernels  phase 4 again at the IVC path's shapes (2^16 rows: 2^16 + 2
              SRS lanes, the 8 * 2^16 extended domain, a 2^16 commitment's
              scan), over each curve's fields; the kernels line reports
              the Pallas ones
  10. schnorr poseidon_permute against its plain version at (3, 8, 8192)
              and at 1, 7, 10, 11 and 8195 states (partly filled warps of
              ten states) on both fields, timed at 8192 and 2^16 states; then the
              counted run on Pallas: sign_batch of 8192 seeded 10-field
              messages (one ec_smul launch, one hash batch of 8
              poseidon_permute launches), verify_batch of them (8 more,
              one ec_pmadd_scan of 65 steps): every lane must pass, and
              eight seeded lanes must pass host verify too; then
              verify_batch warm (sig/s, median and spread of 7
              calls, and the split of 3 more: its stages run in turn,
              packing, hash, scan, compare); ec_smul (sign_batch's nonces,
              the generator broadcast over 8192 lanes) and ec_pmadd_scan
              (the last split's 65 x 8192 indices over the 16,385-point
              table) against their plain versions, timed; bench.py's control (s of lane 0 flipped: lane 0
              alone fails), three tamperings (s, message, R: those lanes
              alone fail), and Vesta at 512 signatures with one flipped s
  11. hiding  hiding IPA commitments at the IVC's width, n = 2^16, on
              Pallas, over the SRS the ivc phase derived, with a seeded
              random.Random: the counted run (pcdl.Instance.open with a
              blinding factor, its split from the open's RoundTimer: host
              draws of q and w_bar, q to the card, the blinding p_bar,
              C_bar, p', the IPA rounds; pcdl.check; the instance's bytes
              read back unchanged; two hiding instances and a non-hiding
              one accumulated: acc.prover, verifier, decider, each timed;
              peak device memory) must launch field_mul, field_add,
              field_sub, ec_padd and ec_pmadd_scan; then pcdl.check must
              reject w' + 1, another C_bar and v + 1; chunked_commit of
              3 * 2^10 + 5 coefficients, with and without w, must equal
              commit of each chunk (+ w*S), the chunks' sum commit of
              their elementwise sum; and at 2^8 on both curves the card's
              hiding proof bytes must equal the CPU's (the plain
              versions) for the same seed

Each counted run (srs, plonk, ivc, mesh, schnorr, hiding) sets every kernel's launch count to 0
just before it and reads the counts just after; a kernel of that path with
no launch fails the run, and so does any launch of ec_pmadd, ec_pdbl or
ntt_butterfly, an NTT (ntt.ntt) of more than 3 ntt_pass launches, a
derivation that launches ec_smul other than once, or any call of the
plain limb code's ff.canon on a CUDA tensor (the plain field add/sub used
to block the host on every carry round; the line also gives the operand
copies a wrapper made because a view's lanes were not contiguous).  The last three
lines: the kernels JSON (each kernel's `launches` is the IVC run's count,
poseidon_permute's the schnorr run's, as `launches_path` names it;
`launches_by_path` gives every run's), the nvidia-smi line, and
{"ok": true, "device": {...}}.  The script imports torch and halo_tpu_torch only, never jax or
halo_tpu; the run fails if any module of either was loaded.

A kernel's ms is host-paced, as since the first port: the wrapper called
back to back between two CUDA events, which for a kernel shorter than
~0.03 ms reads how fast the host issues the wrapper.  device_ms beside it
is the same calls captured in a CUDA graph and replayed: the kernel's own
time.  plain_ms is host-paced.

bound_ms is the least time the card could take for a kernel's work at the
timed shape (halo_tpu_torch/measure.py: work() and bound()): the larger
of its bytes (each input read once, each output written once) over
3.35 TB/s and its 32-bit multiply-adds (136 per field product; 24 ops
per field add where a kernel's adds are counted, poseidon_permute) over
16.7 T/s (132 SMs x 64 multiply-adds per clock x 1.98 GHz, the integer
rate of an H100 SXM at its 700 W limit).  ntt_pass's entry in the kernels
line is one whole transform at (8, 2^20), its passes back to back, against
the transform's bound (measure.work "ntt"), with each pass beside its own.
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
    "ec_pmadd": "halo_tpu/ops/pallas_mont.py:308",
    "ec_pdbl": "halo_tpu/ops/pallas_mont.py:410",
    "ec_smul": "halo_tpu/ops/pallas_mont.py:410",
    "field_add": "halo_tpu/ops/ff.py:129",
    "field_sub": "halo_tpu/ops/ff.py:134",
    "poseidon_permute": "halo_tpu/ops/poseidon.py:57",
    "ntt_pass": "halo_tpu/ops/pallas_mont.py:459",
}
# field_add and field_sub replace XLA fusions (the JAX engine's add_jit,
# sub_jit), not Pallas kernels; poseidon_permute replaces permute_batch's
# lax.scan, which XLA fused into one dispatch
XLA_FUSIONS = ("field_add", "field_sub", "poseidon_permute")
# ec_smul is the ladder of both point kernels and the loop around them
# ntt_pass is several stages of the butterfly and the gather and stage loop
# around them
REPLACES_ALSO = {"ec_smul": ["halo_tpu/ops/pallas_mont.py:308", "halo_tpu/ops/pallas_ec.py:149",
                             "halo_tpu/ops/ecrows.py:60"],
                 "ntt_pass": ["halo_tpu/ops/ntt.py:211"]}
# which counted run drives which kernels; the one-step forms ec_pmadd and
# ec_pdbl, and ntt_pass's one-stage form ntt_butterfly, run on no path
PATH_KERNELS = {
    "srs": ("field_mul", "ec_smul"),
    "plonk": ("field_mul", "ntt_pass", "ec_padd", "ec_pmadd_scan", "field_add", "field_sub"),
    "ivc": ("field_mul", "ntt_pass", "ec_padd", "ec_pmadd_scan", "ec_smul", "field_add",
            "field_sub"),
    "schnorr": ("field_mul", "field_add", "field_sub", "ec_smul", "ec_pmadd_scan",
                "poseidon_permute"),
    "mesh": ("field_mul", "ntt_pass", "ec_padd", "ec_pmadd_scan", "field_add", "field_sub"),
    "hiding": ("field_mul", "field_add", "field_sub", "ec_padd", "ec_pmadd_scan"),
}
OFF_PATH = ("ec_pmadd", "ec_pdbl", "ntt_butterfly")
NTT_MAX_PASSES = 3  # ntt_pass launches a transform of n <= 2^24
# the counted run a kernel's `launches` comes from: the IVC step's, as
# since the first slice, except for a kernel that runs only on a later path
LAUNCHES_FROM = {"poseidon_permute": "schnorr"}
IVC_LOG_ROWS = 16
IVC_ROWS = 1 << IVC_LOG_ROWS
SCHNORR_N = 8192  # bench.py:381's batch
SCHNORR_VESTA_N = 512
SCHNORR_MSG = 10  # fields a message
POSEIDON_WIDE = 1 << 16  # states: a poseidon_permute launch that fills the card
POSEIDON_ODD = (1, 7, 10, 11, 8195)  # widths that end in a partly filled warp, or none
HIDING_CHUNK = 1 << 10  # chunked_commit's default chunk size
HIDING_CHUNKED = 3 * HIDING_CHUNK + 5  # coefficients: three full chunks and one of 5
HIDING_CPU_ROWS = 1 << 8  # the card's hiding proofs against the CPU's, both curves


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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


def _counted(name: str, fn):
    """Run fn with every launch count set to 0 first; returns (fn's result,
    the counts after).  Fails if a kernel of the path was not launched, if
    one off every path was, if an NTT took more than NTT_MAX_PASSES
    ntt_pass launches, or if the plain limb code (ff.canon) ran on a CUDA
    tensor."""
    from halo_tpu_torch.ops import ff, kernels, ntt

    canon, transform = ff.canon, ntt.ntt
    on_card, passes = [], []

    def counted_canon(m, v):
        if v.device.type == "cuda":
            on_card.append(tuple(v.shape))
        return canon(m, v)

    def counted_ntt(*args, **kwargs):  # this thread's launches: provers may run at once
        before = kernels.thread_launches("ntt_pass")
        out = transform(*args, **kwargs)
        passes.append(kernels.thread_launches("ntt_pass") - before)
        return out

    kernels.reset_counts()
    ff.canon, ntt.ntt = counted_canon, counted_ntt
    try:
        out = fn()
    finally:
        ff.canon, ntt.ntt = canon, transform
    launches = kernels.counts()
    missing = [k for k in PATH_KERNELS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {name} path launched no {missing}")
    stray = [k for k in OFF_PATH if launches[k]]
    if stray:
        raise AssertionError(f"the {name} path launched {stray}")
    if on_card:
        raise AssertionError(f"the {name} path ran ff.canon on {len(on_card)} CUDA tensors "
                             f"(first {on_card[0]})")
    if passes and max(passes) > NTT_MAX_PASSES:
        raise AssertionError(f"the {name} path ran an NTT in {max(passes)} ntt_pass launches")
    ntts = f"; {len(passes)} NTTs in {sum(passes)} ntt_pass launches, at most " \
           f"{max(passes)} a transform" if passes else ""
    _phase(name, f"ff.canon calls on CUDA tensors: 0; operand copies before a launch: "
                 f"{json.dumps({k: v for k, v in kernels.copies().items() if v})}{ntts}")
    return out, launches


def _kernels_vs_plain(dev, cfg, log_rows: int, seed: int) -> dict:
    """Each kernel against its plain version, over cfg's fields, at the
    shapes a path of 2^log_rows rows gives it."""
    import torch

    from halo_tpu_torch import measure, srs
    from halo_tpu_torch.curves import ec_mul
    from halo_tpu_torch.ops import ecrows, ff, mont, msm2

    rng = random.Random(seed)
    m = cfg.r  # scalar field: the engine's muls and NTTs
    p = cfg.p  # base field: the EC kernels
    n = 1 << log_rows
    big_n = 8 * n  # the extended domain of the prover's NTTs
    out = {}

    def rows(mod, k):
        return ff.to_rows([rng.randrange(mod) for _ in range(k)], dev)

    def report(name, got, want, modulus, call, iters, plain, work):
        """Hold got against want, then time `call` (the kernel wrapper) and
        `plain` (its plain version) at this shape; work: measure.work()."""
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain differ (max_abs_err {err})")
        words = (got if got.dim() == 2 else got.transpose(0, 1)).reshape(8, -1)
        vals = ff.from_rows(words[:, :: max(1, words.shape[1] // 4096)])
        if max(vals) >= modulus:
            raise AssertionError(f"{name}: output not canonical")
        bound_ms, bound_by = measure.bound(*work)
        ms = measure.host_paced_ms(call, iters)
        dev_ms = measure.device_ms(call, iters)
        # the plain versions take 4-400 ms a call: 3 calls, 1 for the scan
        plain_ms = measure.host_paced_ms(plain, 3 if iters > 5 else 1)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "device_ms": dev_ms,
                     "shape": list(got.shape)}
        _phase("kernels", f"{name} ({cfg.name}): equal to plain, {tuple(got.shape)}; "
                          f"kernel {ms:.4f} ms host-paced ({dev_ms:.4f} ms device), plain "
                          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    def equal(name, got, want):
        if not got.equal(want):
            raise AssertionError(f"{name}: kernel and plain differ")

    # field_mul at the 8n extended domain; also the broadcast (mulc) form,
    # and canonical (non-Montgomery) operands, the v1 pallas_ff product
    a, b = rows(m, big_n), rows(m, big_n)
    report("field_mul", mont.field_mul(m, a, b), mont.field_mul_plain(m, a, b), m,
           lambda: mont.field_mul(m, a, b), 20, lambda: mont.field_mul_plain(m, a, b),
           measure.work("field_mul", big_n))
    if not mont.field_mul(m, a, b[:, :1]).equal(mont.field_mul_plain(m, a, b[:, :1])):
        raise AssertionError("field_mul: broadcast form differs from plain")
    # the broadcast form (the TPU's _mulc_kernel) timed at the IPA fold's
    # shape, (8, n) x (8, 1)
    a1, b1 = a[:, :n].contiguous(), b[:, :1].contiguous()
    equal("field_mul broadcast form", mont.field_mul(m, a1, b1), mont.field_mul_plain(m, a1, b1))
    bound_ms, bound_by = measure.bound(*measure.work("field_mul", n, bcast=True))
    out["field_mul"]["bcast"] = {
        "shape": [8, n], "ms": measure.host_paced_ms(lambda: mont.field_mul(m, a1, b1), 20),
        "device_ms": measure.device_ms(lambda: mont.field_mul(m, a1, b1), 20),
        "plain_ms": measure.host_paced_ms(lambda: mont.field_mul_plain(m, a1, b1), 3),
        "bound_ms": bound_ms, "bound_by": bound_by}
    _phase("kernels", f"field_mul broadcast form ({cfg.name}), (8, {n}) x (8, 1): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in out["field_mul"]["bcast"].items()
                                  if k.endswith("ms")))
    xs = [rng.randrange(m) for _ in range(64)]
    ys = [rng.randrange(m) for _ in range(64)]
    rinv = pow(1 << 256, -1, m)
    got = ff.from_rows(mont.field_mul(m, ff.to_rows(xs, dev), ff.to_rows(ys, dev)))
    if got != [x * y * rinv % m for x, y in zip(xs, ys)]:
        raise AssertionError("field_mul: canonical product differs from x*y/R")
    # the field core's edge values on both fields: 0, 1, p - 1 against each
    # other, and pairs whose product lands in [p, 2p) before the final
    # conditional subtract
    for mod in (cfg.r, cfg.p):
        edge = [0, 1, mod - 1]
        xs = [x for x in edge for _ in edge] + [x for x, _ in _subtract_pairs(mod, rng, 64)]
        ys = edge * 3 + [y for _, y in _subtract_pairs(mod, rng, 64)]
        xr, yr = ff.to_rows(xs, dev), ff.to_rows(ys, dev)
        equal("field_mul edge values", mont.field_mul(mod, xr, yr),
              mont.field_mul_plain(mod, xr, yr))
        if ff.from_rows(mont.field_mul(mod, xr, yr)) != [
                x * y * pow(1 << 256, -1, mod) % mod for x, y in zip(xs, ys)]:
            raise AssertionError("field_mul: an edge-value product differs from x*y/R")

    # field_add and field_sub, timed at the 8n extended domain (the gate
    # constraints' width), then held at (8, 2^19) and (8, n) whole, with
    # either operand one broadcast element, and on views read in place:
    # cs[:, :h] against cs[:, h:2h] (the IPA fold), w[:, :7] of an (8, 8,
    # n) stack (w_big[:, :S_POLYS]); then the edge values on both fields
    wide = 1 << 19
    a19, b19 = a.repeat(1, max(1, wide // big_n)), b.repeat(1, max(1, wide // big_n))
    stack_a, stack_b = a.reshape(8, 8, n), b.reshape(8, 8, n)
    for name, fn, plain in (("field_add", mont.field_add, mont.field_add_plain),
                            ("field_sub", mont.field_sub, mont.field_sub_plain)):
        report(name, fn(m, a, b), plain(m, a, b), m, lambda fn=fn: fn(m, a, b), 20,
               lambda plain=plain: plain(m, a, b), measure.work(name, big_n))
        for x, y in ((a19, b19), (a19, b19[:, 5:6]), (b19[:, 5:6], a19), (a[:, :n], b[:, :n]),
                     (a[:, :n], b[:, 3:4]), (b[:, 3:4], a[:, :n]), (a[:, :n], a[:, n:2 * n]),
                     (stack_a[:, :7], stack_b[:, 1:]), (stack_b[:, 1:4], a[:, 7:8])):
            equal(f"{name} {tuple(x.shape)} {tuple(y.shape)}", fn(m, x, y), plain(m, x, y))
        for mod in (cfg.r, cfg.p):
            xs, ys = _addsub_edges(mod, rng)
            xr, yr = ff.to_rows(xs, dev), ff.to_rows(ys, dev)
            got = fn(mod, xr, yr)
            equal(f"{name} edge values", got, plain(mod, xr, yr))
            sign = 1 if name == "field_add" else -1
            if ff.from_rows(got) != [(x + sign * y) % mod for x, y in zip(xs, ys)]:
                raise AssertionError(f"{name}: an edge value differs from host ints")

    # one butterfly stage over the 8n domain (half = 2^10 of a 2^(log n) table)
    half, tw = min(1 << 10, big_n // 2), rows(m, big_n // 2)
    stride = (big_n // 2) // half
    report("ntt_butterfly", mont.ntt_butterfly(m, a, tw, half, stride),
           mont.ntt_butterfly_plain(m, a, tw, half, stride), m,
           lambda: mont.ntt_butterfly(m, a, tw, half, stride), 20,
           lambda: mont.ntt_butterfly_plain(m, a, tw, half, stride),
           measure.work("ntt_butterfly", big_n, half=half))
    _ntt_vs_plain(m, out, torch.cat((a, b), 1), torch.cat((a, b[:, :4 * n]), 1).reshape(8, 3, 4 * n),
                  b, cfg.name)

    # points: the PLONK path's SRS generators; the identity, equal and
    # opposite lanes a complete formula must get right come first
    xy = srs.srs_pack(cfg.name, n, dev)
    one = ff.mont_one(p, dev)

    def proj(lo, hi):
        return torch.stack((xy[:8, lo:hi], xy[8:, lo:hi], one.expand(8, hi - lo)))

    def affine_of(P):
        return ecrows.to_affine_ints(p, P)

    ident = ecrows.identity_rows(p, (1,), dev)
    A, B = proj(0, 1), proj(1, 2)
    neg_a = torch.stack((A[0], mont.field_neg(p, A[1]), A[2]))
    P = torch.cat((ident, A, A, A, ident, proj(2, 34)), -1)
    Q = torch.cat((B, ident, A, neg_a, ident, proj(34, 66)), -1)
    S = affine_of(mont.ec_padd(p, P, Q))
    on_curve = all(q is not None and cfg.is_on_curve(q) for q in [S[2]] + S[5:])
    if S[0] != affine_of(B)[0] or S[1] != affine_of(A)[0] or S[3:5] != [None, None] \
            or not on_curve:
        raise AssertionError("ec_padd: wrong sum on an edge lane (the v1 add's cases)")
    # the bucket-assembly width of a 16-poly commitment (512 windows x 129 buckets)
    reps = (512 * 129) // P.shape[-1] + 1
    Pw, Qw = P.repeat(1, 1, reps), Q.repeat(1, 1, reps)
    report("ec_padd", mont.ec_padd(p, Pw, Qw), mont.ec_padd_plain(p, Pw, Qw), p,
           lambda: mont.ec_padd(p, Pw, Qw), 20, lambda: mont.ec_padd_plain(p, Pw, Qw),
           measure.work("ec_padd", Pw.shape[-1]))
    # every thread-group size the kernel picks by width on the main path
    # (kernels.cu group_for; on 132 SMs): the IVC step's 16,384-lane
    # launches and the narrowest two-thread width, 8,449 (G = 2); a
    # _tree_sum level's width, 2048, and an odd width whose last warp
    # holds dead lanes, 1025 (G = 4); the width above is G = 1
    for lanes in (16384, 8449, 2048, 1025):
        equal(f"ec_padd at {lanes} lanes", mont.ec_padd(p, Pw[..., :lanes], Qw[..., :lanes]),
              mont.ec_padd_plain(p, Pw[..., :lanes], Qw[..., :lanes]))

    # ec_pmadd and ec_pdbl at the SRS derivation's shape (n + 2 lanes):
    # lanes identity + A, A + A, A + (-A), then SRS generators in turn
    lanes = n + 2
    reps = lanes // n + 1
    Pd = torch.cat((ident, A, A, proj(0, n).repeat(1, 1, reps)), -1)[:, :, :lanes].contiguous()
    ax, ay = xy[:8, :1], xy[8:, :1]
    nay = mont.field_neg(p, ay)
    Qd = torch.cat((torch.cat((ax, ay)), torch.cat((ax, ay)), torch.cat((ax, nay)),
                    xy.roll(1, -1).repeat(1, reps)), -1)[:, :lanes].contiguous()
    S = affine_of(mont.ec_pmadd(p, Pd[:, :, :8], Qd[:, :8]))
    D = affine_of(mont.ec_pdbl(p, Pd[:, :, :8]))
    a_pt, a2 = affine_of(A)[0], affine_of(mont.ec_padd(p, A, A))[0]
    if S[:3] != [a_pt, a2, None] or D[:3] != [None, a2, a2] \
            or not all(cfg.is_on_curve(q) for q in S[3:] + D[3:]):
        raise AssertionError("ec_pmadd/ec_pdbl: wrong result on an edge lane")
    report("ec_pmadd", mont.ec_pmadd(p, Pd, Qd), mont.ec_pmadd_plain(p, Pd, Qd), p,
           lambda: mont.ec_pmadd(p, Pd, Qd), 20, lambda: mont.ec_pmadd_plain(p, Pd, Qd),
           measure.work("ec_pmadd", lanes))
    g = Qd[:, :1].contiguous()  # one broadcast base, as the SRS derivation adds G
    if not mont.ec_pmadd(p, Pd, g).equal(mont.ec_pmadd_plain(p, Pd, g)):
        raise AssertionError("ec_pmadd: broadcast form differs from plain")
    # the derivation's field_mul: G into Montgomery form (one lane, broadcast R^2)
    gx, r2 = Qd[:8, :1].contiguous(), Qd[8:, :1].contiguous()
    if not mont.field_mul(p, gx, r2).equal(mont.field_mul_plain(p, gx, r2)):
        raise AssertionError("field_mul: the one-lane broadcast form differs from plain")
    report("ec_pdbl", mont.ec_pdbl(p, Pd), mont.ec_pdbl_plain(p, Pd), p,
           lambda: mont.ec_pdbl(p, Pd), 20, lambda: mont.ec_pdbl_plain(p, Pd),
           measure.work("ec_pdbl", lanes))

    # ec_smul at the SRS derivation's shape (n + 2 lanes, the generator
    # broadcast: four threads a lane up to 8,448 lanes, two up to 16,896,
    # one above), then with per-lane bases at 1025 (four threads a lane)
    # and 8449 lanes (two); the edge scalars come first in every batch
    r = cfg.r
    edge = [0, 1, 2, r - 1, r, r + 1, r + 2, (1 << 255) - 1, (1 << 256) - 1]

    def scalars(k):
        return ff.to_rows(edge + [rng.randrange(1 << 256) for _ in range(k - len(edge))], dev)

    k_srs = scalars(lanes)
    g = ecrows.pack_points(p, [cfg.generator[0]], [cfg.generator[1]], dev)
    report("ec_smul", mont.ec_smul(p, g, k_srs), mont.ec_smul_plain(p, g, k_srs), p,
           lambda: mont.ec_smul(p, g, k_srs), 3, lambda: mont.ec_smul_plain(p, g, k_srs),
           measure.work("ec_smul", lanes, bcast=True))
    want = [ec_mul(cfg, cfg.generator, k % (1 << 255)) for k in edge]
    if affine_of(mont.ec_smul(p, g, k_srs[:, :len(edge)].contiguous())) != want:
        raise AssertionError("ec_smul: an edge scalar's multiple differs from host ec_mul")
    for width in (1025, 8449):
        k_w, xy_w = scalars(width), xy.repeat(1, width // n + 1)[:, :width].contiguous()
        equal(f"ec_smul at {width} lanes", mont.ec_smul(p, xy_w, k_w),
              mont.ec_smul_plain(p, xy_w, k_w))

    # ec_pmadd_scan at a commitment's scan shape: 2^log_rows SRS points,
    # one poly's windows (c = 8: 32) x its lanes, R steps
    L = msm2.choose_lanes(n)
    R, F = n // L, 32 * L
    gen = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n, (R, F), generator=gen, dtype=torch.int32).to(dev)
    neg = (torch.rand((R, F), generator=gen) < 0.5).to(dev)
    report("ec_pmadd_scan", mont.ec_pmadd_scan(p, xy, idx, neg),
           mont.ec_pmadd_scan_plain(p, xy, idx, neg), p,
           lambda: mont.ec_pmadd_scan(p, xy, idx, neg), 5,
           lambda: mont.ec_pmadd_scan_plain(p, xy, idx, neg),
           measure.work("ec_pmadd_scan", R=R, F=F, npts=n))
    # depths 16 (an MSM of <= 4096 points) and 64 (IPA rounds) with lane
    # counts whose last warp holds dead lanes, and (at 2^16) a 16-poly
    # batched commitment's 2^19 lanes
    shapes = [(16, 2049), (64, 16383)] + ([(R, 16 * F)] if log_rows == IVC_LOG_ROWS else [])
    for r_, f_ in shapes:
        idx = torch.randint(0, n, (r_, f_), generator=gen, dtype=torch.int32).to(dev)
        neg = (torch.rand((r_, f_), generator=gen) < 0.5).to(dev)
        equal(f"ec_pmadd_scan R {r_} x F {f_}", mont.ec_pmadd_scan(p, xy, idx, neg),
              mont.ec_pmadd_scan_plain(p, xy, idx, neg))
    _phase("kernels", f"{cfg.name}: edge-value products, field_add and field_sub at (8, "
                      f"{wide}) and (8, {n}) with either operand broadcast, on strided views "
                      f"and on the edge values, ec_padd at 16384, 8449, 2048 "
                      f"and 1025 lanes, ec_smul at {lanes} (broadcast base), 1025 and 8449 "
                      f"lanes with the edge scalars, scans at {shapes} equal to plain")
    return out


def _ntt_vs_plain(m: int, out: dict, x16, batch, x8, curve: str) -> None:
    """ntt_pass against its plain version, pass by pass, through ntt.ntt's
    plans: a forward transform of x16 (8, 16n), the forward (8, 3, 4n)
    batch and the inverse of x8 (8, 8n); each plan at most NTT_MAX_PASSES
    launches.  Each whole transform is timed (its passes back to back) and
    held against the transform's bound (measure.work "ntt"), each pass of
    x16's against its own; out["ntt_pass"] is x16's transform."""
    from halo_tpu_torch import measure
    from halo_tpu_torch.ops import ff, mont, ntt

    cases = {}
    for label, x, inverse in (("forward", x16, False), ("batch", batch, False),
                              ("inverse", x8, True)):
        nn = x.shape[-1]
        log_n = nn.bit_length() - 1
        tw, n_inv = ntt._plan_dev(m, log_n, inverse, x.device)
        plan = ntt._passes(log_n)
        if len(plan) > NTT_MAX_PASSES:
            raise AssertionError(f"ntt: {len(plan)} passes at n = 2^{log_n}")
        y, passes = x.reshape(8, -1), []
        for i, (s0, j) in enumerate(plan):
            scale = n_inv if i == len(plan) - 1 else None
            got = mont.ntt_pass(m, y, tw, log_n, s0, j, scale)
            if not got.equal(mont.ntt_pass_plain(m, y, tw, log_n, s0, j, scale)):
                raise AssertionError(f"ntt_pass s0 {s0} j {j} at {tuple(x.shape)}: kernel "
                                     f"and plain differ")
            bound_ms, bound_by = measure.bound(*measure.work(
                "ntt_pass", y.shape[1], s0=s0, j=j, bcast=scale is not None))
            passes.append({"s0": s0, "j": j, "bound_ms": bound_ms, "bound_by": bound_by,
                           "device_ms": measure.device_ms(
                               lambda y=y, s0=s0, j=j, sc=scale: mont.ntt_pass(
                                   m, y, tw, log_n, s0, j, sc), 10)})
            y = got
        got = ntt.ntt(m, x, inverse)
        err = int((got.long() - y.reshape(x.shape).long()).abs().max())
        if err != 0:
            raise AssertionError(f"ntt.ntt at {tuple(x.shape)} differs from its passes")
        if max(ff.from_rows(y[:, :: max(1, y.shape[1] // 4096)])) >= m:
            raise AssertionError(f"ntt.ntt at {tuple(x.shape)}: output not canonical")
        bound_ms, bound_by = measure.bound(*measure.work("ntt", y.shape[1], log_n=log_n,
                                                         bcast=inverse))
        dev_ms = measure.device_ms(lambda x=x, inv=inverse: ntt.ntt(m, x, inv), 10)
        cases[label] = {"shape": list(x.shape), "inverse": inverse, "launches": len(plan),
                        "max_abs_err": err,
                        "device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "passes": passes}
        _phase("kernels", f"ntt_pass ({curve}), {label} transform {tuple(x.shape)}: every pass "
                          f"equal to plain; {len(plan)} launches {[(p['s0'], p['j']) for p in passes]}, "
                          f"{dev_ms:.4f} ms device, bound {bound_ms:.4f} ms ({bound_by}): "
                          f"{bound_ms / dev_ms:.0%}; passes "
                          + ", ".join(f"{p['device_ms']:.4f}/{p['bound_ms']:.4f}" for p in passes))
    tw, _ = ntt._plan_dev(m, x16.shape[-1].bit_length() - 1, False, x16.device)

    def plain():
        y, log_n = x16, x16.shape[-1].bit_length() - 1
        for s0, j in ntt._passes(log_n):
            y = mont.ntt_pass_plain(m, y, tw, log_n, s0, j)
        return y

    fwd = cases["forward"]
    ms = measure.host_paced_ms(lambda: ntt.ntt(m, x16), 10)
    out["ntt_pass"] = {"max_abs_err": fwd["max_abs_err"], "ms": ms, "plain_ms": measure.host_paced_ms(plain, 1),
                       "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
                       "library_ms": None, "device_ms": fwd["device_ms"],
                       "shape": fwd["shape"], "timed": "one whole transform, its passes",
                       "transforms": cases}


def _addsub_edges(m: int, rng) -> tuple[list[int], list[int]]:
    """0, 1, m - 1 against each other, 32 pairs whose sum is at least m
    (the conditional subtract) and 32 whose difference is negative (m
    added back)."""
    edge = [0, 1, m - 1]
    hi = [rng.randrange(m // 2, m) for _ in range(32)]
    lo = [rng.randrange(m // 2) for _ in range(32)]
    xs = [x for x in edge for _ in edge] + hi + lo
    ys = edge * 3 + hi[::-1] + [x + rng.randrange(1, m - x) for x in lo]
    return xs, ys


def _split_line(split: dict) -> str:
    return (f"hash {split['hash']:.3f} s, scalars to the card {split['to_card']:.3f} s, "
            f"ec_smul {split['ec_smul']:.3f} s, to_affine_rows {split['to_affine_rows']:.3f} s, "
            f"copy to the host {split['to_host']:.3f} s, total {split['total']:.3f} s")


def _check_srs(pp, seed: int) -> list[int]:
    """S, H, 64 seeded generators and the last one of a derived SRS against
    host ec_mul of their hash scalars; returns the generators checked."""
    from halo_tpu_torch import srs
    from halo_tpu_torch.curves import ec_mul

    cfg, n = pp.cfg, len(pp)
    if (pp.S, pp.H) != srs.load_sh(cfg.name):
        raise AssertionError("derived S, H differ from host ec_mul")
    js = sorted(random.Random(seed).sample(range(n - 1), 64)) + [n - 1]
    for j in js:
        i = sum(divmod(j, srs.G_BLOCKS_SIZE)) + 2
        if pp.g_affine(j) != ec_mul(cfg, cfg.generator, srs._hash_scalar(cfg, i)):
            raise AssertionError(f"SRS generator {j} differs from host ec_mul")
    return js


def _subtract_pairs(m: int, rng, k: int) -> list[tuple[int, int]]:
    """k operand pairs whose Montgomery product (a*b + M*m) / 2^256, M =
    -a*b/m mod 2^256, lands in [m, 2m): the final subtract must fire."""
    r = 1 << 256
    minv = -pow(m, -1, r) % r
    out = []
    while len(out) < k:
        a, b = rng.randrange(m), rng.randrange(m)
        if (a * b + (a * b * minv % r) * m) >> 256 >= m:
            out.append((a, b))
    return out


def _plonk_path(dev, log_rows: int, seed: int) -> dict:
    import torch

    from halo_tpu_torch import device as devmod
    from halo_tpu_torch import measure, pcdl, srs
    from halo_tpu_torch.curves import PALLAS
    from halo_tpu_torch.ops import msm2
    from halo_tpu_torch.plonk import protocol, trace
    from halo_tpu_torch.profile_ivc import phase_by_curve, phase_times

    cfg = PALLAS
    n = 1 << log_rows
    fp_data, _ = measure.poseidon_chain(n, seed).trace()
    if fp_data.rows != n:
        raise AssertionError(f"circuit has {fp_data.rows} rows, wanted {n}")

    # warm-up: one trace and proof, outside the counted and timed run
    t0 = time.perf_counter()
    circuit, x, w = trace.Trace.new(cfg, fp_data, dev).consume()
    warm = protocol.naive_prover(cfg, circuit, x, w, dev).to_bytes(cfg)
    t_warm = time.perf_counter() - t0

    def run():
        times = {}
        t0 = time.perf_counter()
        tr = trace.Trace.new(cfg, fp_data, dev)
        devmod.sync(dev)
        times["trace"] = time.perf_counter() - t0
        circuit, x, w = tr.consume()
        with phase_times() as phases:
            t0 = time.perf_counter()
            proof = protocol.naive_prover(cfg, circuit, x, w, dev)
            devmod.sync(dev)
            times["prove"] = time.perf_counter() - t0
        times["round5"] = phase_by_curve(phases)[cfg.name][0]
        t0 = time.perf_counter()
        protocol.verify(cfg, proof, circuit, x, dev)
        times["verify"] = time.perf_counter() - t0
        return proof, times

    torch.cuda.reset_peak_memory_stats(dev)
    (proof, times), launches = _counted("plonk", run)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if proof.to_bytes(cfg) != warm:
        raise AssertionError("two proofs of the same witness differ")

    # the decider's MSM, once more, against an MSM that shares no code
    # with the bucket MSM (uncounted: a check, not the path)
    acc = proof.acc_next.q
    h, U = pcdl.succinct_check(cfg, acc.C, acc.d, acc.z, acc.v, acc.pi)
    coeffs = h.coeffs()
    t0 = time.perf_counter()
    naive = srs.msm_naive(cfg, coeffs, dev)
    t_naive = time.perf_counter() - t0
    if msm2.msm2_srs(cfg, coeffs, dev) != U or naive != U:
        raise AssertionError("decider MSM disagrees with the naive MSM")
    _phase("plonk", f"{cfg.name} Poseidon chain, 2^{log_rows} rows: trace {times['trace']:.3f} s, "
                    f"prove {times['prove']:.3f} s (round5.open+accumulate "
                    f"{times['round5']:.3f} s), verify {times['verify']:.3f} s (warm-up "
                    f"trace + prove {t_warm:.2f} s); peak device memory {peak_gib:.2f} GiB; "
                    f"proof {len(warm)} bytes verified; decider MSM of {len(coeffs)} points "
                    f"equal to the naive MSM ({t_naive:.3f} s)")
    _phase("plonk", f"kernel launches: {json.dumps(launches)}")
    return launches


def _ivc_path(dev, steps: int, card: str):
    """The counted IVC run (both SRS, init, `steps` steps, the provers as
    ivc.at_once decides: on one card in turn), then the last step's two
    circuits proved again the other way: the same bytes.  Returns (the
    counted run's launches, the last state, the last step's
    (cfg, circuit, public inputs, witness) of each proof)."""
    import torch

    from halo_tpu_torch import srs
    from halo_tpu_torch.curves import PALLAS, VESTA
    from halo_tpu_torch.frontend import ivc
    from halo_tpu_torch.frontend.ivc import IVCState, _params_from_reference_fixture
    from halo_tpu_torch.ops import kernels
    from halo_tpu_torch.parallel.mesh import Mesh, data_mesh
    from halo_tpu_torch.plonk import protocol
    from halo_tpu_torch.profile_ivc import phase_by_curve, phase_times

    gold = {c: ROOT / "tests" / "fixtures" / f"ivc_step1_{c}.bin" for c in ("pallas", "vesta")}

    def run():
        for cfg in (PALLAS, VESTA):
            split = {}
            srs.load_srs(cfg.name, IVC_ROWS, dev, split)
            _phase("ivc", f"SRS {cfg.name} 2^16 generators derived on the card: "
                          f"{_split_line(split)}")
        state = IVCState.init(_params_from_reference_fixture(), dev)
        state.verify()
        for step in range(steps):
            before = kernels.counts()
            torch.cuda.reset_peak_memory_stats(dev)
            if step == steps - 1:  # keep the last step's circuits to prove them again
                ivc.prove_pair = keep_jobs
            try:
                with phase_times() as phases:
                    t0 = time.perf_counter()
                    state = state.prove()
                    t_step = time.perf_counter() - t0
            finally:
                ivc.prove_pair = prove_pair
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            round5 = phase_by_curve(phases)
            t0 = time.perf_counter()
            state.verify()
            t_verify = time.perf_counter() - t0
            sizes = {cfg.name: len(pf.to_bytes(cfg))
                     for cfg, pf in ((PALLAS, state.fp_proof), (VESTA, state.fq_proof))}
            if sizes != {"pallas": 7107, "vesta": 7107}:
                raise AssertionError(f"step {state.i}: proof sizes {sizes}, wanted 7107 each")
            held = ""
            if state.i == 1 and all(f.exists() for f in gold.values()):
                for cfg, pf in ((PALLAS, state.fp_proof), (VESTA, state.fq_proof)):
                    if pf.to_bytes(cfg) != gold[cfg.name].read_bytes():
                        raise AssertionError(f"step 1 {cfg.name} proof differs from {gold[cfg.name].name}")
                held = "; both equal to tests/fixtures/ivc_step1_*.bin byte for byte"
            t = state.timings
            _phase("ivc", f"step {state.i - 1}->{state.i}: {t_step:.3f} s (trace {t['trace']:.3f} s, "
                          f"prove {t['prove']:.3f} s {mode}: pallas {t['prove_pallas']:.3f} s, "
                          f"vesta {t['prove_vesta']:.3f} s; verify in prove {t['verify']:.3f} s; "
                          f"round5.open+accumulate pallas {round5['pallas'][0]:.3f} s, vesta "
                          f"{round5['vesta'][0]:.3f} s); "
                          f"state.verify() {t_verify:.3f} s; proofs {sizes['pallas']} + "
                          f"{sizes['vesta']} bytes{held}; peak device memory {peak:.2f} GiB; "
                          f"{card}")
            after = kernels.counts()
            _phase("ivc", f"step {state.i} kernel launches: "
                          f"{json.dumps({k: after[k] - before[k] for k in after})}")
        return state

    prove_pair, last_jobs = ivc.prove_pair, []

    def keep_jobs(jobs, *args, **kwargs):
        last_jobs[:] = jobs
        return prove_pair(jobs, *args, **kwargs)

    concurrent = ivc.at_once(Mesh((dev,)))
    mode = "(the provers at once)" if concurrent else "(one prover after the other)"
    state, launches = _counted("ivc", run)
    if [cfg for cfg, *_ in last_jobs] != [PALLAS, VESTA]:
        raise AssertionError("the last IVC step proved no Pallas and Vesta circuits")
    if launches["ec_smul"] != 2:
        raise AssertionError(f"two SRS derivations launched ec_smul {launches['ec_smul']} times")
    _phase("ivc", f"kernel launches, SRS + {steps} steps: {json.dumps(launches)}")

    # the last step's circuits proved again, the other way; with two or
    # more cards, on all of them (each prover on cards of its own)
    cards = data_mesh() if torch.cuda.device_count() >= 2 else Mesh((dev,))
    torch.cuda.reset_peak_memory_stats(dev)
    again, t_again = ivc.prove_pair(last_jobs, cards, sequential=concurrent)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for (cfg, circuit, x, _), mine, theirs in zip(last_jobs, again,
                                                 (state.fp_proof, state.fq_proof)):
        raw = mine.to_bytes(cfg)
        if raw != theirs.to_bytes(cfg) or len(raw) != 7107:
            raise AssertionError(f"step {state.i} {cfg.name}: the re-prove's {len(raw)} bytes "
                                 f"differ from the step's proof")
        protocol.verify(cfg, mine, circuit, x, dev)
    t = state.timings
    _phase("ivc", f"step {state.i}'s circuits proved again "
                  f"{'one after the other' if concurrent else 'at once'} on {len(cards)} "
                  f"card(s): the same 7107 + 7107 "
                  f"bytes, both verified; prove {t_again['prove']:.3f} s (pallas "
                  f"{t_again['prove_pallas']:.3f} s, vesta {t_again['prove_vesta']:.3f} s), peak "
                  f"device memory {peak:.2f} GiB; the step {mode}: prove {t['prove']:.3f} s; {card}")
    return launches, state, last_jobs


def _mesh_path(dev, state, jobs, card: str, seed: int) -> dict:
    """The parallel layer on a mesh: two logical shards of this card, or
    every card when there are two or more.  The 4-step NTT (forward at
    (8, 16n), inverse at (8, 8n), the transposed layout) against ntt.ntt,
    the sharded commitment of an (8, 3, n) stack against
    msm2_srs_rows_multi, then the counted run: the last IVC step's Pallas
    circuit (n = 2^16 rows) proved on a mesh Engine, its bytes equal to
    the step's single-device proof.  On one card the shards' exchanges are
    copies within the card: no traffic between cards is measured."""
    import torch

    from halo_tpu_torch import measure
    from halo_tpu_torch.curves import PALLAS
    from halo_tpu_torch.ops import ff, kernels, msm2, ntt
    from halo_tpu_torch.parallel import msm as pmsm
    from halo_tpu_torch.parallel import ntt as pntt
    from halo_tpu_torch.parallel.mesh import Mesh, data_mesh, gather
    from halo_tpu_torch.plonk import protocol

    mesh = data_mesh() if torch.cuda.device_count() >= 2 else Mesh((dev, dev))
    one_card = len(set(mesh.devices)) == 1
    what = (f"{len(mesh)} shards on one card (no traffic between cards)" if one_card
            else f"{len(mesh)} cards")
    rng = random.Random(seed)
    m, n = PALLAS.r, IVC_ROWS

    def rows(k, *shape):
        return ff.to_rows([rng.randrange(m) for _ in range(k)], dev).reshape(8, *shape)

    def timed(fn):
        # a graph replays one card's launches; across cards, the trace's sum
        return measure.device_ms(fn, 3) if one_card else measure.traced_device_ms(fn, 3)

    for label, x, inverse, natural in (("forward", rows(16 * n, 16 * n), False, True),
                                       ("inverse", rows(8 * n, 8 * n), True, True),
                                       ("forward, transposed", rows(16 * n, 16 * n), False, False)):
        want = ntt.ntt(m, x, inverse)
        if not natural:
            d = len(mesh)
            want = want.reshape(8, -1, d).transpose(1, 2).reshape(want.shape)
        before = kernels.counts()
        got = gather(pntt.ntt_distributed(m, mesh, x, inverse, natural), dev)
        after = kernels.counts()
        if not got.equal(want):
            raise AssertionError(f"mesh: the 4-step {label} NTT at {tuple(x.shape)} differs from ntt.ntt")
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ms = timed(lambda: pntt.ntt_distributed(m, mesh, x, inverse, natural))
        single_ms = measure.device_ms(lambda: ntt.ntt(m, x, inverse), 3)
        _phase("mesh", f"4-step NTT, {label}, {tuple(x.shape)} over {what}: equal to ntt.ntt word "
                       f"for word; launches {json.dumps(launches)}; {ms:.4f} ms device "
                       f"(ntt.ntt {single_ms:.4f} ms); {card}")

    K = ff.to_rows([rng.randrange(PALLAS.r) for _ in range(3 * n)], dev).reshape(8, 3, n)
    t0 = time.perf_counter()
    single = msm2.msm2_srs_rows_multi(PALLAS, K)
    t_single_msm = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = pmsm.msm2_srs_rows_sharded(PALLAS, mesh, K)
    t_sharded = time.perf_counter() - t0
    if sharded != single:
        raise AssertionError("mesh: the sharded commitment differs from msm2_srs_rows_multi")
    _phase("mesh", f"sharded commitment of an (8, 3, {n}) stack over {what}: equal to "
                   f"msm2_srs_rows_multi's points; {t_sharded:.3f} s (single device "
                   f"{t_single_msm:.3f} s); {card}")

    cfg, circuit, x, w = jobs[0]
    if cfg is not PALLAS:
        raise AssertionError(f"the IVC step's first proof is on {cfg.name}")

    def run():
        t0 = time.perf_counter()
        proof = protocol.naive_prover(cfg, circuit, x, w, dev, mesh=mesh)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    (proof, t_mesh), launches = _counted("mesh", run)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    raw = proof.to_bytes(cfg)
    if raw != state.fp_proof.to_bytes(cfg):
        raise AssertionError("mesh: the 2^16 Pallas proof differs from the single-device proof")
    protocol.verify(cfg, proof, circuit, x, dev)
    _phase("mesh", f"the IVC step's {circuit.rows}-row Pallas circuit proved on a mesh Engine over "
                   f"{what}: {len(raw)} bytes equal to the single-device proof, verified; prove "
                   f"{t_mesh:.3f} s (the step's single-device prover: "
                   f"{state.timings['prove_pallas']:.3f} s); peak device memory {peak:.2f} GiB; {card}")
    _phase("mesh", f"kernel launches: {json.dumps(launches)}")
    return launches


def _poseidon_vs_plain(dev, seed: int) -> dict:
    """poseidon_permute against its plain version at the Schnorr batch's
    shape, (3, 8, 8192), on both fields; timed there (Pallas base field)
    and at POSEIDON_WIDE states, a width that fills the card."""
    import torch

    from halo_tpu_torch import measure
    from halo_tpu_torch.curves import PALLAS
    from halo_tpu_torch.fields import FP_MOD, FQ_MOD
    from halo_tpu_torch.ops import ff, poseidon

    rng = random.Random(seed)
    out = {}
    for m in (FQ_MOD, FP_MOD):
        vals = [0, 0, 0, m - 1, m - 1, m - 1] + [rng.randrange(m) for _ in range(3 * POSEIDON_WIDE - 6)]
        st = ff.to_rows(vals, dev).reshape(8, -1, 3).permute(2, 0, 1).contiguous()
        st_n = st[:, :, :SCHNORR_N].contiguous()
        got, want = poseidon.permute_batch(m, st_n), poseidon.poseidon_permute_plain(m, st_n)
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"poseidon_permute and plain differ (max_abs_err {err})")
        if max(ff.from_rows(got.permute(1, 0, 2).reshape(8, -1)[:, ::97])) >= m:
            raise AssertionError("poseidon_permute: output not canonical")
        # widths whose last warp is partly filled (ten states a warp)
        for width in POSEIDON_ODD:
            part = st[:, :, :width].contiguous()
            if not poseidon.permute_batch(m, part).equal(poseidon.poseidon_permute_plain(m, part)):
                raise AssertionError(f"poseidon_permute and plain differ at {width} states")
        if m != PALLAS.p:
            continue
        bound_ms, bound_by = measure.bound(*measure.work("poseidon_permute", SCHNORR_N))
        wide_bound, _ = measure.bound(*measure.work("poseidon_permute", st.shape[2]))
        out["poseidon_permute"] = {
            "max_abs_err": err,
            "ms": measure.host_paced_ms(lambda: poseidon.permute_batch(m, st_n), 20),
            "plain_ms": measure.host_paced_ms(lambda: poseidon.poseidon_permute_plain(m, st_n), 1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": measure.device_ms(lambda: poseidon.permute_batch(m, st_n), 20),
            "shape": list(got.shape),
            "wide": {"shape": list(st.shape), "bound_ms": wide_bound,
                     "device_ms": measure.device_ms(lambda: poseidon.permute_batch(m, st), 5)}}
    r = out["poseidon_permute"]
    _phase("schnorr", f"poseidon_permute equal to plain at (3, 8, {SCHNORR_N}) and at "
                      f"{POSEIDON_ODD} states on both fields; "
                      f"pallas base field: kernel {r['ms']:.4f} ms host-paced ({r['device_ms']:.4f} "
                      f"ms device), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}); at (3, 8, {r['wide']['shape'][2]}): "
                      f"{r['wide']['device_ms']:.4f} ms device, bound "
                      f"{r['wide']['bound_ms']:.4f} ms")
    return out


def _check_schnorr_table(cfg, pk, dev) -> list[int]:
    """The verifier's device table for (cfg, pk) against host ec_mul at a
    few columns: [w*256 + j] = (j+1) 2^(8w) G, the same from TABLE for pk,
    and the last -OFF (G + pk), OFF = sum_w 2^(8w); returns the columns."""
    from halo_tpu_torch.curves import ec_add, ec_mul
    from halo_tpu_torch.fields import R256
    from halo_tpu_torch.ops import ff, schnorr_batch

    T, p = schnorr_batch.TABLE, cfg.p
    cols = [0, 1, 255, 256, T - 1, T, T + 257, 2 * T - 1, schnorr_batch.CORRECTION]
    table = schnorr_batch.tables(cfg, pk, dev)
    rinv = pow(R256, -1, p)
    xs, ys = (ff.from_rows(table[rows, cols]) for rows in (slice(0, 8), slice(8, 16)))
    off = int.from_bytes(b"\x01" * schnorr_batch.WINDOWS, "little")
    for c, x, y in zip(cols, xs, ys):
        if c == schnorr_batch.CORRECTION:
            q = ec_mul(cfg, ec_add(cfg, cfg.generator, pk), off)
            want = (q[0], (p - q[1]) % p)
        else:
            w, j = divmod(c % T, 256)
            want = ec_mul(cfg, cfg.generator if c < T else pk, (j + 1) << (8 * w))
        if (x * rinv % p, y * rinv % p) != want:
            raise AssertionError(f"the verifier's table differs from host ec_mul at column {c}")
    return cols


def _verify_split(dev, cfg, pk, msgs, sigs):
    """verify_batch's stages (ops/schnorr_batch.py) run in turn with the
    card synchronised between them: (seconds of pack, hash, scan and
    compare, and the total; the scan's table, idx and neg)."""
    from halo_tpu_torch import device as devmod
    from halo_tpu_torch.ops import mont, schnorr_batch

    marks = [time.perf_counter()]

    def mark():
        devmod.sync(dev)
        marks.append(time.perf_counter())

    V, S, R_xy, table = schnorr_batch.pack_batch(cfg, pk, msgs, sigs, dev)
    mark()
    e = schnorr_batch.challenge_rows(cfg, V)
    mark()
    idx, neg = schnorr_batch.scan_indices(cfg, S, e)
    acc = mont.ec_pmadd_scan(cfg.p, table, idx, neg)[:, :, -1]
    mark()
    if not all(schnorr_batch.compare(cfg, R_xy, acc)):
        raise AssertionError("verify_batch's stages, run in turn, rejected a signature")
    mark()
    split = {k: b - a for k, a, b in zip(("pack", "hash", "scan", "compare"), marks, marks[1:])}
    split["total"] = marks[-1] - marks[0]
    return split, (table, idx, neg)


def _schnorr_kernels_vs_plain(dev, cfg, ks, scan_in) -> dict:
    """ec_smul and ec_pmadd_scan against their plain versions at the
    Schnorr path's own shapes and inputs, timed there: sign_batch's nonces
    times the broadcast generator (8192 lanes: four threads a lane), and
    verify_batch's scan (65 steps x 8192 lanes over the 16,385-point
    table, no negations)."""
    from halo_tpu_torch import measure
    from halo_tpu_torch.ops import ecrows, ff, mont

    p, n = cfg.p, len(ks)
    g = ecrows.pack_points(p, [cfg.generator[0]], [cfg.generator[1]], dev)
    k = ff.to_rows(ks, dev)
    table, idx, neg = scan_in
    out = {}
    for name, call, plain, work in (
            ("ec_smul", lambda: mont.ec_smul(p, g, k), lambda: mont.ec_smul_plain(p, g, k),
             measure.work("ec_smul", n, bcast=True)),
            ("ec_pmadd_scan", lambda: mont.ec_pmadd_scan(p, table, idx, neg),
             lambda: mont.ec_pmadd_scan_plain(p, table, idx, neg),
             measure.work("ec_pmadd_scan", R=idx.shape[0], F=idx.shape[1],
                          npts=table.shape[1]))):
        got, want = call(), plain()
        if got.shape != want.shape or not got.equal(want):
            raise AssertionError(f"{name} at the schnorr path's shape: kernel and plain differ")
        bound_ms, bound_by = measure.bound(*work)
        out[name] = {"max_abs_err": 0, "ms": measure.host_paced_ms(call, 5),
                     "device_ms": measure.device_ms(call, 5),
                     "plain_ms": measure.host_paced_ms(plain, 1), "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "shape": list(got.shape)}
        r = out[name]
        _phase("schnorr", f"{name} ({cfg.name}) equal to plain at {tuple(got.shape)}; kernel "
                          f"{r['ms']:.4f} ms host-paced ({r['device_ms']:.4f} ms device), plain "
                          f"{r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return out


def _schnorr_path(dev, seed: int) -> tuple[dict, dict]:
    """The counted Schnorr run (sign_batch and verify_batch at 8192 on
    Pallas), then warm timings, ec_smul and ec_pmadd_scan against their
    plain versions at the run's shapes, and the tampering controls.
    Returns (the counted run's launches, the kernels held and timed)."""
    import statistics

    from halo_tpu_torch import device as devmod
    from halo_tpu_torch import schnorr
    from halo_tpu_torch.curves import PALLAS, VESTA, ec_mul
    from halo_tpu_torch.ops import kernels

    cfg, n = PALLAS, SCHNORR_N
    rng = random.Random(seed)
    sk, pk = schnorr.generate_keypair(cfg, rng)
    msgs = [[rng.randrange(cfg.p) for _ in range(SCHNORR_MSG)] for _ in range(n)]
    nonces = random.Random()
    nonces.setstate(rng.getstate())  # sign_batch draws its nonces from here

    def run():
        t0 = time.perf_counter()
        sigs = schnorr.sign_batch(cfg, sk, msgs, dev, rng=rng)
        devmod.sync(dev)
        t_sign = time.perf_counter() - t0
        after_sign = kernels.counts()
        t0 = time.perf_counter()
        ok = schnorr.verify_batch(cfg, pk, msgs, sigs, dev)
        t_verify = time.perf_counter() - t0
        after = kernels.counts()
        return sigs, ok, t_sign, t_verify, after_sign, {k: after[k] - after_sign[k] for k in after}

    (sigs, ok, t_sign, t_verify, on_sign, on_verify), launches = _counted("schnorr", run)
    want = {"sign": {"ec_smul": 1, "poseidon_permute": 8, "ec_pmadd_scan": 0},
            "verify": {"ec_smul": 0, "poseidon_permute": 8, "ec_pmadd_scan": 1}}
    for what, counts in (("sign", on_sign), ("verify", on_verify)):
        got = {k: counts[k] for k in want[what]}
        if got != want[what]:
            raise AssertionError(f"{what}_batch launched {got}, wanted {want[what]}")
    if not all(ok):
        raise AssertionError(f"{ok.count(False)} of {n} fresh signatures failed verify_batch")
    lanes = [0, n - 1] + sorted(random.Random(seed).sample(range(1, n - 1), 6))
    for i in lanes:
        if not schnorr.verify(cfg, pk, msgs[i], sigs[i]):
            raise AssertionError(f"lane {i}: the batch's signature fails host verify")
    cols = _check_schnorr_table(cfg, pk, dev)
    _phase("schnorr", f"pallas, {n} signatures of {SCHNORR_MSG}-field messages: sign_batch "
                      f"{t_sign:.3f} s, verify_batch {t_verify:.3f} s (first call, with the "
                      f"host tables); all verified; lanes {lanes} verified on the host too; "
                      f"the card's table equal to host ec_mul at columns {cols}; "
                      f"launches: sign {json.dumps(on_sign)}, verify {json.dumps(on_verify)}")

    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        if not all(schnorr.verify_batch(cfg, pk, msgs, sigs, dev)):
            raise AssertionError("a warm verify_batch call rejected a signature")
        walls.append(time.perf_counter() - t0)
    rates = sorted(n / w for w in walls)
    splits = [_verify_split(dev, cfg, pk, msgs, sigs) for _ in range(3)]
    med = {k: statistics.median(s[k] for s, _ in splits) for k in splits[0][0]}
    _phase("schnorr", f"verify_batch warm, {n} signatures, 7 calls: median "
                      f"{statistics.median(rates):.1f} sig/s (min {rates[0]:.1f}, max "
                      f"{rates[-1]:.1f}); walls {[round(w, 4) for w in walls]} s; split (median "
                      f"of 3 synchronised calls): "
                      + ", ".join(f"{k} {v:.4f} s" for k, v in med.items()))

    ks = [nonces.randrange(1, cfg.r) for _ in range(n)]
    if [sig.r for sig in sigs[:4]] != [ec_mul(cfg, cfg.generator, k) for k in ks[:4]]:
        raise AssertionError("the nonces redrawn from the seed are not sign_batch's")
    held = _schnorr_kernels_vs_plain(dev, cfg, ks, splits[-1][1])

    bad = list(sigs)
    bad[0] = schnorr.SchnorrSignature(r=bad[0].r, s=(bad[0].s + 1) % cfg.r)
    got = schnorr.verify_batch(cfg, pk, msgs, bad, dev)
    if got[0] or not all(got[1:]):
        raise AssertionError("flipped s of lane 0: not exactly lane 0 failed")
    bad = list(sigs)
    bad_msgs = list(msgs)
    bad[1] = schnorr.SchnorrSignature(r=bad[1].r, s=(bad[1].s + 1) % cfg.r)
    bad_msgs[3] = [(msgs[3][0] + 1) % cfg.p] + msgs[3][1:]
    bad[4] = schnorr.SchnorrSignature(r=bad[0].r, s=bad[4].s)
    got = schnorr.verify_batch(cfg, pk, bad_msgs, bad, dev)
    if [i for i, v in enumerate(got) if not v] != [1, 3, 4]:
        raise AssertionError("tampered lanes 1, 3, 4: other lanes failed or they passed")

    vcfg, vn = VESTA, SCHNORR_VESTA_N
    vsk, vpk = schnorr.generate_keypair(vcfg, rng)
    vmsgs = [[rng.randrange(vcfg.p) for _ in range(SCHNORR_MSG)] for _ in range(vn)]
    vsigs = schnorr.sign_batch(vcfg, vsk, vmsgs, dev, rng=rng)
    for i in (0, vn - 1):
        if not schnorr.verify(vcfg, vpk, vmsgs[i], vsigs[i]):
            raise AssertionError(f"vesta lane {i}: the batch's signature fails host verify")
    vsigs[5] = schnorr.SchnorrSignature(r=vsigs[5].r, s=(vsigs[5].s + 1) % vcfg.r)
    got = schnorr.verify_batch(vcfg, vpk, vmsgs, vsigs, dev)
    if [i for i, v in enumerate(got) if not v] != [5]:
        raise AssertionError("vesta: not exactly the tampered lane 5 failed")
    _phase("schnorr", "controls: s of lane 0 flipped -> lane 0 alone fails; s of lane 1, the "
                      "message of lane 3, R of lane 4 -> those alone fail; vesta, "
                      f"{vn} signatures, s of lane 5 flipped -> lane 5 alone fails")
    _phase("schnorr", f"kernel launches, sign + verify: {json.dumps(launches)}")
    return launches, held


def _hiding_path(dev, seed: int, card: str) -> dict:
    """Hiding IPA commitments at the IVC's width, n = 2^16, on Pallas, over
    the SRS the ivc phase derived.  The counted run: Instance.open with a
    blinding factor (its RoundTimer split: host draws, pack, blinding,
    rounds), pcdl.check, the instance's bytes read back unchanged, and two
    hiding instances and a non-hiding one accumulated (acc.prover,
    verifier, decider).  Then, uncounted: w' + 1, another C_bar and v + 1
    rejected; chunked_commit of HIDING_CHUNKED coefficients with and
    without w against commit; at 2^8 on both curves the card's hiding
    proof bytes against the CPU's (the plain versions), same seed.
    Returns the counted run's launches."""
    import dataclasses

    import torch

    from halo_tpu_torch import acc, pcdl
    from halo_tpu_torch.curves import PALLAS, VESTA, ec_add
    from halo_tpu_torch.errors import PcdlCheckError
    from halo_tpu_torch.profile_ivc import phase_times

    cfg, n = PALLAS, IVC_ROWS
    d = n - 1
    rng = random.Random(seed)
    polys = [[rng.randrange(cfg.r) for _ in range(n)] for _ in range(3)]
    zs = [rng.randrange(cfg.r) for _ in range(3)]
    ws = [rng.randrange(cfg.r) for _ in range(2)]

    def run():
        t = {}
        with phase_times() as phases:
            t0 = time.perf_counter()
            q0 = pcdl.Instance.open(cfg, polys[0], d, zs[0], dev, w=ws[0], rng=rng)
            t["open"] = time.perf_counter() - t0
        t.update((name.split(".", 1)[1], sec) for _, name, sec in phases
                 if name.startswith("hiding."))
        t0 = time.perf_counter()
        pcdl.check(cfg, q0.C, d, q0.z, q0.v, q0.pi, dev)
        t["check"] = time.perf_counter() - t0
        raw = q0.to_bytes(cfg)
        if pcdl.Instance.from_bytes(raw, cfg).to_bytes(cfg) != raw:
            raise AssertionError("hiding: the instance's bytes changed through from_bytes")
        qs = [q0, pcdl.Instance.open(cfg, polys[1], d, zs[1], dev, w=ws[1], rng=rng),
              pcdl.Instance.open(cfg, polys[2], d, zs[2], dev)]
        t0 = time.perf_counter()
        accumulator = acc.prover(cfg, qs, dev)
        t1 = time.perf_counter()
        acc.verifier(cfg, qs, accumulator)
        t2 = time.perf_counter()
        acc.decider(cfg, accumulator, dev)
        t.update(prover=t1 - t0, verifier=t2 - t1, decider=time.perf_counter() - t2)
        return q0, raw, t

    torch.cuda.reset_peak_memory_stats(dev)
    (q0, raw, t), launches = _counted("hiding", run)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if q0.pi.C_bar is None or q0.pi.w_prime is None:
        raise AssertionError("hiding: the blinded open made a proof without C_bar and w'")
    _phase("hiding", f"pallas, n = 2^{IVC_LOG_ROWS}: Instance.open with a blinding factor "
                     f"{t['open']:.3f} s (host draws of q and w_bar {t['draws']:.3f} s, q to the "
                     f"card {t['pack']:.3f} s, blinding: p_bar, C_bar, p' {t['blind']:.3f} s, "
                     f"IPA rounds {t['rounds']:.3f} s); pcdl.check {t['check']:.3f} s; "
                     f"{len(raw)} bytes read back unchanged; two hiding instances and a "
                     f"non-hiding one accumulated: prover {t['prover']:.3f} s, verifier "
                     f"{t['verifier']:.3f} s, decider {t['decider']:.3f} s; peak device memory "
                     f"{peak:.2f} GiB; {card}")
    _phase("hiding", f"kernel launches: {json.dumps(launches)}")

    pi, v = q0.pi, q0.v
    for label, bad, v_bad in (("w' + 1", dataclasses.replace(pi, w_prime=(pi.w_prime + 1) % cfg.r), v),
                              ("another C_bar", dataclasses.replace(pi, C_bar=cfg.generator), v),
                              ("v + 1", pi, (v + 1) % cfg.r)):
        try:
            pcdl.check(cfg, q0.C, d, q0.z, v_bad, bad, dev)
        except PcdlCheckError:
            continue
        raise AssertionError(f"hiding: a proof with {label} passed pcdl.check")

    coeffs = [rng.randrange(cfg.r) for _ in range(HIDING_CHUNKED)]
    t0 = time.perf_counter()
    plain = pcdl.chunked_commit(cfg, coeffs, d, dev, chunk_size=HIDING_CHUNK)
    t_chunked = time.perf_counter() - t0
    blinded = pcdl.chunked_commit(cfg, coeffs, d, dev, w=ws[0], chunk_size=HIDING_CHUNK)
    chunks = [coeffs[i:i + HIDING_CHUNK] for i in range(0, len(coeffs), HIDING_CHUNK)]
    if len(plain) != len(chunks) or plain != [pcdl.commit(cfg, c, d, dev) for c in chunks]:
        raise AssertionError("hiding: chunked_commit's chunks differ from commit of each chunk")
    if blinded != [pcdl.blind(cfg, C, ws[0]) for C in plain]:
        raise AssertionError("hiding: chunked_commit with w is not each chunk + w*S")
    total = None
    for C in plain:
        total = ec_add(cfg, total, C)
    summed = [sum(c[i] for c in chunks if i < len(c)) % cfg.r for i in range(HIDING_CHUNK)]
    if total != pcdl.commit(cfg, summed, d, dev):
        raise AssertionError("hiding: the chunks' sum differs from commit of the chunks' sum")

    m = HIDING_CPU_ROWS
    for c in (PALLAS, VESTA):
        r2 = random.Random(seed + m)
        p = [r2.randrange(c.r) for _ in range(m - 3)]
        z, w = r2.randrange(c.r), r2.randrange(c.r)
        on = [pcdl.Instance.open(c, p, m - 1, z, where, w=w, rng=random.Random(seed))
              for where in (dev, torch.device("cpu"))]
        if on[0].to_bytes(c) != on[1].to_bytes(c):
            raise AssertionError(f"hiding: the card's 2^8 {c.name} hiding proof differs from the CPU's")
        pcdl.check(c, on[0].C, m - 1, z, on[0].v, on[0].pi, dev)
    _phase("hiding", f"rejected by pcdl.check: w' + 1, another C_bar, v + 1; chunked_commit of "
                     f"{HIDING_CHUNKED} coefficients: {len(plain)} chunks ({t_chunked:.3f} s), "
                     f"each equal to commit of its coefficients, + w*S with w, their sum equal "
                     f"to commit of the chunks' sum; 2^8 hiding proofs on the card equal to the "
                     f"CPU's byte for byte, pallas and vesta")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-rows", type=int, default=14)
    ap.add_argument("--ivc-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if not 7 <= args.log_rows <= 16:
        ap.error("--log-rows must be in [7, 16]")
    if args.ivc_steps < 1:
        ap.error("--ivc-steps must be at least 1")

    if not (ROOT / "halo_tpu_torch" / "csrc" / "kernels.cu").exists():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import torch

    from halo_tpu_torch import device as devmod
    from halo_tpu_torch import srs
    from halo_tpu_torch.curves import PALLAS, VESTA
    from halo_tpu_torch.ops import kernels
    from halo_tpu_torch.plonk import protocol, trace
    from halo_tpu_torch.plonk.circuit import TRACE_CURVE

    # 1. device
    dev = devmod.cuda()
    card = devmod.card_line()
    _phase("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    kernels.build()
    regs, local = kernels.registers(), kernels.local_bytes()
    _phase("build", f"nvcc build + load {kernels.BUILD_SECONDS:.2f} s ({kernels.library_path().name}); "
                    f"registers per thread: {json.dumps(regs)}; local (spill) bytes per thread: "
                    f"{json.dumps(local)}")

    # 3. the PLONK path's SRS, derived on the card
    n_srs = 1 << args.log_rows
    split = {}
    _, srs_launches = _counted("srs", lambda: srs.load_srs(PALLAS.name, n_srs, dev, split))
    if srs_launches["ec_smul"] != 1:
        raise AssertionError(f"the SRS derivation launched ec_smul {srs_launches['ec_smul']} times")
    checked_at = _check_srs(srs.load_srs(PALLAS.name, n_srs, dev), args.seed)
    _phase("srs", f"pallas, 2^{args.log_rows} generators derived on the card: "
                  f"{_split_line(split)}; kernel launches: {json.dumps(srs_launches)}; S, H "
                  f"and generators {checked_at[:3]} ... {checked_at[-1]} ({len(checked_at)}) "
                  f"equal to host ec_mul")

    # 4. kernels vs plain at the srs and plonk paths' shapes
    checked = {"srs+plonk": _kernels_vs_plain(dev, PALLAS, args.log_rows, args.seed)}

    # 5. golden bytes
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

    # 6. and 7. the counted paths
    by_path = {"srs": srs_launches, "plonk": _plonk_path(dev, args.log_rows, args.seed)}
    by_path["ivc"], state, jobs = _ivc_path(dev, args.ivc_steps, card)

    # 8. the parallel layer: the 4-step NTT, the sharded commitment and the
    # IVC step's Pallas circuit proved on a mesh
    by_path["mesh"] = _mesh_path(dev, state, jobs, card, args.seed)
    del state, jobs

    # 9. kernels vs plain at the IVC path's shapes, on both curves (after
    # the path: the 2^16 SRS it derives inside its counted run is at hand)
    _phase("kernels", f"at the IVC path's shapes (2^{IVC_LOG_ROWS} rows)")
    for cfg in (VESTA, PALLAS):
        checked[f"ivc {cfg.name}"] = _kernels_vs_plain(dev, cfg, IVC_LOG_ROWS, args.seed)

    # 10. the Schnorr batch
    checked["schnorr pallas"] = _poseidon_vs_plain(dev, args.seed)
    by_path["schnorr"], held = _schnorr_path(dev, args.seed)
    checked["schnorr pallas"].update(held)

    # 11. hiding commitments at the IVC's width, over the ivc phase's SRS
    by_path["hiding"] = _hiding_path(dev, args.seed, card)

    loaded = sorted(k for k, v in sys.modules.items()
                    if v is not None and k.split(".")[0] in ("jax", "jaxlib", "halo_tpu"))
    if loaded:
        raise AssertionError(f"the run imported jax or halo_tpu: {loaded[:5]}")

    def per_instance(table, name):
        return table[name] if name in table else \
            {k.split()[1]: v for k, v in table.items() if k.split()[0] == name}

    def measured(name):
        return checked["ivc pallas"].get(name) or checked["schnorr pallas"][name]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "halo_tpu_torch/csrc/kernels.cu",
         "replaces": REPLACES[name], **({"replaces_also": REPLACES_ALSO[name]}
                                        if name in REPLACES_ALSO else {}),
         **({"replaces_kind": "XLA fusion"} if name in XLA_FUSIONS else {}),
         "launches": by_path[LAUNCHES_FROM.get(name, "ivc")][name],
         "launches_path": LAUNCHES_FROM.get(name, "ivc"),
         "launches_by_path": {path: c[name] for path, c in by_path.items()},
         "registers": per_instance(regs, name), "local_bytes": per_instance(local, name),
         **measured(name),
         "shapes_checked": {path: c[name]["shape"] for path, c in checked.items() if name in c}}
        for name in kernels.NAMES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
