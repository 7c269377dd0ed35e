"""The port's prover slice on the CPU: engine ops against host ints, the
single and the pair IPA open against halo_tpu.pcdl, hiding commitments,
opens and accumulation against halo_tpu.pcdl and halo_tpu.acc, the golden proof
fixtures (whose round 5 runs the pair open) byte for byte, the same
fixtures read back by the port's PlonkProof.from_bytes (equal to
halo_tpu's parse, re-serialized byte for byte, verified; malformed bytes
raise), sqrt and decompress_point against halo_tpu's,
and a 2^8-row Poseidon-chain proof byte-equal to halo_tpu's host prover
built from the same TraceBuilder, whose device mirrors equal halo_tpu's
through convert.py; the same witness proved again on a 4-shard CPU mesh
(the engine's NTTs and commitments sharded) gives the same bytes.

Tolerance: zero.  Everything is exact; proofs are compared as bytes.
"""

import dataclasses
import os
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from halo_tpu import acc as hacc
from halo_tpu import pcdl as hpcdl
from halo_tpu.curves import PALLAS, VESTA
from halo_tpu.curves import decompress_point as h_decompress_point
from halo_tpu.errors import PcdlCheckError as HPcdlCheckError
from halo_tpu.fields import sqrt as h_sqrt
from halo_tpu.hostpoly import divide_by_vanishing, poly_eval
from halo_tpu.ops import ff as jff
from halo_tpu.plonk import protocol as hprotocol
from halo_tpu.plonk import trace as htrace
from halo_tpu.plonk.circuit import TRACE_CURVE
from halo_tpu.serde import Writer
from halo_tpu_torch import acc, convert, measure, pcdl
from halo_tpu_torch.curves import decompress_point
from halo_tpu_torch.errors import PcdlCheckError, SerdeError
from halo_tpu_torch.fields import sqrt
from halo_tpu_torch.ops import ipa
from halo_tpu_torch.parallel.mesh import Mesh
from halo_tpu_torch.plonk import protocol, trace
from halo_tpu_torch.plonk.engine import Engine

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FIXDIR = Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def _to_bytes(obj, cfg):
    """halo_tpu's Writer over either package's EvalProof, Instance or
    Accumulator."""
    w = Writer()
    obj.serialize(w, cfg)
    return w.data()


# ---------------- engine ---------------- #


def _check_engine_ops_vs_host_ints(cfg):
    m = cfg.r
    eng = Engine(cfg, CPU)
    rng = random.Random(1)
    n = 64
    a = [rng.randrange(1, m) for _ in range(n)]
    a[5] = 0
    dev = eng.to_dev(a)
    assert eng.to_ints(dev) == a

    # batch inverse (inv(0) = 0) and the grand product z[i] = prod_{1..i}
    assert eng.to_ints(eng.batch_inv(dev)) == [pow(x, -1, m) if x else 0 for x in a]
    z = [1]
    for x in a[1:]:
        z.append(z[-1] * x % m)
    assert eng.to_ints(eng.grand_product(dev)) == z

    # quotient by X^n - 1, batched evaluation, powers, scale
    f = [rng.randrange(m) for _ in range(4 * n)]
    q = eng.divide_by_vanishing(eng.to_dev(f), n)
    assert eng.to_ints(q) == divide_by_vanishing(m, f, n)
    x = rng.randrange(m)
    polys = [[rng.randrange(m) for _ in range(n)] for _ in range(3)]
    assert eng.eval_batch(eng.to_dev_batch(polys), x) == [poly_eval(m, p, x) for p in polys]
    xs = [x, rng.randrange(m), 0]  # one point per polynomial, one pull
    assert eng.eval_batch(eng.to_dev_batch(polys), xs) == [
        poly_eval(m, p, xi) for p, xi in zip(polys, xs)]
    assert eng.to_ints(eng.powers(x, 4)) == [1, x, x * x % m, x * x * x % m]
    # scale takes its constant in Montgomery form from the host, once per
    # value; consts sends a batch in one copy
    assert eng.to_ints(eng.scale(dev, x)) == [v * x % m for v in a]
    assert eng.to_ints(eng.scale(dev, x + m)) == [v * x % m for v in a]
    assert eng.const(x) is eng.const(x + m)
    ks = eng.consts([x, 1, m - 1])
    assert ks.shape == (3, 8, 1) and all(k.is_contiguous() for k in ks)
    assert [eng.to_ints(k)[0] for k in ks] == [x, 1, m - 1]

    # commitments against the host Pedersen commitment
    assert eng.commit_batch(eng.to_dev_batch(polys), n - 1) == [
        hpcdl.commit(cfg, p, n - 1) for p in polys]


# ---------------- IPA ---------------- #


def _ipa_case(cfg, n, seed):
    """A polynomial shorter than n (zero padded), its commitment, a point,
    the value there, and halo_tpu.pcdl's host open of it."""
    rng = random.Random(seed)
    p = [rng.randrange(cfg.r) for _ in range(n - 3)]
    z = rng.randrange(cfg.r)
    C = hpcdl.commit(cfg, p, n - 1)
    v = hpcdl.poly_eval(cfg, p, z)
    return p, C, z, v, hpcdl.open_without_eval(cfg, p, C, n - 1, z, v)


def _check_ipa_opens_match_host_bytes():
    """The single open (a host list) and the pair open (a host list and a
    tensor, in lockstep) against halo_tpu.pcdl's host opens, byte for
    byte; every proof passes pcdl.check."""
    cfg = PALLAS
    n = 256
    p0, C0, z0, v0, want0 = _ipa_case(cfg, n, 7)
    p1, C1, z1, v1, want1 = _ipa_case(cfg, n, 8)
    got = ipa.open_without_eval_device(cfg, p0, C0, n - 1, z0, v0, CPU)
    assert _to_bytes(got, cfg) == _to_bytes(want0, cfg)
    pair = ipa.open_pair_without_eval_device(
        cfg, [(p0, C0, z0, v0), (Engine(cfg, CPU).to_dev(p1), C1, z1, v1)], n - 1, CPU)
    for got, want, (C, z, v) in zip(pair, (want0, want1), ((C0, z0, v0), (C1, z1, v1))):
        assert _to_bytes(got, cfg) == _to_bytes(want, cfg)
        pcdl.check(cfg, C, n - 1, z, v, got, CPU)
    with pytest.raises(ValueError):
        ipa.open_pair_without_eval_device(cfg, [(p0, C0, z0, v0)], n - 1, CPU)


def _check_pcdl_hiding_matches_host():
    """Hiding commitments (an Instance's C), chunked commitments, hiding
    opens and the accumulation of hiding instances against halo_tpu's,
    with the same seeded random.Random draws: byte-equal, each package
    accepting the other's proofs, both rejecting w' + 1, another C_bar
    and v + 1; the non-hiding bad-eval rejection first."""
    cfg = VESTA
    p = [3, 1, 4, 1]
    C = pcdl.commit(cfg, p, 3, CPU)
    assert C == hpcdl.commit(cfg, p, 3)
    pi = pcdl.open_proof(cfg, p, C, 3, 9, CPU)
    v = hpcdl.poly_eval(cfg, p, 9)
    pcdl.check(cfg, C, 3, 9, v, pi, CPU)
    with pytest.raises(PcdlCheckError):
        pcdl.check(cfg, C, 3, 9, (v + 1) % cfg.r, pi, CPU)

    for cfg in (PALLAS, VESTA):
        for n in (64, 256):
            d = n - 1
            rng = random.Random(n)
            p = [rng.randrange(cfg.r) for _ in range(n - 3)]
            z, w = rng.randrange(cfg.r), rng.randrange(cfg.r)
            for coeffs in (p[:45], []):
                for blinding in (None, w):
                    assert pcdl.chunked_commit(cfg, coeffs, d, CPU, blinding, 16) == \
                        hpcdl.chunked_commit(cfg, coeffs, d, blinding, 16)

            mine = pcdl.Instance.open(cfg, p, d, z, CPU, w=w, rng=random.Random(n + 1))
            ref = hpcdl.Instance.open(cfg, p, d, z, w=w, rng=random.Random(n + 1))
            raw = _to_bytes(ref, cfg)
            assert mine.pi.C_bar is not None and mine.to_bytes(cfg) == raw
            theirs = pcdl.Instance.from_bytes(raw, cfg)
            assert theirs.to_bytes(cfg) == raw and theirs == mine
            assert pcdl.EvalProof.from_bytes(mine.pi.to_bytes(cfg), cfg) == mine.pi
            pcdl.check(cfg, theirs.C, d, z, theirs.v, theirs.pi, CPU)
            hpcdl.check(cfg, mine.C, d, z, mine.v, mine.pi)
            for tampered, v_bad in (
                    (dataclasses.replace(mine.pi, w_prime=(mine.pi.w_prime + 1) % cfg.r), mine.v),
                    (dataclasses.replace(mine.pi, C_bar=cfg.generator), mine.v),
                    (mine.pi, (mine.v + 1) % cfg.r)):
                with pytest.raises(PcdlCheckError):
                    pcdl.check(cfg, mine.C, d, z, v_bad, tampered, CPU)
                with pytest.raises(HPcdlCheckError):
                    hpcdl.check(cfg, mine.C, d, z, v_bad, tampered)
            with pytest.raises(PcdlCheckError):  # C_bar read back without w'
                pcdl.succinct_check(cfg, mine.C, d, z, mine.v,
                                    dataclasses.replace(mine.pi, w_prime=None))
            if n != 64:
                continue
            if cfg is PALLAS:  # p as Montgomery rows on the device
                rows = pcdl.open_without_eval(cfg, Engine(cfg, CPU).to_dev(p), mine.C, d, z,
                                              mine.v, CPU, w, rng=random.Random(n + 1))
                assert rows == mine.pi

            # the port's hiding instance, another and a non-hiding one, accumulated
            q = [rng.randrange(cfg.r) for _ in range(n)]
            z2 = rng.randrange(cfg.r)
            refs = [ref, hpcdl.Instance.open(cfg, q, d, z2, w=w + 1, rng=random.Random(5)),
                    hpcdl.Instance.open(cfg, q[:40], d, z)]
            qs = [mine] + [pcdl.Instance.from_bytes(_to_bytes(r, cfg), cfg) for r in refs[1:]]
            got = acc.prover(cfg, qs, CPU)
            want = hacc.prover(cfg, refs)
            assert got.to_bytes(cfg) == _to_bytes(want, cfg)
            acc.verifier(cfg, qs, got)
            hacc.verifier(cfg, refs, want)
            acc.decider(cfg, got, CPU)
            hacc.decider(cfg, want)
            qs[1] = dataclasses.replace(qs[1], v=(qs[1].v + 1) % cfg.r)
            refs[1] = dataclasses.replace(refs[1], v=(refs[1].v + 1) % cfg.r)
            with pytest.raises(PcdlCheckError):
                acc.verifier(cfg, qs, got)
            with pytest.raises(HPcdlCheckError):
                hacc.verifier(cfg, refs, want)


# ---------------- golden fixtures ---------------- #


def _check_golden_proof_bytes():
    """Returns each curve's (circuit, public inputs)."""
    traces = trace.trace_pair(chip_smoke.golden_builder(), CPU)
    out = {}
    for which, tr, cfg in zip(("pallas", "vesta"), traces, (PALLAS, VESTA)):
        circuit, x, w = tr.consume()
        proof = protocol.naive_prover(cfg, circuit, x, w, CPU)
        assert proof.to_bytes(cfg) == (FIXDIR / f"proof_{which}.bin").read_bytes(), which
        protocol.verify(cfg, proof, circuit, x, CPU)
        out[which] = circuit, x
    return out


def _check_golden_proofs_read_back(circuits):
    """Both fixtures parse with the port, equal halo_tpu's parse field for
    field, re-serialize to the same bytes and verify against the golden
    circuits; malformed bytes raise SerdeError."""
    for which, cfg in (("pallas", PALLAS), ("vesta", VESTA)):
        raw = (FIXDIR / f"proof_{which}.bin").read_bytes()
        proof = protocol.PlonkProof.from_bytes(raw, cfg)
        ref = hprotocol.PlonkProof.from_bytes(raw, cfg)
        assert dataclasses.asdict(proof) == dataclasses.asdict(ref), which
        assert proof.to_bytes(cfg) == raw, which
        circuit, x = circuits[which]
        protocol.verify(cfg, proof, circuit, x, CPU)

        # the first commitment (after the 78 evaluations) gets an x whose
        # x^3 + 5 is a non-residue, keeping its flag bits
        at = 78 * 32
        x_bad = next(v for v in range(1, 100) if h_sqrt(v ** 3 + cfg.b, cfg.p) is None)
        bad = bytearray(raw)
        bad[at:at + 32] = x_bad.to_bytes(32, "little")
        bad[at + 32] &= 0xC0
        infinity_x = bytearray(raw)
        infinity_x[at + 32] = 0x40  # infinity with the same nonzero x
        p_as_x = bytearray(raw)
        p_as_x[at:at + 33] = cfg.p.to_bytes(33, "little")
        for malformed in (raw[:-1], raw[:at + 20], raw + b"\0", bytes(bad), bytes(infinity_x),
                          bytes(p_as_x)):
            with pytest.raises(SerdeError):
                protocol.PlonkProof.from_bytes(malformed, cfg)


def _check_sqrt_and_decompress_match_halo():
    rng = random.Random(21)
    for cfg in (PALLAS, VESTA):
        for m in (cfg.p, cfg.r):
            xs = [0, 1, 5, m - 1] + [rng.randrange(m) for _ in range(8)]
            got = [sqrt(x, m) for x in xs]
            assert got == [h_sqrt(x, m) for x in xs]
            assert None in got and all(r is None or r * r % m == x for r, x in zip(got, xs))
        xs = [cfg.generator[0], 0] + [rng.randrange(cfg.p) for _ in range(8)]
        for x in xs:
            for neg in (False, True):
                try:
                    want = h_decompress_point(cfg, x, neg)
                except ValueError:
                    with pytest.raises(ValueError):
                        decompress_point(cfg, x, neg)
                    continue
                assert decompress_point(cfg, x, neg) == want
        assert decompress_point(cfg, cfg.generator[0], False) == cfg.generator


def test_engine_ipa_and_golden_proofs():
    for cfg in (PALLAS, VESTA):
        _check_engine_ops_vs_host_ints(cfg)
    _check_ipa_opens_match_host_bytes()
    _check_pcdl_hiding_matches_host()
    _check_golden_proofs_read_back(_check_golden_proof_bytes())
    _check_sqrt_and_decompress_match_halo()


# ---------------- a 2^8-row proof against the host prover ---------------- #


def _halo_mirrors(ref_trace, m):
    """halo_tpu's device mirrors of a trace: (k, n, 16) Montgomery limb
    arrays, made by halo_tpu.ops.ff, keyed as its Trace.dev_polys."""
    groups = {"qs": ref_trace.q_polys, "rs": ref_trace.r_polys, "ids": ref_trace.id_polys,
              "sigmas": ref_trace.sigma_polys, "ws": list(ref_trace.w_polys),
              "w_evals": [e.vec for e in ref_trace.w_evals]}
    flat = [v for cols in groups.values() for col in cols for v in col]
    mont = np.asarray(jff.to_mont_jit(jff.ctx_for(m), jff.ints_to_array(flat)))
    out, i = {}, 0
    for key, cols in groups.items():
        k, n = len(cols), len(cols[0])
        out[key] = mont[i:i + k * n].reshape(k, n, 16)
        i += k * n
    return out


def test_proof_2k8_matches_host_prover():
    fp_data, _ = measure.poseidon_chain(256, seed=11).trace()
    cfg = TRACE_CURVE[0]
    ref_trace = htrace.Trace.new(cfg, fp_data)
    ref_c, ref_x, ref_w = ref_trace.consume()
    want = hprotocol.naive_prover(cfg, ref_c, ref_x, ref_w, device=False).to_bytes(cfg)

    # the port's trace of the same data, with the circuit's commitments
    # given (Trace.new's own commitments are held by the golden proofs):
    # the same host polys, and device mirrors equal to halo_tpu's mirrors
    # through convert.py
    mine = trace.Trace.new(cfg, fp_data, CPU, acc_prev=ref_trace.acc_prev, circuit=ref_c)
    assert mine.rows == 256
    for got, ref in ((mine.q_polys, ref_trace.q_polys), (mine.r_polys, ref_trace.r_polys),
                     (mine.id_polys, ref_trace.id_polys),
                     (mine.sigma_polys, ref_trace.sigma_polys),
                     (mine.w_polys, ref_trace.w_polys)):
        assert list(got) == list(ref)
    mirrors = convert.dev_polys_to_rows(_halo_mirrors(ref_trace, cfg.r), CPU)
    assert mirrors.keys() == mine.dev_polys.keys()
    for key, rows in mirrors.items():
        assert mine.dev_polys[key].equal(rows), key

    circuit, x, w = mine.consume()
    proof = protocol.naive_prover(cfg, circuit, x, w, CPU)
    assert proof.to_bytes(cfg) == want
    protocol.verify(cfg, proof, circuit, x, CPU)
    # the same witness again, its NTTs (4-step) and commitments sharded
    # over four logical shards: the trace's device mirrors are read, not
    # consumed, so a second proof of it has the same bytes
    on_mesh = protocol.naive_prover(cfg, circuit, x, w, CPU, mesh=Mesh((CPU,) * 4))
    assert on_mesh.to_bytes(cfg) == want
