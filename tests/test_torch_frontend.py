"""The port's frontend and IVC driver against halo_tpu's, on the host.

Both packages build the same circuits from the same values: a small circuit
of frontend gadgets (in-circuit transcript, affine add, scalar
multiplication on both curves, Schnorr verification), and the 2^16-row IVC
step circuit of step 0 -> 1.  Their arithmetizations (TraceData: rows,
w/q/r columns, public and message-pass inputs, copy constraints, outputs)
must be equal, and the port's Trace of the small circuit must hold the
same polynomials as halo_tpu's.  IVCState.init must agree field by field.
The 2^16 provers do not run here (a 2^8 proof already costs ~25 s on the
CPU); chip_smoke.py runs the IVC steps on the card.

Tolerance: zero (ints, points and bytes are compared exactly).

One test runs every check, for the reason tests/test_torch_ecrows.py
gives (ROADMAP, "Tier-1 budget").
"""

import os
import random
from types import SimpleNamespace

import pytest
import torch

import halo_tpu.frontend as h_fe
import halo_tpu.frontend.signature as h_sig
import halo_tpu.frontend.sponge as h_sponge
import halo_tpu_torch.frontend as t_fe
import halo_tpu_torch.frontend.signature as t_sig
import halo_tpu_torch.frontend.sponge as t_sponge
from halo_tpu import acc as h_acc
from halo_tpu import curves as h_curves
from halo_tpu import schnorr as h_schnorr
from halo_tpu.frontend import ivc as h_ivc
from halo_tpu.plonk import trace as h_trace
from halo_tpu.poseidon.sponge import Protocols as HProtocols
from halo_tpu_torch import curves as t_curves
from halo_tpu_torch import schnorr as t_schnorr
from halo_tpu_torch.frontend import ivc as t_ivc
from halo_tpu_torch.plonk import trace as t_trace
from halo_tpu_torch.poseidon.sponge import Protocols as TProtocols
from halo_tpu_torch.serde import Writer

# One intra-op thread per pytest-xdist worker: the workers share the cores,
# and idle OpenMP threads spinning in each would starve the others.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

JAX = SimpleNamespace(fe=h_fe, sig=h_sig, sponge=h_sponge, curves=h_curves, Protocols=HProtocols,
                      ivc=h_ivc)
PORT = SimpleNamespace(fe=t_fe, sig=t_sig, sponge=t_sponge, curves=t_curves, Protocols=TProtocols,
                       ivc=t_ivc)


@pytest.fixture(autouse=True)
def fresh_frontends():
    h_fe.reset()
    t_fe.reset()
    yield
    h_fe.reset()
    t_fe.reset()


def _values(seed=5):
    """Host values for the gadget circuit: a Schnorr key, message and
    signature on Pallas, two Pallas points, a Vesta point and scalars."""
    rng = random.Random(seed)
    P, V = h_curves.PALLAS, h_curves.VESTA
    sk = rng.randrange(1, P.r)
    msg = [rng.randrange(P.p) for _ in range(3)]
    sig = h_schnorr.sign(P, sk, msg, k=rng.randrange(1, P.r))
    return SimpleNamespace(
        pk=h_curves.ec_mul(P, P.generator, sk), msg=msg, sig=sig,
        a=h_curves.ec_mul(P, P.generator, rng.randrange(1, P.r)),
        b=h_curves.ec_mul(P, P.generator, rng.randrange(1, P.r)),
        v=h_curves.ec_mul(V, V.generator, rng.randrange(1, V.r)),
        s=rng.randrange(V.r), t=rng.randrange(V.r))


def _gadget_builder(ns, vals):
    """The gadget circuit in package `ns`, bound to `vals`: its TraceBuilder."""
    fe, P, V = ns.fe, ns.curves.PALLAS, ns.curves.VESTA
    ns.fe.reset()
    pk = fe.WireAffine.witness(P)
    sig = ns.sig.WireSchnorrSignature.witness(P)
    msg = [fe.WireScalar.witness(V) for _ in vals.msg]  # Pallas base-field wires
    sig.verify(pk, msg).output()
    a, b = fe.WireAffine.witness(P), fe.WireAffine.witness(P)
    (a + b).output()
    v, s, t = fe.WireAffine.witness(V), fe.WireScalar.witness(V), fe.WireScalar.witness(V)
    (v * s).output()
    sponge = ns.sponge.OuterSponge(ns.Protocols.PCDL, V)
    sponge.absorb_g([v])
    sponge.absorb_fr([s, t])
    sponge.challenge().output()

    call = fe.Call()
    call.witness_affine(pk, vals.pk)
    call.witness_affine(sig.r, vals.sig.r)
    call.witness(sig.s, vals.sig.s)
    for w, x in zip(msg, vals.msg):
        call.witness(w, x)
    call.witness_affine(a, vals.a)
    call.witness_affine(b, vals.b)
    call.witness_affine(v, vals.v)
    call.witness(s, vals.s)
    call.witness(t, vals.t)
    ns.fe.reset()
    return call.trace_builder


def _check_gadget_circuit_trace():
    vals = _values()
    want = _gadget_builder(JAX, vals).trace()
    got = _gadget_builder(PORT, vals).trace()
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name in g._fields:
            assert getattr(g, name) == getattr(w, name), name
    # the Schnorr gadget accepted, and the native values came through
    assert want[1].outputs[0] == 1
    assert tuple(want[1].outputs[1:3]) == h_curves.ec_add(h_curves.PALLAS, vals.a, vals.b)


def _check_gadget_circuit_polys_and_trace_cache():
    """The port's Trace of the gadget circuit (frozen commitments, as the
    IVC step has) holds halo_tpu's interpolated polynomials; a second trace
    of the same frozen circuit takes its static rows from the cache."""
    vals = _values()
    fp_data, fq_data = _gadget_builder(PORT, vals).trace()
    for data, h_cfg in ((fp_data, h_curves.PALLAS), (fq_data, h_curves.VESTA)):
        ref = h_trace.Trace.new(h_cfg, data)
        ref_circuit, _, _ = ref.consume()
        mine = t_trace.Trace.new(t_curves.cfg_of(h_cfg.name), data, "cpu", acc_prev=ref.acc_prev,
                                 circuit=ref_circuit)
        for attr in ("q_polys", "r_polys", "id_polys", "sigma_polys", "w_polys"):
            assert list(getattr(mine, attr)) == list(getattr(ref, attr)), attr
        assert mine.public_inputs_poly == ref.public_inputs_poly
        assert mine.sigma == ref.sigma
        again = t_trace.Trace.new(t_curves.cfg_of(h_cfg.name), data, "cpu", acc_prev=ref.acc_prev,
                                  circuit=ref_circuit)
        assert again.dev_polys["qs"].data_ptr() == mine.dev_polys["qs"].data_ptr()
        assert again.dev_polys["ws"].equal(mine.dev_polys["ws"])


def _check_schnorr_sign_and_verify():
    rng = random.Random(3)
    P = t_curves.PALLAS
    sk, k = rng.randrange(1, P.r), rng.randrange(1, P.r)
    msg = [rng.randrange(P.p) for _ in range(4)]
    pk = t_curves.ec_mul(P, P.generator, sk)
    sig = t_schnorr.sign(P, sk, msg, k=k)
    ref = h_schnorr.sign(h_curves.PALLAS, sk, msg, k=k)
    assert (sig.r, sig.s) == (ref.r, ref.s)
    assert t_schnorr.verify(P, pk, msg, sig)
    assert not t_schnorr.verify(P, pk, msg, t_schnorr.SchnorrSignature(r=sig.r, s=sig.s + 1))
    assert not t_schnorr.verify(P, pk, msg[:3], sig)


def _proof_bytes(proof, cfg):
    w = Writer()
    proof.serialize(w, cfg)
    return w.data()


def _check_ivc_init(ref, mine):
    assert mine.params.rows == ref.params.rows == 65536
    for circ in ("fp_circuit", "fq_circuit"):
        a, b = getattr(mine.params, circ), getattr(ref.params, circ)
        assert (a.rows, a.public_input_count, a.omega) == (b.rows, b.public_input_count, b.omega)
        assert a.Cs.__dict__ == b.Cs.__dict__
    assert (mine.pk, mine.sk, mine.i) == (ref.pk, ref.sk, ref.i)
    assert (mine.signature.r, mine.signature.s) == (ref.signature.r, ref.signature.s)
    assert len(mine.fp_public_input.public_inputs) == 405
    assert len(mine.fq_public_input.public_inputs) == 725
    for cfg, a, b in ((t_curves.PALLAS, mine.fp_proof, ref.fp_proof),
                      (t_curves.VESTA, mine.fq_proof, ref.fq_proof)):
        assert _proof_bytes(a, cfg) == _proof_bytes(b, cfg)  # zero proof + zero accumulator
    assert mine.fp_public_input.acc_prev.q.C == h_acc.zero_accumulator(h_curves.PALLAS, 65536).q.C
    mine.verify()  # step 0 accepts without running the verifiers


def _check_ivc_step1_arithmetization(ref_state, state):
    """Step 0 -> 1's wire circuit with its witness bound, in both packages:
    equal TraceData at 2^16 rows on both curves (rows, columns, public and
    message-pass inputs, copy constraints)."""
    rng = random.Random(4242)  # IVCState.prove's default draws
    pk_next = t_curves.ec_mul(t_curves.PALLAS, t_curves.PALLAS.generator,
                              rng.randrange(1, t_curves.PALLAS.r))
    p = state.params
    got = t_ivc.ivc_step_builder(p.rows, p.fp_circuit.public_input_count,
                                 p.fq_circuit.public_input_count, state, pk_next,
                                 p.fp_circuit, p.fq_circuit).trace()

    hp = ref_state.params
    h_fe.reset()
    wires = (h_ivc.WirePlonkCircuit.public_input(h_curves.PALLAS, hp.rows,
                                                 hp.fp_circuit.public_input_count),
             h_ivc.WirePlonkCircuit.public_input(h_curves.VESTA, hp.rows,
                                                 hp.fq_circuit.public_input_count))
    wire_state = h_ivc.WireIVCState.witness(hp.rows, hp.fp_circuit.public_input_count,
                                            hp.fq_circuit.public_input_count)
    wire_pk_next = h_ivc.WireAffine.witness(h_curves.PALLAS)
    wire_state.ivc_circuit(*wires, wire_pk_next)
    call = h_fe.Call()
    h_ivc.bind_plonk_circuit(call, wires[0], hp.fp_circuit)
    h_ivc.bind_plonk_circuit(call, wires[1], hp.fq_circuit)
    call.witness_affine(wire_pk_next, pk_next)
    h_ivc.bind_ivc_state(call, wire_state, ref_state)
    want = call.trace_builder.trace()

    for g, w, pi_count in zip(got, want, (405, 725)):
        assert g.rows == w.rows == 65536
        assert len(g.public_inputs) == pi_count
        for name in w._fields:
            assert getattr(g, name) == getattr(w, name), name


def test_frontend_and_ivc_match_jax_package():
    _check_gadget_circuit_trace()
    _check_gadget_circuit_polys_and_trace_cache()
    _check_schnorr_sign_and_verify()
    ref = h_ivc.IVCState.init(h_ivc._params_from_reference_fixture())
    mine = t_ivc.IVCState.init(t_ivc._params_from_reference_fixture(), "cpu")
    _check_ivc_init(ref, mine)
    _check_ivc_step1_arithmetization(ref, mine)
