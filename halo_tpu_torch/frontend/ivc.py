"""IVC driver: a chain-of-signatures statement proven recursively over the
Pasta 2-cycle (port of halo_tpu/frontend/ivc.py; reference
crates/plonk/src/frontend/ivc/mod.rs).

The statement (thesis ch. 6): each key signs the next; step i's circuit
checks  (prev proofs verify  OR  i == 0)  AND  the signature verifies,
with the PLONK verifier, IPA succinct check and accumulation verifier all
in-circuit.  The circuit is fixed: its commitments are the reference's
hard-coded IVC_FP_CIRCUIT/IVC_FQ_CIRCUIT (ivc/mod.rs:52-165), read from
tests/fixtures/ivc_consts.json at the production size, 2^16 rows.

A step builds the wire circuit and its trace on the host (the static
q/r/id/sigma rows come from the trace cache after the first step), then
proves the Pallas and the Vesta trace and verifies both.  The two proofs
are independent (ivc/mod.rs:648-649).  halo_tpu proves them at once in
two threads on an accelerator (halo_tpu/frontend/ivc.py:292-317); the
port does so (parallel/pipeline.py run_disjoint: a thread and a CUDA
stream each) where the state's mesh gives each prover devices of its
own, and on one card proves them one after the other: there the two
threads, serialised by Python's interpreter lock, made the step slower in
one call's A/B (PERF.md §6).  HALO_TPU_IVC_SEQUENTIAL=1 proves them
in turn everywhere (halo_tpu/config.py:46-50: peak device memory is about
twice one prover's); on the CPU they run in turn.  The bytes are the same
either way.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, field

import torch

from .. import acc as acc_mod
from .. import pcdl, schnorr
from ..curves import PALLAS, VESTA, ec_mul
from ..device import sync, sync_stream
from ..parallel import pipeline
from ..parallel.mesh import Mesh
from ..plonk import protocol
from ..plonk.constants import Q_POLYS, R_POLYS, S_POLYS, T_POLYS, W_POLYS
from ..plonk.trace import PlonkCircuit, PlonkCircuitCommitments, PlonkPublicInputs, trace_pair
from . import Call, reset
from .plonk import (
    WirePlonkCircuit,
    WirePlonkProof,
    WirePlonkPublicInputs,
    bind_plonk_proof,
    bind_plonk_public_inputs,
)
from .primitives import WireAffine, WireBool, WireScalar
from .signature import WireSchnorrSignature, bind_signature


def zero_invalid_instance(cfg, n: int) -> pcdl.Instance:
    """Instance::zero_invalid (pcdl.rs:67-89): all-identity proof."""
    lg_n = n.bit_length() - 1
    pi = pcdl.EvalProof(
        Ls=[None] * lg_n, Rs=[None] * lg_n, U=None, c=0, C_bar=None, w_prime=None
    )
    return pcdl.Instance(C=None, d=n - 1, z=0, v=0, pi=pi)


@dataclass
class WireIVCState:
    pk: WireAffine
    signature: WireSchnorrSignature
    i: WireScalar
    fp_proof: WirePlonkProof
    fp_public_input: WirePlonkPublicInputs
    fq_proof: WirePlonkProof
    fq_public_input: WirePlonkPublicInputs

    @staticmethod
    def witness(rows: int, fp_pi_count: int, fq_pi_count: int) -> "WireIVCState":
        return WireIVCState(
            fp_proof=WirePlonkProof.witness(PALLAS, rows),
            fq_proof=WirePlonkProof.witness(VESTA, rows),
            fp_public_input=WirePlonkPublicInputs.witness(PALLAS, rows, fp_pi_count),
            fq_public_input=WirePlonkPublicInputs.witness(VESTA, rows, fq_pi_count),
            i=WireScalar.witness(PALLAS),
            signature=WireSchnorrSignature.witness(PALLAS),
            pk=WireAffine.witness(PALLAS),
        )

    def ivc_circuit(
        self,
        circuit_fp: WirePlonkCircuit,
        circuit_fq: WirePlonkCircuit,
        pk_next: WireAffine,
    ) -> WireBool:
        """(fp verifies AND fq verifies) OR i == 0, AND signature verifies
        (ivc/mod.rs:728-749)."""
        c1_fp = self.fp_proof.verify_succinct(circuit_fp, self.fp_public_input)
        c1_fq = self.fq_proof.verify_succinct(circuit_fq, self.fq_public_input).message_pass()
        c1 = c1_fp & c1_fq
        c2 = self.i.equals(WireScalar.zero(PALLAS))
        c3 = self.signature.verify(self.pk, [pk_next.x, pk_next.y]).message_pass()
        return (c1 | c2) & c3


def bind_ivc_state(call: Call, wire_state: WireIVCState, state: "IVCState") -> None:
    bind_plonk_proof(call, wire_state.fp_proof, state.fp_proof)
    bind_plonk_proof(call, wire_state.fq_proof, state.fq_proof)
    bind_plonk_public_inputs(call, wire_state.fp_public_input, state.fp_public_input)
    bind_plonk_public_inputs(call, wire_state.fq_public_input, state.fq_public_input)
    call.witness(wire_state.i, state.i)
    bind_signature(call, wire_state.signature, state.signature)
    call.witness_affine(wire_state.pk, state.pk)


def bind_plonk_circuit(call: Call, wc: WirePlonkCircuit, circuit: PlonkCircuit) -> None:
    """public_input_plonk_circuit (frontend/plonk/mod.rs:238-270)."""
    assert wc.rows == circuit.rows
    for w, p in zip(wc.Cs.qs, circuit.Cs.qs):
        call.public_input_affine(w, p)
    for w, p in zip(wc.Cs.rs, circuit.Cs.rs):
        call.public_input_affine(w, p)
    for i in range(S_POLYS):
        call.public_input_affine(wc.Cs.ids[i], circuit.Cs.ids[i])
        call.public_input_affine(wc.Cs.sigmas[i], circuit.Cs.sigmas[i])


@dataclass
class IVCParams:
    rows: int
    fp_circuit: PlonkCircuit
    fq_circuit: PlonkCircuit


def ivc_step_builder(rows: int, fp_pi_count: int, fq_pi_count: int, state: "IVCState",
                     pk_next_pt, fp_circuit: PlonkCircuit, fq_circuit: PlonkCircuit):
    """Construct the IVC wire circuit and bind one step's witness: the
    step's TraceBuilder (halo_tpu/frontend/ivc.py build_ivc_traces, up to
    the trace)."""
    reset()
    wire_fp_circuit = WirePlonkCircuit.public_input(PALLAS, rows, fp_pi_count)
    wire_fq_circuit = WirePlonkCircuit.public_input(VESTA, rows, fq_pi_count)
    wire_state = WireIVCState.witness(rows, fp_pi_count, fq_pi_count)
    wire_pk_next = WireAffine.witness(PALLAS)
    wire_state.ivc_circuit(wire_fp_circuit, wire_fq_circuit, wire_pk_next)

    call = Call()
    bind_plonk_circuit(call, wire_fp_circuit, fp_circuit)
    bind_plonk_circuit(call, wire_fq_circuit, fq_circuit)
    call.witness_affine(wire_pk_next, pk_next_pt)
    bind_ivc_state(call, wire_state, state)
    reset()
    return call.trace_builder


@dataclass
class IVCState:
    params: IVCParams
    pk: tuple
    sk: int
    signature: schnorr.SchnorrSignature
    i: int
    fp_proof: protocol.PlonkProof
    fp_public_input: PlonkPublicInputs
    fq_proof: protocol.PlonkProof
    fq_public_input: PlonkPublicInputs
    device: torch.device
    # wall seconds of the step that made this state: "trace" (wire circuit,
    # witness and both traces), "prove_pallas" and "prove_vesta" (each
    # prover's own wall), "prove" (both provers), "verify"
    timings: dict = field(default_factory=dict)
    # the devices the provers run on (prove_pair); None: `device` alone
    mesh: Mesh | None = None

    @staticmethod
    def init(params: IVCParams, device, rng=None, mesh: Mesh | None = None) -> "IVCState":
        rng = rng or random.Random(1337)
        device = torch.device(device)
        rows = params.rows
        acc0_pallas = acc_mod.zero_accumulator(PALLAS, rows, device)
        acc0_vesta = acc_mod.zero_accumulator(VESTA, rows, device)

        sk_init = rng.randrange(1, PALLAS.r)
        sk = rng.randrange(1, PALLAS.r)
        pk = ec_mul(PALLAS, PALLAS.generator, sk)
        # reference init signs (pk.y, pk.x), kept as it is (ivc/mod.rs:402)
        signature = schnorr.sign(PALLAS, sk_init, [pk[1], pk[0]], k=rng.randrange(1, PALLAS.r))

        def zero_proof(cfg, acc0):
            return protocol.PlonkProof(
                vs=protocol.PlonkProofEvals(
                    ws=[0] * W_POLYS, rs=[0] * R_POLYS, qs=[0] * Q_POLYS, ts=[0] * T_POLYS,
                    ids=[0] * S_POLYS, sigmas=[0] * S_POLYS, z=0, z_omega=0, w_omegas=[0] * 3),
                Cs=protocol.PlonkProofCommitments(ws=[None] * W_POLYS, ts=[None] * T_POLYS,
                                                  z=None),
                pis=protocol.PlonkProofEvalProofs(r=zero_invalid_instance(cfg, rows).pi,
                                                  r_omega=zero_invalid_instance(cfg, rows).pi),
                acc_next=acc0,
            )

        return IVCState(
            params=params, pk=pk, sk=sk, signature=signature, i=0,
            fp_proof=zero_proof(PALLAS, acc0_pallas),
            fp_public_input=PlonkPublicInputs(
                public_inputs=[0] * params.fp_circuit.public_input_count, acc_prev=acc0_pallas),
            fq_proof=zero_proof(VESTA, acc0_vesta),
            fq_public_input=PlonkPublicInputs(
                public_inputs=[0] * params.fq_circuit.public_input_count, acc_prev=acc0_vesta),
            device=device, mesh=mesh,
        )

    def prove(self, rng=None) -> "IVCState":
        rng = rng or random.Random(4242)
        params = self.params
        dev = self.device
        times = {}
        t0 = time.perf_counter()
        sk_next = rng.randrange(1, PALLAS.r)
        pk_next = ec_mul(PALLAS, PALLAS.generator, sk_next)
        signature_next = schnorr.sign(
            PALLAS, self.sk, [pk_next[0], pk_next[1]], k=rng.randrange(1, PALLAS.r))

        builder = ivc_step_builder(
            params.rows, params.fp_circuit.public_input_count,
            params.fq_circuit.public_input_count, self, pk_next,
            params.fp_circuit, params.fq_circuit)
        fp_trace, fq_trace = trace_pair(
            builder, dev, accs_prev=(self.fp_public_input.acc_prev, self.fq_public_input.acc_prev),
            static_circuits=(params.fp_circuit, params.fq_circuit))
        fp_circuit, fp_x, fp_w = fp_trace.consume()
        fq_circuit, fq_x, fq_w = fq_trace.consume()
        sync(dev)
        times["trace"] = time.perf_counter() - t0

        jobs = ((PALLAS, fp_circuit, fp_x, fp_w), (VESTA, fq_circuit, fq_x, fq_w))
        proofs, prove_times = prove_pair(jobs, self.mesh or Mesh((dev,)))
        times.update(prove_times)
        t0 = time.perf_counter()
        protocol.verify(PALLAS, proofs[0], fp_circuit, fp_x, dev)
        protocol.verify(VESTA, proofs[1], fq_circuit, fq_x, dev)
        times["verify"] = time.perf_counter() - t0

        return IVCState(
            params=params, pk=pk_next, sk=sk_next, signature=signature_next, i=self.i + 1,
            fp_proof=proofs[0], fp_public_input=fp_x, fq_proof=proofs[1], fq_public_input=fq_x,
            device=dev, timings=times, mesh=self.mesh,
        )

    def verify(self) -> None:
        if self.i == 0:
            return
        protocol.verify(PALLAS, self.fp_proof, self.params.fp_circuit, self.fp_public_input,
                        self.device)
        protocol.verify(VESTA, self.fq_proof, self.params.fq_circuit, self.fq_public_input,
                        self.device)


def at_once(mesh: Mesh, k: int = 2) -> bool:
    """Whether k provers on `mesh` run at once by default: never under
    HALO_TPU_IVC_SEQUENTIAL=1 (read at each step, as halo_tpu/config.py:49-50
    reads it), else only where split_mesh gives each prover devices of its
    own."""
    if os.environ.get("HALO_TPU_IVC_SEQUENTIAL") == "1":
        return False
    subs = pipeline.split_mesh(mesh, k)
    return len({d for sub in subs for d in sub.devices}) == sum(len(sub) for sub in subs)


def prove_pair(jobs, mesh: Mesh, sequential: bool | None = None) -> tuple[list, dict]:
    """Prove each (cfg, circuit, public inputs, witness) of `jobs`, prover
    i on sub-mesh i of pipeline.split_mesh(mesh, len(jobs)) (its NTTs and
    commitments sharded when the sub-mesh has several devices): at once
    through pipeline.run_disjoint on CUDA devices unless `sequential`
    (default: not at_once(mesh)), else one after the other.  Returns the
    proofs and the wall seconds: "prove_<curve>" of each prover (its
    thread's own, ending when its stream is done), "prove" of all."""
    if sequential is None:
        sequential = not at_once(mesh, len(jobs))
    times = {}

    def task(cfg, circuit, x, w):
        def prove(sub):
            t0 = time.perf_counter()
            proof = protocol.naive_prover(cfg, circuit, x, w, sub.devices[0],
                                          sub if len(sub) > 1 else None)
            sync_stream(sub.devices[0])
            times[f"prove_{cfg.name}"] = time.perf_counter() - t0
            return proof
        return prove

    tasks = [task(*job) for job in jobs]
    t0 = time.perf_counter()
    if sequential or mesh.devices[0].type != "cuda":
        proofs = [t(sub) for t, sub in zip(tasks, pipeline.split_mesh(mesh, len(tasks)))]
    else:
        proofs = pipeline.run_disjoint(mesh, tasks)
    times["prove"] = time.perf_counter() - t0
    return proofs, times


def _dec_pt(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _params_from_reference_fixture() -> IVCParams:
    """The reference's frozen IVC_FP_CIRCUIT/IVC_FQ_CIRCUIT (ivc/mod.rs:
    52-165) at 2^16 rows, from tests/fixtures/ivc_consts.json (which
    halo_tpu's freeze_ivc_circuits(65536) reproduces bit for bit)."""
    data = json.loads(acc_mod.IVC_CONSTS.read_text())

    def dec(c):
        return PlonkCircuit(
            rows=c["rows"], public_input_count=c["public_input_count"], omega=int(c["omega"]),
            Cs=PlonkCircuitCommitments(
                qs=[_dec_pt(p) for p in c["qs"]], rs=[_dec_pt(p) for p in c["rs"]],
                ids=[_dec_pt(p) for p in c["ids"]], sigmas=[_dec_pt(p) for p in c["sigmas"]]),
        )

    return IVCParams(rows=data["fp_circuit"]["rows"], fp_circuit=dec(data["fp_circuit"]),
                     fq_circuit=dec(data["fq_circuit"]))
