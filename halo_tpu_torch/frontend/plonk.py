"""In-circuit PLONK verifier (port of halo_tpu/frontend/plonk.py; reference
frontend/plonk/mod.rs).

Reuses the dual-use constraint evaluators of the port's plonk.protocol via a
WireOps adapter, so the in-circuit f_gc is the same code path as the native
verifier — mirroring the reference's *_generic sharing.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import CurveCfg
from ..plonk import protocol
from ..plonk.constants import Q_POLYS, R_POLYS, S_POLYS, T_POLYS, W_POLYS
from ..plonk.trace import PlonkCircuit
from ..poseidon.sponge import Protocols
from .asdl import WireAccumulator, bind_accumulator
from .pcdl import WireEvalProof, WireInstance, WirePublicParams, bind_eval_proof
from .primitives import WireAffine, WireBool, WireScalar
from .sponge import OuterSponge


class WireOps:
    """protocol.gate_constraints ops-adapter over wires."""

    # no common-subexpression reuse: the reference's in-circuit constraint
    # expressions re-evaluate sboxes per use, and bit-exact circuit
    # commitments require reproducing that exact gate stream
    cse = False

    def __init__(self, cfg: CurveCfg):
        self.cfg = cfg

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def mul(self, a, b):
        return a * b

    def smul(self, a, s):
        # s is a WireScalar here (the circuit carries MDS constants as wires,
        # mirroring WirePlonkCircuit.mds in the reference)
        return a * s

    @property
    def one(self):
        return WireScalar.one(self.cfg)


@dataclass
class WirePlonkCircuitCommitments:
    qs: list[WireAffine]
    rs: list[WireAffine]
    ids: list[WireAffine]
    sigmas: list[WireAffine]


def _mds_wires(cfg: CurveCfg) -> list:
    consts = protocol._scalar_mds(cfg)
    return [[WireScalar.constant(cfg, consts[i][j]) for j in range(3)] for i in range(3)]


@dataclass
class WirePlonkCircuit:
    n: WireScalar
    rows: int
    mds: list
    public_input_count: int
    omega: WireScalar
    Cs: WirePlonkCircuitCommitments

    @staticmethod
    def constant(cfg: CurveCfg, circuit: PlonkCircuit) -> "WirePlonkCircuit":
        Cs = WirePlonkCircuitCommitments(
            qs=[WireAffine.constant(cfg, p) for p in circuit.Cs.qs],
            rs=[WireAffine.constant(cfg, p) for p in circuit.Cs.rs],
            ids=[WireAffine.constant(cfg, p) for p in circuit.Cs.ids],
            sigmas=[WireAffine.constant(cfg, p) for p in circuit.Cs.sigmas],
        )
        return WirePlonkCircuit(
            n=WireScalar.constant(cfg, circuit.rows),
            rows=circuit.rows,
            mds=_mds_wires(cfg),
            public_input_count=circuit.public_input_count,
            omega=WireScalar.constant(cfg, circuit.omega),
            Cs=Cs,
        )

    @staticmethod
    def public_input(cfg: CurveCfg, rows: int, public_input_count: int) -> "WirePlonkCircuit":
        from ..hostpoly import domain_element

        Cs = WirePlonkCircuitCommitments(
            qs=[WireAffine.public_input(cfg) for _ in range(Q_POLYS)],
            rs=[WireAffine.public_input(cfg) for _ in range(R_POLYS)],
            ids=[WireAffine.public_input(cfg) for _ in range(S_POLYS)],
            sigmas=[WireAffine.public_input(cfg) for _ in range(S_POLYS)],
        )
        return WirePlonkCircuit(
            n=WireScalar.constant(cfg, rows),
            rows=rows,
            mds=_mds_wires(cfg),
            public_input_count=public_input_count,
            omega=WireScalar.constant(cfg, domain_element(cfg.r, rows, 1)),
            Cs=Cs,
        )


@dataclass
class WirePlonkPublicInputs:
    public_inputs: list[WireScalar]
    acc_prev: WireAccumulator

    @staticmethod
    def witness(cfg: CurveCfg, rows: int, public_input_count: int) -> "WirePlonkPublicInputs":
        return WirePlonkPublicInputs(
            public_inputs=[WireScalar.witness(cfg) for _ in range(public_input_count)],
            acc_prev=WireAccumulator.witness(cfg, rows),
        )


@dataclass
class WirePlonkProofEvals:
    ws: list[WireScalar]
    rs: list[WireScalar]
    qs: list[WireScalar]
    ts: list[WireScalar]
    ids: list[WireScalar]
    sigmas: list[WireScalar]
    z: WireScalar
    z_omega: WireScalar
    w_omegas: list[WireScalar]


@dataclass
class WirePlonkProofCommitments:
    ws: list[WireAffine]
    ts: list[WireAffine]
    z: WireAffine


@dataclass
class WirePlonkProofEvalProofs:
    r: WireEvalProof
    r_omega: WireEvalProof


@dataclass
class WirePlonkProof:
    vs: WirePlonkProofEvals
    Cs: WirePlonkProofCommitments
    pis: WirePlonkProofEvalProofs
    acc_next: WireAccumulator

    @staticmethod
    def witness(cfg: CurveCfg, n: int) -> "WirePlonkProof":
        ws = WireScalar.witness
        wa = WireAffine.witness
        return WirePlonkProof(
            vs=WirePlonkProofEvals(
                ws=[ws(cfg) for _ in range(W_POLYS)],
                rs=[ws(cfg) for _ in range(R_POLYS)],
                qs=[ws(cfg) for _ in range(Q_POLYS)],
                ts=[ws(cfg) for _ in range(T_POLYS)],
                ids=[ws(cfg) for _ in range(S_POLYS)],
                sigmas=[ws(cfg) for _ in range(S_POLYS)],
                z=ws(cfg),
                z_omega=ws(cfg),
                w_omegas=[ws(cfg) for _ in range(3)],
            ),
            Cs=WirePlonkProofCommitments(
                ws=[wa(cfg) for _ in range(W_POLYS)],
                ts=[wa(cfg) for _ in range(T_POLYS)],
                z=wa(cfg),
            ),
            pis=WirePlonkProofEvalProofs(
                r=WireEvalProof.witness(cfg, n),
                r_omega=WireEvalProof.witness(cfg, n),
            ),
            acc_next=WireAccumulator.witness(cfg, n),
        )

    def verify_succinct(
        self, circuit: WirePlonkCircuit, public_inputs: WirePlonkPublicInputs
    ) -> WireBool:
        cfg = self.vs.z.cfg
        pi = self
        n = circuit.n
        one = WireScalar.one(cfg)
        transcript = OuterSponge(Protocols.PLONK, cfg)

        assert len(public_inputs.public_inputs) <= circuit.public_input_count

        transcript.absorb_g(pi.Cs.ws)
        beta = transcript.challenge()
        gamma = transcript.challenge()
        transcript.absorb_g([pi.Cs.z])
        alpha = transcript.challenge()
        transcript.absorb_g(pi.Cs.ts)
        zeta = transcript.challenge()
        xi = transcript.challenge()

        xi_n = xi
        for _ in range(circuit.rows.bit_length() - 1):
            xi_n = xi_n.square()
        xi_omega = xi * circuit.omega

        f_prime = pi.vs.ws[0] + beta * pi.vs.ids[0] + gamma
        g_prime = pi.vs.ws[0] + beta * pi.vs.sigmas[0] + gamma
        for i in range(1, S_POLYS):
            f_prime = f_prime * (pi.vs.ws[i] + beta * pi.vs.ids[i] + gamma)
            g_prime = g_prime * (pi.vs.ws[i] + beta * pi.vs.sigmas[i] + gamma)

        o = WireOps(cfg)

        def pi_term():
            # PI(xi) via in-circuit Lagrange evaluation; deferred so its
            # wires are created LAST in f_gc, as in the reference
            # (public_input_eval_generic called inline as f_gc's final term,
            # frontend/plonk/mod.rs:529, protocol.rs:564-589)
            omega_j = circuit.omega
            total = WireScalar.zero(cfg)
            for x in public_inputs.public_inputs:
                l_j = ((xi_n - one) * omega_j) / (n * (xi - omega_j))
                total = total + l_j * (-x)
                omega_j = omega_j * circuit.omega
            return total

        f_gc = protocol.gate_constraints(
            o, pi.vs.qs, pi.vs.ws, pi.vs.rs, pi.vs.w_omegas, pi_term, circuit.mds
        )

        omega = circuit.omega
        l1 = (omega * (xi_n - one)) / (n * (xi - omega))
        z_H = xi_n - one
        f_cc1 = l1 * (pi.vs.z - one)
        f_cc2 = pi.vs.z * f_prime - pi.vs.z_omega * g_prime

        f = f_gc + alpha * f_cc1 + (alpha * alpha) * f_cc2

        t = pi.vs.ts[0]
        accp = xi_n
        for i in range(1, T_POLYS):
            t = t + accp * pi.vs.ts[i]
            accp = accp * xi_n

        f_eq_t_zh = f.equals(t * z_H)

        def geo_scalars(items):
            result = items[0]
            accum = zeta
            for it in items[1:]:
                result = result + it * accum
                accum = accum * zeta
            return result

        def geo_points(items):
            result = items[0]
            accum = zeta
            for it in items[1:]:
                result = result + it * accum
                accum = accum * zeta
            return result

        v_r = geo_scalars(list(pi.vs.qs) + list(pi.vs.ws) + list(pi.vs.ts) + [pi.vs.z])
        v_r_omega = geo_scalars(list(pi.vs.w_omegas) + [pi.vs.z_omega])
        C_r = geo_points(list(circuit.Cs.qs) + list(pi.Cs.ws) + list(pi.Cs.ts) + [pi.Cs.z])
        C_r_omega = geo_points(list(pi.Cs.ws[0:3]) + [pi.Cs.z])

        instance_1 = WireInstance(C=C_r, z=xi, v=v_r, pi=pi.pis.r)
        instance_2 = WireInstance(C=C_r_omega, z=xi_omega, v=v_r_omega, pi=pi.pis.r_omega)

        pp = WirePublicParams.new(cfg, circuit.rows)
        qs = [public_inputs.acc_prev.instance, instance_1, instance_2]
        acc_ok = pi.acc_next.verify(pp, qs)

        return f_eq_t_zh & acc_ok


# ---------------- binding helpers ---------------- #


def bind_plonk_proof(call, wp: WirePlonkProof, proof, as_public: bool = False) -> None:
    f = call.public_input if as_public else call.witness
    fa = call.public_input_affine if as_public else call.witness_affine
    f(wp.vs.z, proof.vs.z)
    f(wp.vs.z_omega, proof.vs.z_omega)
    for pairs in (
        (wp.vs.ws, proof.vs.ws),
        (wp.vs.rs, proof.vs.rs),
        (wp.vs.qs, proof.vs.qs),
        (wp.vs.ts, proof.vs.ts),
        (wp.vs.ids, proof.vs.ids),
        (wp.vs.sigmas, proof.vs.sigmas),
        (wp.vs.w_omegas, proof.vs.w_omegas),
    ):
        for w, v in zip(*pairs):
            f(w, v)
    fa(wp.Cs.z, proof.Cs.z)
    for w, v in zip(wp.Cs.ws, proof.Cs.ws):
        fa(w, v)
    for w, v in zip(wp.Cs.ts, proof.Cs.ts):
        fa(w, v)
    bind_eval_proof(call, wp.pis.r, proof.pis.r, as_public)
    bind_eval_proof(call, wp.pis.r_omega, proof.pis.r_omega, as_public)
    bind_accumulator(call, wp.acc_next, proof.acc_next, as_public)


def bind_plonk_public_inputs(call, wpi: WirePlonkPublicInputs, x, as_public: bool = False):
    f = call.public_input if as_public else call.witness
    assert len(x.public_inputs) <= len(wpi.public_inputs)
    for i, w in enumerate(wpi.public_inputs):
        f(w, x.public_inputs[i] if i < len(x.public_inputs) else 0)
    bind_accumulator(call, wpi.acc_prev, x.acc_prev, as_public)
