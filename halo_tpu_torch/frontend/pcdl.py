"""In-circuit IPA succinct check (port of halo_tpu/frontend/pcdl.py;
reference frontend/pcdl/mod.rs).

Non-hiding only (like the reference: C' = C); returns a WireBool instead of
erroring.  The lg(n) fold rounds re-derive the xi challenges through the
in-circuit transcript and accumulate C_i via scalar-mul + add gates.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import CurveCfg
from ..poseidon.sponge import Protocols
from ..srs import load_sh
from .primitives import WireAffine, WireBool, WireScalar
from .sponge import OuterSponge


@dataclass
class WireHPoly:
    xis: list[WireScalar]

    def eval(self, z: WireScalar) -> WireScalar:
        lg_n = len(self.xis) - 1
        one = WireScalar.one(z.cfg)
        v = one + self.xis[lg_n] * z
        z_i = z
        for i in range(1, lg_n):
            z_i = z_i.square()
            v = v * (one + self.xis[lg_n - i] * z_i)
        return v


@dataclass
class WireEvalProof:
    Ls: list[WireAffine]
    Rs: list[WireAffine]
    U: WireAffine
    c: WireScalar

    @staticmethod
    def _make(cfg: CurveCfg, n: int, mk_affine, mk_scalar) -> "WireEvalProof":
        # creation order matters for node indices: the reference interleaves
        # L_i, R_i per round (pcdl/mod.rs:127-136), then U, then c
        lg_n = n.bit_length() - 1
        Ls, Rs = [], []
        for _ in range(lg_n):
            Ls.append(mk_affine(cfg))
            Rs.append(mk_affine(cfg))
        return WireEvalProof(Ls=Ls, Rs=Rs, U=mk_affine(cfg), c=mk_scalar(cfg))

    @staticmethod
    def witness(cfg: CurveCfg, n: int) -> "WireEvalProof":
        return WireEvalProof._make(cfg, n, WireAffine.witness, WireScalar.witness)

    @staticmethod
    def public_input(cfg: CurveCfg, n: int) -> "WireEvalProof":
        return WireEvalProof._make(cfg, n, WireAffine.public_input, WireScalar.public_input)


@dataclass
class WirePublicParams:
    H: WireAffine
    d: int
    lg_n: int

    @staticmethod
    def new(cfg: CurveCfg, n: int) -> "WirePublicParams":
        assert n & (n - 1) == 0
        _, H = load_sh(cfg.name)
        return WirePublicParams(
            H=WireAffine.constant(cfg, H), d=n - 1, lg_n=n.bit_length() - 1
        )


@dataclass
class WireInstance:
    C: WireAffine
    z: WireScalar
    v: WireScalar
    pi: WireEvalProof

    @staticmethod
    def witness(cfg: CurveCfg, n: int) -> "WireInstance":
        return WireInstance(
            C=WireAffine.witness(cfg),
            z=WireScalar.witness(cfg),
            v=WireScalar.witness(cfg),
            pi=WireEvalProof.witness(cfg, n),
        )

    @staticmethod
    def public_input(cfg: CurveCfg, n: int) -> "WireInstance":
        return WireInstance(
            C=WireAffine.public_input(cfg),
            z=WireScalar.public_input(cfg),
            v=WireScalar.public_input(cfg),
            pi=WireEvalProof.public_input(cfg, n),
        )

    def succinct_check(self, pp: WirePublicParams):
        """-> (WireBool over the base field, WireHPoly, U) (pcdl/mod.rs:200-252)."""
        cfg = self.z.cfg
        transcript = OuterSponge(Protocols.PCDL, cfg)
        C_prime = self.C

        transcript.absorb_g([C_prime])
        transcript.absorb_fr([self.z, self.v])
        xi_0 = transcript.challenge()
        xis = [xi_0]
        H_prime = pp.H * xi_0
        C_i = C_prime + H_prime * self.v

        for i in range(pp.lg_n):
            transcript.absorb_fr([xis[i]])
            transcript.absorb_g([self.pi.Ls[i], self.pi.Rs[i]])
            xi_next = transcript.challenge()
            xis.append(xi_next)
            # gate-order parity: Rust's `C_i += L*xi^-1 + R*xi` adds the two
            # terms together FIRST, then into C_i (pcdl/mod.rs:238)
            C_i = C_i + (self.pi.Ls[i] * xi_next.inv() + self.pi.Rs[i] * xi_next)

        h = WireHPoly(xis)
        v_prime = self.pi.c * h.eval(self.z)
        b = C_i.equals(self.pi.U * self.pi.c + H_prime * v_prime)
        return b, h, self.pi.U


# ---------------- binding helpers ---------------- #


def bind_instance(call, wire_inst: WireInstance, inst, as_public: bool = False) -> None:
    bind_eval_proof(call, wire_inst.pi, inst.pi, as_public)
    f_affine = call.public_input_affine if as_public else call.witness_affine
    f_scalar = call.public_input if as_public else call.witness
    f_affine(wire_inst.C, inst.C)
    f_scalar(wire_inst.z, inst.z)
    f_scalar(wire_inst.v, inst.v)


def bind_eval_proof(call, wire_pi: WireEvalProof, pi, as_public: bool = False) -> None:
    assert len(wire_pi.Ls) == len(pi.Ls)
    f_affine = call.public_input_affine if as_public else call.witness_affine
    f_scalar = call.public_input if as_public else call.witness
    for wl, wr, l, r in zip(wire_pi.Ls, wire_pi.Rs, pi.Ls, pi.Rs):
        f_affine(wl, l)
        f_affine(wr, r)
    f_affine(wire_pi.U, pi.U)
    f_scalar(wire_pi.c, pi.c)
