"""In-circuit accumulation verifier (port of halo_tpu/frontend/asdl.py;
reference frontend/asdl/mod.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import CurveCfg
from ..poseidon.sponge import Protocols
from .pcdl import WireHPoly, WireInstance, WirePublicParams, bind_instance
from .primitives import WireAffine, WireBool, WireScalar
from .sponge import OuterSponge


def point_dot(alphas: list[WireScalar], ps: list[WireAffine]) -> WireAffine:
    """Repeated scalar-mul + add (asdl/mod.rs:13-22)."""
    assert len(alphas) == len(ps) and alphas
    result = ps[0] * alphas[0]
    for a, p in zip(alphas[1:], ps[1:]):
        result = result + p * a
    return result


@dataclass
class WireAccumulatedHPolys:
    hs: list[WireHPoly]
    alpha: WireScalar | None
    alphas: list[WireScalar]
    capacity: int

    @staticmethod
    def with_capacity(n: int) -> "WireAccumulatedHPolys":
        return WireAccumulatedHPolys(hs=[], alpha=None, alphas=[], capacity=n)

    def set_alpha(self, alpha: WireScalar) -> None:
        self.alphas = alpha.geometric_series(self.capacity)
        self.alpha = alpha

    def eval(self, z: WireScalar) -> WireScalar:
        v = WireScalar.zero(z.cfg)
        for h, a in zip(self.hs, self.alphas):
            v = v + h.eval(z) * a
        return v

    def get_scalars(self) -> list[WireScalar]:
        out = [xi for h in self.hs for xi in h.xis]
        if self.alpha is not None:
            out.append(self.alpha)
        return out


@dataclass
class WireAccumulator:
    instance: WireInstance

    @staticmethod
    def witness(cfg: CurveCfg, n: int) -> "WireAccumulator":
        return WireAccumulator(instance=WireInstance.witness(cfg, n))

    @staticmethod
    def public_input(cfg: CurveCfg, n: int) -> "WireAccumulator":
        return WireAccumulator(instance=WireInstance.public_input(cfg, n))

    @staticmethod
    def common_subroutine(pp: WirePublicParams, qs: list[WireInstance]):
        """-> (ok base-field bool, C, z, hs) (asdl/mod.rs:113-166)."""
        cfg = qs[0].z.cfg
        transcript = OuterSponge(Protocols.ASDL, cfg)
        hs = WireAccumulatedHPolys.with_capacity(len(qs))
        Us = []
        from .primitives import _other

        res = WireBool.true_(_other(cfg))  # base-field bool
        for q in qs:
            b, h_i, U_i = q.succinct_check(pp)
            hs.hs.append(h_i)
            Us.append(U_i)
            res = res & b

        transcript.absorb_fr(hs.get_scalars())
        transcript.absorb_g(Us)
        alpha = transcript.challenge()
        hs.set_alpha(alpha)

        C = point_dot(hs.alphas, Us)
        z = transcript.challenge()
        return res, C, z, hs

    def verify(self, pp: WirePublicParams, qs: list[WireInstance]) -> WireBool:
        """-> WireBool over the SCALAR field (asdl/mod.rs:168-180)."""
        inst = self.instance
        ok, C_prime, z_prime, hs = self.common_subroutine(pp, qs)
        is_C_eq = C_prime.equals(inst.C)
        is_z_eq = z_prime.equals(inst.z)
        is_h_eq = hs.eval(inst.z).equals(inst.v)
        return (ok & is_C_eq).message_pass() & is_z_eq & is_h_eq


def bind_accumulator(call, wire_acc: WireAccumulator, acc, as_public: bool = False) -> None:
    bind_instance(call, wire_acc.instance, acc.q, as_public)
