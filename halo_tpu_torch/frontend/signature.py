"""In-circuit Schnorr verification (port of halo_tpu/frontend/signature.py;
reference frontend/signature/mod.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import CurveCfg
from ..poseidon.sponge import Protocols
from .primitives import WireAffine, WireBool, WireScalar
from .sponge import OuterSponge


@dataclass
class WireSchnorrSignature:
    r: WireAffine  # commitment point R = k*G
    s: WireScalar  # s = k + e*sk

    @staticmethod
    def witness(cfg: CurveCfg) -> "WireSchnorrSignature":
        return WireSchnorrSignature(r=WireAffine.witness(cfg), s=WireScalar.witness(cfg))

    @staticmethod
    def public_input(cfg: CurveCfg) -> "WireSchnorrSignature":
        return WireSchnorrSignature(
            r=WireAffine.public_input(cfg), s=WireScalar.public_input(cfg)
        )

    @staticmethod
    def hash_message(pk: WireAffine, r: WireAffine, message) -> WireScalar:
        sponge = OuterSponge(Protocols.SIGNATURE, pk.curve)
        sponge.absorb_g([pk, r])
        sponge.absorb_fq(message)
        return sponge.challenge()

    def verify(self, pk: WireAffine, message) -> WireBool:
        e = self.hash_message(pk, self.r, message)
        lhs = WireAffine.generator(pk.curve) * self.s
        rhs = self.r + pk * e
        return lhs.equals(rhs)


def bind_signature(call, wire_sig: WireSchnorrSignature, sig, as_public: bool = False) -> None:
    """Bind a host SchnorrSignature to its wires (CallSignature equivalent)."""
    if as_public:
        call.public_input_affine(wire_sig.r, sig.r)
        call.public_input(wire_sig.s, sig.s)
    else:
        call.witness_affine(wire_sig.r, sig.r)
        call.witness(wire_sig.s, sig.s)
