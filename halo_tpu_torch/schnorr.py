"""Schnorr signatures over the Pasta curves with Poseidon message hashing,
on the host (port of halo_tpu/schnorr.py sign and verify; reference
crates/schnorr/src/lib.rs:11-80):

  sign: R = k*G, e = H(SIGNATURE || pk || R || m), s = k + e*sk;
  verify: s*G == R + e*pk.
"""

from __future__ import annotations

from dataclasses import dataclass

from .curves import Affine, CurveCfg, ec_add, ec_mul
from .poseidon.sponge import hash_message


@dataclass(frozen=True)
class SchnorrSignature:
    r: Affine  # commitment point R = k*G
    s: int  # s = k + e*sk (scalar field)


def sign(cfg: CurveCfg, sk: int, message: list[int], k: int) -> SchnorrSignature:
    """Signature of `message` under `sk` with the nonce k (1 <= k < r)."""
    r_point = ec_mul(cfg, cfg.generator, k)
    pk = ec_mul(cfg, cfg.generator, sk)
    e = hash_message(cfg, pk, r_point, message)
    return SchnorrSignature(r=r_point, s=(k + e * sk) % cfg.r)


def verify(cfg: CurveCfg, pk: Affine, message: list[int], sig: SchnorrSignature) -> bool:
    e = hash_message(cfg, pk, sig.r, message)
    lhs = ec_mul(cfg, cfg.generator, sig.s)
    return lhs == ec_add(cfg, sig.r, ec_mul(cfg, pk, e))
