"""Poseidon permutation, sponge and Fiat-Shamir transcript on the host (the
port's copy of halo_tpu/poseidon/sponge.py, without its C++ permutation).

Bit-exact with the reference (crates/poseidon/src/inner_sponge.rs,
outer_sponge.rs):

  * state size 3 (rate 2, capacity 1); 55 full rounds
  * full round: sbox x^7 on all 3 words -> 3x3 MDS -> add round constants
  * absorb adds into state[0..rate] lazily (permute only when rate exhausted)
  * squeeze returns state words, permuting when entering squeeze mode
  * transcript: domain label absorbed first; points absorbed as affine (x, y)
    with infinity as (0, 0); scalars absorbed with the modulus-comparison
    bit-split rule; challenges squeeze a base-field element and drop the low
    bit when converting down to a smaller scalar field
"""

from __future__ import annotations

from enum import IntEnum

from ..curves import Affine, CurveCfg
from ..fields import FP_MOD, FQ_MOD
from .constants import FP_MDS, FP_ROUND_CONSTANTS, FQ_MDS, FQ_ROUND_CONSTANTS

SPONGE_RATE = 2
PERM_ROUNDS_FULL = 55


def _params_for_modulus(m: int):
    if m == FQ_MOD:
        return FQ_MDS, FQ_ROUND_CONSTANTS
    assert m == FP_MOD
    return FP_MDS, FP_ROUND_CONSTANTS


def permute(state: list[int], m: int) -> list[int]:
    """55 full rounds of the kimchi Poseidon permutation over F_m."""
    mds, rcs = _params_for_modulus(m)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = mds
    s0, s1, s2 = state
    for rc0, rc1, rc2 in rcs[:PERM_ROUNDS_FULL]:
        s0, s1, s2 = pow(s0, 7, m), pow(s1, 7, m), pow(s2, 7, m)
        s0, s1, s2 = ((m00 * s0 + m01 * s1 + m02 * s2 + rc0) % m,
                      (m10 * s0 + m11 * s1 + m12 * s2 + rc1) % m,
                      (m20 * s0 + m21 * s1 + m22 * s2 + rc2) % m)
    return [s0, s1, s2]


class PoseidonSponge:
    """Sponge over F_m with the reference's lazy absorb/squeeze schedule."""

    def __init__(self, m: int):
        self.m = m
        self.state = [0, 0, 0]
        self.absorbed = 0  # position when absorbing
        self.squeezed = -1  # -1 => absorbing mode; else squeeze position

    def absorb(self, xs) -> None:
        m = self.m
        for x in xs:
            if self.squeezed >= 0:  # was squeezing -> restart absorb at 0
                self.squeezed = -1
                self.absorbed = 1
                self.state[0] = (self.state[0] + x) % m
            elif self.absorbed < SPONGE_RATE:
                self.state[self.absorbed] = (self.state[self.absorbed] + x) % m
                self.absorbed += 1
            else:
                self.state = permute(self.state, m)
                self.absorbed = 1
                self.state[0] = (self.state[0] + x) % m

    def squeeze(self) -> int:
        if 0 <= self.squeezed < SPONGE_RATE:
            out = self.state[self.squeezed]
            self.squeezed += 1
            return out
        self.state = permute(self.state, self.m)
        self.squeezed = 1
        self.absorbed = 0
        return self.state[0]


class Protocols(IntEnum):
    PCDL = 0
    ASDL = 1
    PLONK = 2
    SIGNATURE = 3


class Sponge:
    """Fiat-Shamir transcript over a curve's base field
    (reference crates/poseidon/src/outer_sponge.rs:12-100)."""

    def __init__(self, label: Protocols, cfg: CurveCfg):
        self.cfg = cfg
        self.sponge = PoseidonSponge(cfg.p)
        self.sponge.absorb([int(label) % cfg.p])

    def absorb_g(self, gs) -> None:
        for g in gs:
            self.sponge.absorb([0, 0] if g is None else [g[0], g[1]])

    def absorb_fq(self, xs) -> None:
        for x in xs:
            self.sponge.absorb([x % self.cfg.p])

    def absorb_fr(self, xs) -> None:
        """Absorb scalar-field elements: where the scalar modulus exceeds
        the base modulus (Pallas), as (high 254 bits, low bit); otherwise
        as they are."""
        big_scalar = self.cfg.r > self.cfg.p
        for x in xs:
            x %= self.cfg.r
            if big_scalar:
                self.sponge.absorb([x >> 1, x & 1])
            else:
                self.sponge.absorb([x])

    def challenge(self) -> int:
        """Squeeze a scalar-field challenge from the base-field sponge."""
        out = self.sponge.squeeze()
        if self.cfg.r < self.cfg.p:
            return out >> 1  # drop the low bit so the value fits the smaller field
        return out


def hash_message(cfg: CurveCfg, pk: Affine, r_point: Affine, msg_fields) -> int:
    """Schnorr message hash e = H(SIGNATURE || pk || R || m)
    (reference crates/schnorr/src/lib.rs hash_message)."""
    sponge = Sponge(Protocols.SIGNATURE, cfg)
    sponge.absorb_g([pk, r_point])
    sponge.absorb_fq(msg_fields)
    return sponge.challenge()
