"""In-circuit Poseidon sponge + Fiat-Shamir transcript (port of
halo_tpu/frontend/sponge.py).

Mirrors reference crates/plonk/src/frontend/poseidon/: the permutation is 11
Poseidon gates (5 rounds each) + PoseidonEnd = 55 rounds; the outer sponge
reproduces the native transcript bit-for-bit, with cross-field values moved
through message-pass gates.  OuterSponge(cfg) hashes over cfg's BASE field
and emits challenges in cfg's SCALAR field.
"""

from __future__ import annotations

from ..curves import CurveCfg
from ..poseidon.sponge import SPONGE_RATE, Protocols
from . import current
from .primitives import WireScalar, _other

STATE_SIZE = 3


class InnerSponge:
    """Sponge over cfg's scalar field (used with the *other* curve's cfg so
    it runs over the transcript's base field)."""

    def __init__(self, cfg: CurveCfg):
        self.cfg = cfg
        self.state = [WireScalar.zero(cfg) for _ in range(STATE_SIZE)]
        self.absorbed = 0
        self.squeezed = -1

    def permute(self) -> None:
        c = current().circuit
        wires = tuple(s.wire for s in self.state)
        for i in range(11):
            wires = c.poseidon(i, wires)
        wires = c.poseidon_finish(wires)
        self.state = [WireScalar(self.cfg, w) for w in wires]

    def absorb(self, xs) -> None:
        for x in xs:
            if self.squeezed >= 0:
                self.squeezed = -1
                self.absorbed = 1
                self.state[0] = self.state[0] + x
            elif self.absorbed < SPONGE_RATE:
                self.state[self.absorbed] = self.state[self.absorbed] + x
                self.absorbed += 1
            else:
                self.permute()
                self.absorbed = 1
                self.state[0] = self.state[0] + x

    def squeeze(self) -> WireScalar:
        if 0 <= self.squeezed < SPONGE_RATE:
            out = self.state[self.squeezed]
            self.squeezed += 1
            return out
        self.permute()
        self.squeezed = 1
        self.absorbed = 0
        return self.state[0]


class OuterSponge:
    """In-circuit transcript for curve cfg (reference outer_sponge.rs)."""

    def __init__(self, label: Protocols, cfg: CurveCfg):
        self.cfg = cfg
        self.base_cfg = _other(cfg)  # sponge field = cfg's base field
        self.sponge = InnerSponge(self.base_cfg)
        self.sponge.absorb([WireScalar.constant(self.base_cfg, int(label))])

    def absorb_g(self, gs) -> None:
        for g in gs:
            self.sponge.absorb([g.x, g.y])

    def absorb_fq(self, xs) -> None:
        """Absorb base-field wires directly."""
        for x in xs:
            self.sponge.absorb([x])

    def absorb_fr(self, xs) -> None:
        """Absorb scalar-field wires (message-passed into the base field)."""
        for x in xs:
            if self.cfg.r < self.cfg.p:
                self.sponge.absorb([x.fq_message_pass()])
            else:
                h, low = x.fp_message_pass()
                self.sponge.absorb([h])
                self.sponge.absorb([low])

    def challenge(self) -> WireScalar:
        x = self.sponge.squeeze()
        if self.cfg.r < self.cfg.p:
            h, _ = x.fp_message_pass()
            return h
        return x.fq_message_pass()
