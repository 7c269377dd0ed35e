"""Typed wires: WireScalar, WireBool, WireAffine (port of
halo_tpu/frontend/primitives.py).

Mirrors reference crates/plonk/src/frontend/primitives/.  A wire is tagged
with the curve cfg whose SCALAR field it lives in (the reference's
WireScalar<P> lives in P::SFID); a WireAffine's coordinate wires live in the
curve's BASE field, i.e. in the OTHER curve's scalar field.

Deviation from the reference (documented): WireBool.__invert__ computes the
correct 1 - b; the reference's shipped `Not` computes 1 + b and emits a dead
add gate (bool.rs:120-130), which is unused outside its own (flaky) test.
"""

from __future__ import annotations

from ..curves import PALLAS, VESTA, Affine, CurveCfg
from ..fields import FP_MOD
from ..plonk.circuit import FP, FQ
from . import current


def _sfid(cfg: CurveCfg) -> int:
    return FP if cfg.r == FP_MOD else FQ


def _bfid(cfg: CurveCfg) -> int:
    return 1 - _sfid(cfg)


def _other(cfg: CurveCfg) -> CurveCfg:
    return VESTA if cfg.name == "pallas" else PALLAS


class WireScalar:
    __slots__ = ("cfg", "wire")

    def __init__(self, cfg: CurveCfg, wire):
        self.cfg = cfg
        self.wire = wire

    # ---- constructors ---- #
    @staticmethod
    def witness(cfg: CurveCfg) -> "WireScalar":
        return WireScalar(cfg, current().circuit.witness(_sfid(cfg)))

    @staticmethod
    def public_input(cfg: CurveCfg) -> "WireScalar":
        return WireScalar(cfg, current().circuit.public_input(_sfid(cfg)))

    @staticmethod
    def constant(cfg: CurveCfg, c: int) -> "WireScalar":
        return WireScalar(cfg, current().circuit.constant(_sfid(cfg), c % cfg.r))

    @staticmethod
    def zero(cfg: CurveCfg) -> "WireScalar":
        return WireScalar(cfg, current().circuit.zero[_sfid(cfg)])

    @staticmethod
    def one(cfg: CurveCfg) -> "WireScalar":
        return WireScalar(cfg, current().circuit.one[_sfid(cfg)])

    # ---- ops ---- #
    def __add__(self, other: "WireScalar") -> "WireScalar":
        return WireScalar(self.cfg, current().circuit.add_gate(self.wire, other.wire))

    def __mul__(self, other: "WireScalar") -> "WireScalar":
        return WireScalar(self.cfg, current().circuit.mul_gate(self.wire, other.wire))

    def __neg__(self) -> "WireScalar":
        return WireScalar(self.cfg, current().circuit.neg_gate(self.wire))

    def __sub__(self, other: "WireScalar") -> "WireScalar":
        return self + (-other)

    def __truediv__(self, other: "WireScalar") -> "WireScalar":
        return self * other.inv()

    def inv(self) -> "WireScalar":
        return WireScalar(self.cfg, current().circuit.inv_gate(self.wire))

    def square(self) -> "WireScalar":
        return self * self

    def double(self) -> "WireScalar":
        return self + self

    def geometric_series(self, n: int) -> list["WireScalar"]:
        out = []
        cur = WireScalar.one(self.cfg)
        for _ in range(n):
            out.append(cur)
            cur = cur * self
        return out

    def assert_eq(self, other: "WireScalar") -> None:
        current().circuit.assert_eq_gate(self.wire, other.wire)

    def equals(self, other: "WireScalar") -> "WireBool":
        return WireBool(self.cfg, current().circuit.eq_gate(self.wire, other.wire))

    def fp_message_pass(self) -> tuple["WireScalar", "WireScalar"]:
        assert self.wire.fid == FP
        h, low = current().circuit.fp_message_pass(self.wire)
        other = _other_by_sfid(FQ)
        return WireScalar(other, h), WireScalar(other, low)

    def fq_message_pass(self) -> "WireScalar":
        assert self.wire.fid == FQ
        v = current().circuit.fq_message_pass(self.wire)
        return WireScalar(_other_by_sfid(FP), v)

    def output(self) -> None:
        current().circuit.output_gate(self.wire)


def _other_by_sfid(fid: int) -> CurveCfg:
    return PALLAS if fid == FP else VESTA


class WireBool:
    __slots__ = ("cfg", "wire")

    def __init__(self, cfg: CurveCfg, wire):
        self.cfg = cfg
        self.wire = wire

    @staticmethod
    def witness(cfg: CurveCfg) -> "WireBool":
        return WireBool(cfg, current().circuit.witness_bool(_sfid(cfg)))

    @staticmethod
    def false_(cfg: CurveCfg) -> "WireBool":
        return WireBool(cfg, current().circuit.zero[_sfid(cfg)])

    @staticmethod
    def true_(cfg: CurveCfg) -> "WireBool":
        return WireBool(cfg, current().circuit.one[_sfid(cfg)])

    @staticmethod
    def constant(cfg: CurveCfg, b: bool) -> "WireBool":
        return WireBool.true_(cfg) if b else WireBool.false_(cfg)

    def assert_eq(self, other: "WireBool") -> None:
        current().circuit.assert_eq_gate(self.wire, other.wire)

    def message_pass(self) -> "WireBool":
        c = current().circuit
        if self.wire.fid == FP:
            w = c.fp_bool_message_pass(self.wire)
            return WireBool(_other_by_sfid(FQ), w)
        w = c.fq_bool_message_pass(self.wire)
        return WireBool(_other_by_sfid(FP), w)

    def scalar_ite(self, true_case: WireScalar, false_case: WireScalar) -> WireScalar:
        c = current().circuit
        ct = c.mul_gate(self.wire, true_case.wire)
        one = c.one[self.wire.fid]
        minus_cond = c.neg_gate(self.wire)
        one_minus = c.add_gate(one, minus_cond)
        cf = c.mul_gate(one_minus, false_case.wire)
        return WireScalar(true_case.cfg, c.add_gate(ct, cf))

    def affine_ite(self, true_case: "WireAffine", false_case: "WireAffine") -> "WireAffine":
        x = self.scalar_ite(true_case.x, false_case.x)
        y = self.scalar_ite(true_case.y, false_case.y)
        return WireAffine(true_case.curve, x, y)

    def __and__(self, other: "WireBool") -> "WireBool":
        return WireBool(self.cfg, current().circuit.mul_gate(self.wire, other.wire))

    def __or__(self, other: "WireBool") -> "WireBool":
        c = current().circuit
        a_plus_b = c.add_gate(self.wire, other.wire)
        a_times_b = c.mul_gate(self.wire, other.wire)
        neg_ab = c.neg_gate(a_times_b)
        return WireBool(self.cfg, c.add_gate(a_plus_b, neg_ab))

    def __invert__(self) -> "WireBool":
        c = current().circuit
        one = c.one[self.wire.fid]
        neg = c.neg_gate(self.wire)
        return WireBool(self.cfg, c.add_gate(one, neg))

    def output(self) -> None:
        current().circuit.output_gate(self.wire)


class WireAffine:
    """A point on `curve`; coordinate wires live in the curve's base field."""

    __slots__ = ("curve", "x", "y")

    def __init__(self, curve: CurveCfg, x: WireScalar, y: WireScalar):
        self.curve = curve
        self.x = x
        self.y = y

    @staticmethod
    def _coord_cfg(curve: CurveCfg) -> CurveCfg:
        return _other(curve)  # base field of `curve` = scalar field of the other

    @staticmethod
    def witness(curve: CurveCfg) -> "WireAffine":
        c = current().circuit
        fid = _bfid(curve)
        ccfg = WireAffine._coord_cfg(curve)
        x = WireScalar(ccfg, c.witness(fid))
        y = WireScalar(ccfg, c.witness(fid))
        return WireAffine(curve, x, y)

    @staticmethod
    def public_input(curve: CurveCfg) -> "WireAffine":
        c = current().circuit
        fid = _bfid(curve)
        ccfg = WireAffine._coord_cfg(curve)
        x = WireScalar(ccfg, c.public_input(fid))
        y = WireScalar(ccfg, c.public_input(fid))
        return WireAffine(curve, x, y)

    @staticmethod
    def constant(curve: CurveCfg, point: Affine) -> "WireAffine":
        c = current().circuit
        fid = _bfid(curve)
        ccfg = WireAffine._coord_cfg(curve)
        px, py = (0, 0) if point is None else point
        x = WireScalar(ccfg, c.constant(fid, px))
        y = WireScalar(ccfg, c.constant(fid, py))
        return WireAffine(curve, x, y)

    @staticmethod
    def identity(curve: CurveCfg) -> "WireAffine":
        c = current().circuit
        fid = _bfid(curve)
        ccfg = WireAffine._coord_cfg(curve)
        return WireAffine(curve, WireScalar(ccfg, c.zero[fid]), WireScalar(ccfg, c.zero[fid]))

    @staticmethod
    def generator(curve: CurveCfg) -> "WireAffine":
        return WireAffine.constant(curve, curve.generator)

    def __add__(self, other: "WireAffine") -> "WireAffine":
        c = current().circuit
        xw, yw = c.add_points((self.x.wire, self.y.wire), (other.x.wire, other.y.wire))
        ccfg = WireAffine._coord_cfg(self.curve)
        return WireAffine(self.curve, WireScalar(ccfg, xw), WireScalar(ccfg, yw))

    def __neg__(self) -> "WireAffine":
        c = current().circuit
        yn = c.neg_gate(self.y.wire)
        ccfg = WireAffine._coord_cfg(self.curve)
        return WireAffine(self.curve, self.x, WireScalar(ccfg, yn))

    def __mul__(self, scalar: WireScalar) -> "WireAffine":
        """Scalar mul: the scalar crosses fields via message-pass gates
        (curve.rs:157-179)."""
        c = current().circuit
        ccfg = WireAffine._coord_cfg(self.curve)
        if self.curve.name == "pallas":
            h, low = c.fp_message_pass(scalar.wire)
            xw, yw = c.scalar_mul_pallas((h, low), (self.x.wire, self.y.wire))
        else:
            v = c.fq_message_pass(scalar.wire)
            xw, yw = c.scalar_mul_vesta(v, (self.x.wire, self.y.wire))
        return WireAffine(self.curve, WireScalar(ccfg, xw), WireScalar(ccfg, yw))

    def assert_eq(self, other: "WireAffine") -> None:
        self.x.assert_eq(other.x)
        self.y.assert_eq(other.y)

    def equals(self, other: "WireAffine") -> WireBool:
        return self.x.equals(other.x) & self.y.equals(other.y)

    def output(self) -> None:
        self.x.output()
        self.y.output()
