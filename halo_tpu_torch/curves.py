"""Pasta curves on the host, as Python ints (the port's copy of
halo_tpu/curves.py, cut to what the port calls).

  Pallas: y^2 = x^3 + 5 over Fq, scalar field Fp, generator (-1, 2)
  Vesta:  y^2 = x^3 + 5 over Fp, scalar field Fq, generator (-1, 2)

Affine points are (x, y) int tuples; None is the point at infinity.  The
host arithmetic runs in Jacobian coordinates; the device kernels use the
complete projective formulas of csrc/field.cuh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .fields import FP_MOD, FQ_MOD, inv, sqrt

Affine = Optional[Tuple[int, int]]  # None = point at infinity


@dataclass(frozen=True)
class CurveCfg:
    name: str
    p: int  # base field modulus
    r: int  # scalar field modulus
    b: int = 5

    @property
    def generator(self) -> Affine:
        return (self.p - 1, 2)

    def is_on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.b)) % self.p == 0


PALLAS = CurveCfg(name="pallas", p=FQ_MOD, r=FP_MOD)
VESTA = CurveCfg(name="vesta", p=FP_MOD, r=FQ_MOD)


def cfg_of(name: str) -> CurveCfg:
    return PALLAS if name == "pallas" else VESTA


def decompress_point(cfg: CurveCfg, x: int, y_is_negative: bool) -> Affine:
    """The affine point with abscissa x and the given sign (arkworks'
    compressed form): the smaller of y and p - y, or the larger when the
    flag is set.  Raises ValueError if x is not on the curve."""
    rhs = (x * x % cfg.p * x + cfg.b) % cfg.p
    y = sqrt(rhs, cfg.p)
    if y is None:
        raise ValueError("x is not on the curve")
    smaller, larger = (y, cfg.p - y) if y <= cfg.p - y else (cfg.p - y, y)
    return (x, larger if y_is_negative else smaller)


# ---------------- Jacobian arithmetic (X/Z^2, Y/Z^3) ---------------- #

Jac = Tuple[int, int, int]  # Z == 0 => infinity

JAC_INF: Jac = (1, 1, 0)


def to_jac(pt: Affine) -> Jac:
    if pt is None:
        return JAC_INF
    return (pt[0], pt[1], 1)


def from_jac(cfg: CurveCfg, P: Jac) -> Affine:
    X, Y, Z = P
    if Z == 0:
        return None
    p = cfg.p
    zinv = inv(Z, p)
    zinv2 = zinv * zinv % p
    return (X * zinv2 % p, Y * zinv2 % p * zinv % p)


def jac_double(cfg: CurveCfg, P: Jac) -> Jac:
    X1, Y1, Z1 = P
    if Z1 == 0 or Y1 == 0:
        return JAC_INF if Y1 == 0 and Z1 != 0 else P
    p = cfg.p
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = B * B % p
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
    E = 3 * A % p
    F = E * E % p
    X3 = (F - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y1 * Z1 % p
    return (X3, Y3, Z3)


def jac_add(cfg: CurveCfg, P: Jac, Q: Jac) -> Jac:
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    p = cfg.p
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    if U1 == U2:
        if S1 != S2:
            return JAC_INF
        return jac_double(cfg, P)
    H = (U2 - U1) % p
    I = 4 * H * H % p
    J = H * I % p
    rr = 2 * (S2 - S1) % p
    V = U1 * I % p
    X3 = (rr * rr - J - 2 * V) % p
    Y3 = (rr * (V - X3) - 2 * S1 * J) % p
    Z3 = (Z1 + Z2) % p
    Z3 = (Z3 * Z3 - Z1Z1 - Z2Z2) % p * H % p
    return (X3, Y3, Z3)


def jac_mul(cfg: CurveCfg, P: Jac, k: int) -> Jac:
    k %= cfg.r
    acc = JAC_INF
    while k:
        if k & 1:
            acc = jac_add(cfg, acc, P)
        P = jac_double(cfg, P)
        k >>= 1
    return acc


# ---------------- Affine-level API ---------------- #


def ec_add(cfg: CurveCfg, a: Affine, b: Affine) -> Affine:
    return from_jac(cfg, jac_add(cfg, to_jac(a), to_jac(b)))


def ec_mul(cfg: CurveCfg, a: Affine, k: int) -> Affine:
    return from_jac(cfg, jac_mul(cfg, to_jac(a), k))
