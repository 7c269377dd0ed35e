"""PCDL: IPA (bulletproofs-style) polynomial commitments over the Pasta SRS
(port of halo_tpu/pcdl.py).

The data classes, the polynomial h(X) and the succinct check are host
code, copied from halo_tpu.pcdl (reference crates/accumulation/src/
pcdl.rs).  The commitments, opens and the full check route their MSMs
through the port's MSM (ops/msm2.py) and IPA (ops/ipa.py) on an explicit
device.  A blinding factor w adds w*S to a commitment (S: the SRS's
index 0) on the host; a hiding open (w given) draws its random q(X) and
w_bar from the caller's rng, as halo_tpu.pcdl does, so a seeded
random.Random gives the reference's proof byte for byte.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional

import torch

from .curves import Affine, CurveCfg, ec_add, ec_mul, from_jac, jac_add, jac_mul, to_jac
from .errors import PcdlCheckError
from .fields import inv
from .ops import ff, ipa, msm2
from .poseidon.sponge import Protocols, Sponge
from .serde import Reader, Serde, Writer

# ---------------- data structures ---------------- #


@dataclass
class EvalProof(Serde):
    Ls: list[Affine]
    Rs: list[Affine]
    U: Affine
    c: int
    C_bar: Optional[Affine] = None
    w_prime: Optional[int] = None

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "EvalProof":
        return cls(
            Ls=r.vec(lambda: r.point_compressed(cfg)),
            Rs=r.vec(lambda: r.point_compressed(cfg)),
            U=r.point_compressed(cfg),
            c=r.field(cfg.r),
            C_bar=r.option(lambda: r.point_compressed(cfg)),
            w_prime=r.option(lambda: r.field(cfg.r)),
        )

    def serialize(self, w: Writer, cfg: CurveCfg) -> None:
        w.vec(self.Ls, lambda p: w.point_compressed(cfg, p))
        w.vec(self.Rs, lambda p: w.point_compressed(cfg, p))
        w.point_compressed(cfg, self.U)
        w.field(self.c)
        w.option(self.C_bar, lambda p: w.point_compressed(cfg, p))
        w.option(self.w_prime, lambda v: w.field(v))


@dataclass
class HPoly:
    """h(X) := prod_{i=0}^{lg n - 1} (1 + xi_{lg n - i} X^(2^i)); xis[0] unused."""

    xis: list[int]
    r: int  # scalar field modulus

    def eval(self, z: int) -> int:
        m = self.r
        lg_n = len(self.xis) - 1
        v = (1 + self.xis[lg_n] * z) % m
        z_i = z
        for i in range(1, lg_n):
            z_i = z_i * z_i % m
            v = v * (1 + self.xis[lg_n - i] * z_i) % m
        return v

    def coeffs(self) -> list[int]:
        m = self.r
        lg_n = len(self.xis) - 1
        out = [1]
        for i in range(lg_n):
            xi = self.xis[lg_n - i]
            out = out + [c * xi % m for c in out]
        return out


@dataclass
class Instance(Serde):
    C: Affine
    d: int
    z: int
    v: int
    pi: EvalProof

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "Instance":
        return cls(
            C=r.point_compressed(cfg),
            d=r.u64(),
            z=r.field(cfg.r),
            v=r.field(cfg.r),
            pi=EvalProof.deserialize(r, cfg),
        )

    def serialize(self, w: Writer, cfg: CurveCfg) -> None:
        w.point_compressed(cfg, self.C)
        w.u64(self.d)
        w.field(self.z)
        w.field(self.v)
        self.pi.serialize(w, cfg)

    @classmethod
    def open(cls, cfg: CurveCfg, p: list[int], d: int, z: int, device, w: int | None = None,
             rng=None) -> "Instance":
        C = commit(cfg, p, d, device, w)
        v = poly_eval(cfg, p, z)
        pi = open_without_eval(cfg, p, C, d, z, v, device, w, rng=rng)
        return cls(C=C, d=d, z=z, v=v, pi=pi)


def poly_eval(cfg: CurveCfg, coeffs: list[int], z: int) -> int:
    m = cfg.r
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % m
    return acc


# ---------------- protocol functions ---------------- #


def _srs_msm(cfg: CurveCfg, scalars: list[int], device) -> Affine:
    """MSM against the first len(scalars) SRS generators."""
    return msm2.msm2_srs(cfg, [s % cfg.r for s in scalars], device)


def blind(cfg: CurveCfg, C: Affine, w: int | None) -> Affine:
    """C + w*S (S: the SRS's index 0); C itself when w is None."""
    from .srs import load_sh

    return C if w is None else ec_add(cfg, C, ec_mul(cfg, load_sh(cfg.name)[0], w))


def commit(cfg: CurveCfg, p: list[int], d: int, device, w: int | None = None) -> Affine:
    """Pedersen commitment to host coefficients, MSM(Gs, p) + w*S
    (reference pcdl.rs:275-287)."""
    n = d + 1
    assert n & (n - 1) == 0, "n must be a power of two"
    assert len(p) <= n
    return blind(cfg, _srs_msm(cfg, p, device), w)


def chunked_commit(cfg: CurveCfg, p: list[int], d: int, device, w: int | None = None,
                   chunk_size: int = 1 << 10) -> list[Affine]:
    """One commitment per chunk of chunk_size coefficients, each + w*S
    (reference pcdl.rs:294-314): the chunks stacked as (8, k, width)
    rows, the last zero-padded, in one batched MSM.  An empty p is one
    empty chunk."""
    n = d + 1
    assert n & (n - 1) == 0, "n must be a power of two"
    k = -(-max(len(p), 1) // chunk_size)
    width = min(chunk_size, max(len(p), 1))
    flat = [c % cfg.r for c in p] + [0] * (k * width - len(p))
    K = ff.to_rows(flat, device).reshape(ff.NWORDS, k, width)
    return [blind(cfg, C, w) for C in msm2.msm2_srs_rows_multi(cfg, K)]


def commit_rows(cfg: CurveCfg, K: torch.Tensor, d: int) -> list[Affine]:
    """Commit an (8, k, n) stack of canonical coefficient rows."""
    assert K.shape[-1] <= d + 1
    return msm2.msm2_srs_rows_multi(cfg, K)


def open_without_eval(cfg: CurveCfg, p, C: Affine, d: int, z: int, v: int, device,
                      w: int | None = None, rng=None) -> EvalProof:
    """IPA opening proof (reference pcdl.rs:326-453); p is a host list or
    an (8, n') Montgomery row tensor.  With a blinding factor w (C then
    commits with w) the proof hides p: rng (a random.Random-like
    generator; secrets.SystemRandom() when None) draws q's d coefficients
    and then w_bar, in the reference's order."""
    n = d + 1
    assert n >= 1 and n & (n - 1) == 0
    if w is None:
        return ipa.open_without_eval_device(cfg, p, C, d, z, v, device)
    assert n > 1
    if rng is None:
        rng = secrets.SystemRandom()
    return ipa.open_hiding_device(cfg, p, C, d, z, v, w, rng, device)


def open_proof(cfg: CurveCfg, p: list[int], C: Affine, d: int, z: int, device,
               w: int | None = None, rng=None) -> EvalProof:
    v = poly_eval(cfg, p, z)
    return open_without_eval(cfg, p, C, d, z, v, device, w, rng=rng)


def succinct_check(cfg: CurveCfg, C: Affine, d: int, z: int, v: int,
                   pi: EvalProof) -> tuple[HPoly, Affine]:
    """O(lg n) check; returns (h, U) (reference pcdl.rs:483-554).  A
    hiding proof's C' = C + a*C_bar - w'*S, with a from (C, C_bar, z, v),
    stands for C."""
    from .srs import load_sh

    n = d + 1
    lg_n = n.bit_length() - 1
    assert n & (n - 1) == 0
    m = cfg.r
    _, H = load_sh(cfg.name)
    transcript = Sponge(Protocols.PCDL, cfg)

    if pi.C_bar is not None:
        if pi.w_prime is None:
            raise PcdlCheckError("succinct_check failed: a hiding proof without w'")
        transcript.absorb_g([C, pi.C_bar])
        transcript.absorb_fr([z, v])
        a = transcript.challenge()
        C = blind(cfg, ec_add(cfg, C, ec_mul(cfg, pi.C_bar, a)), (m - pi.w_prime) % m)

    transcript.absorb_g([C])
    transcript.absorb_fr([z, v])
    xi_0 = transcript.challenge()
    xis = [xi_0]
    H_prime = ec_mul(cfg, H, xi_0)

    C_i = jac_add(cfg, to_jac(C), jac_mul(cfg, to_jac(H_prime), v))

    for i in range(lg_n):
        transcript.absorb_fr([xis[i]])
        transcript.absorb_g([pi.Ls[i], pi.Rs[i]])
        xi_next = transcript.challenge()
        xis.append(xi_next)
        C_i = jac_add(cfg, C_i, jac_mul(cfg, to_jac(pi.Ls[i]), inv(xi_next, m)))
        C_i = jac_add(cfg, C_i, jac_mul(cfg, to_jac(pi.Rs[i]), xi_next))

    h = HPoly(xis=xis, r=m)
    v_prime = pi.c * h.eval(z) % m
    rhs = jac_add(cfg, jac_mul(cfg, to_jac(pi.U), pi.c), jac_mul(cfg, to_jac(H_prime), v_prime))
    if from_jac(cfg, C_i) != from_jac(cfg, rhs):
        raise PcdlCheckError("succinct_check failed: C_lg != U*c + H'*(c*h(z))")
    return h, pi.U


def check(cfg: CurveCfg, C: Affine, d: int, z: int, v: int, pi: EvalProof, device) -> None:
    """Full (linear-time) check (reference pcdl.rs:563-583)."""
    h, U = succinct_check(cfg, C, d, z, v, pi)
    if U != _srs_msm(cfg, h.coeffs(), device):
        raise PcdlCheckError("check failed: U != MSM(Gs, h_coeffs)")
