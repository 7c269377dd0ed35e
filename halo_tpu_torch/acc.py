"""ASDL accumulation over PCDL instances (port of halo_tpu/acc.py;
reference crates/accumulation/src/acc.rs).

  common_subroutine  succinct-check every instance, derive alpha, batch the
                     U_i into C = sum alpha^i U_i, derive z (host)
  prover             v = h(z); pi = the port's IPA open of h(X) at z
  verifier           re-run the subroutine, compare (C, d, z, h(z) = v)
  decider            the full pcdl.check, whose MSM runs on the device

The instances may be hiding (pcdl's C_bar branch) or not, mixed.  The
accumulator's own open is non-hiding, as in the reference (C_bar = C).
At n = 2^16,
k = 1 the zero accumulator comes from tests/fixtures/ivc_consts.json, as
in halo_tpu: the reference's frozen base-case accumulators, which the
from-scratch path reproduces.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from . import pcdl
from .curves import Affine, CurveCfg, from_jac, jac_add, jac_mul, to_jac
from .errors import AccumulationError
from .pcdl import HPoly, Instance
from .poseidon.sponge import Protocols, Sponge
from .serde import Reader, Serde, Writer

IVC_CONSTS = Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "ivc_consts.json"


@dataclass
class Accumulator(Serde):
    q: Instance

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "Accumulator":
        return cls(q=Instance.deserialize(r, cfg))

    def serialize(self, w: Writer, cfg: CurveCfg) -> None:
        self.q.serialize(w, cfg)


@dataclass
class AccumulatedHPolys:
    hs: list[HPoly]
    alphas: list[int]
    alpha: int | None
    r: int

    def eval(self, z: int) -> int:
        v = 0
        for h, a in zip(self.hs, self.alphas):
            v = (v + h.eval(z) * a) % self.r
        return v

    def coeffs(self) -> list[int]:
        out: list[int] = []
        for h, a in zip(self.hs, self.alphas):
            cs = h.coeffs()
            if len(out) < len(cs):
                out += [0] * (len(cs) - len(out))
            for i, c in enumerate(cs):
                out[i] = (out[i] + c * a) % self.r
        return out

    def scalars(self) -> list[int]:
        out = [xi for h in self.hs for xi in h.xis]
        if self.alpha is not None:
            out.append(self.alpha)
        return out


def common_subroutine(cfg: CurveCfg,
                      qs: list[Instance]) -> tuple[Affine, int, int, AccumulatedHPolys]:
    """Reference acc.rs:128-176."""
    assert qs, "no instances given"
    d = qs[0].d
    m = cfg.r
    transcript = Sponge(Protocols.ASDL, cfg)

    hs: list[HPoly] = []
    Us: list[Affine] = []
    for q in qs:
        h_i, U_i = pcdl.succinct_check(cfg, q.C, q.d, q.z, q.v, q.pi)
        hs.append(h_i)
        Us.append(U_i)
        assert q.d == d, "d_i != d"

    acc_h = AccumulatedHPolys(hs=hs, alphas=[], alpha=None, r=m)
    transcript.absorb_fr(acc_h.scalars())
    transcript.absorb_g(Us)
    alpha = transcript.challenge()
    acc_h.alpha = alpha
    cur = 1
    for _ in range(len(hs)):
        acc_h.alphas.append(cur)
        cur = cur * alpha % m

    # C = sum alpha^i U_i
    C = None
    for a, U in zip(acc_h.alphas, Us):
        C = from_jac(cfg, jac_add(cfg, to_jac(C), jac_mul(cfg, to_jac(U), a)))

    z = transcript.challenge()
    return C, d, z, acc_h


def prover(cfg: CurveCfg, qs: list[Instance], device) -> Accumulator:
    C_bar, d, z, h = common_subroutine(cfg, qs)
    v = h.eval(z)
    pi = pcdl.open_proof(cfg, h.coeffs(), C_bar, d, z, device)
    return Accumulator(q=Instance(C=C_bar, d=d, z=z, v=v, pi=pi))


def verifier(cfg: CurveCfg, qs: list[Instance], acc: Accumulator) -> None:
    C_prime, d_prime, z_prime, h = common_subroutine(cfg, qs)
    if C_prime != acc.q.C:
        raise AccumulationError("acc verifier: C_bar' != C_bar")
    if z_prime != acc.q.z:
        raise AccumulationError("acc verifier: z' != z")
    if d_prime != acc.q.d:
        raise AccumulationError("acc verifier: d' != d")
    if h.eval(acc.q.z) != acc.q.v:
        raise AccumulationError("acc verifier: h(z) != v")


def decider(cfg: CurveCfg, acc: Accumulator, device) -> None:
    pcdl.check(cfg, acc.q.C, acc.q.d, acc.q.z, acc.q.v, acc.q.pi, device)


def zero_instance(cfg: CurveCfg, n: int, device) -> Instance:
    """Instance::zero: zero polynomial, C = identity, z = v = 0."""
    pi = pcdl.open_without_eval(cfg, [0], None, n - 1, 0, 0, device)
    return Instance(C=None, d=n - 1, z=0, v=0, pi=pi)


def _zero_acc_from_fixture(cfg: CurveCfg, n: int, k: int) -> Accumulator | None:
    """The reference's frozen base-case accumulator (ivc/mod.rs:195-292)
    from tests/fixtures/ivc_consts.json, at the IVC shape only."""
    if k != 1 or n != 65536 or not IVC_CONSTS.exists():
        return None
    a = json.loads(IVC_CONSTS.read_text()).get(f"acc_0_{cfg.name}")
    if a is None:
        return None

    def pt(v):
        return None if v is None or v == [None, None] else (int(v[0]), int(v[1]))

    pi = pcdl.EvalProof(Ls=[pt(p) for p in a["Ls"]], Rs=[pt(p) for p in a["Rs"]],
                        U=pt(a["U"]), c=int(a["c"]))
    return Accumulator(q=Instance(C=pt(a["C"]), d=int(a["d"]), z=int(a["z"]),
                                  v=int(a["v"]), pi=pi))


_ZERO_ACC: dict = {}


def zero_accumulator(cfg: CurveCfg, n: int, device, k: int = 1) -> Accumulator:
    """Accumulator::zero(n, k) (acc.rs:37-41); deterministic, so cached
    per (curve, n, k)."""
    key = (cfg.name, n, k)
    if key not in _ZERO_ACC:
        acc = _zero_acc_from_fixture(cfg, n, k)
        if acc is None:
            acc = prover(cfg, [zero_instance(cfg, n, device)] * k, device)
        _ZERO_ACC[key] = acc
    return _ZERO_ACC[key]
