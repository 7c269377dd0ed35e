"""Accumulation prover and decider on tensors (port of halo_tpu/acc.py
prover, decider, zero_instance, zero_accumulator :106-185).

The common subroutine and the verifier are halo_tpu's (host transcript
and succinct checks); the opens and the decider's MSM go through the
port's pcdl.  At n = 2^16, k = 1 the zero accumulator comes from
tests/fixtures/ivc_consts.json, as in halo_tpu.
"""

from __future__ import annotations

from halo_tpu.acc import Accumulator, _zero_acc_from_fixture, common_subroutine
from halo_tpu.curves import CurveCfg
from halo_tpu.pcdl import Instance

from . import pcdl

_ZERO_ACC: dict = {}


def prover(cfg: CurveCfg, qs: list[Instance], device) -> Accumulator:
    C_bar, d, z, h = common_subroutine(cfg, qs)
    v = h.eval(z)
    pi = pcdl.open_proof(cfg, h.coeffs(), C_bar, d, z, device)
    return Accumulator(q=Instance(C=C_bar, d=d, z=z, v=v, pi=pi))


def decider(cfg: CurveCfg, acc: Accumulator, device) -> None:
    pcdl.check(cfg, acc.q.C, acc.q.d, acc.q.z, acc.q.v, acc.q.pi, device)


def zero_instance(cfg: CurveCfg, n: int, device) -> Instance:
    """Instance::zero: zero polynomial, C = identity, z = v = 0."""
    pi = pcdl.open_without_eval(cfg, [0], None, n - 1, 0, 0, device)
    return Instance(C=None, d=n - 1, z=0, v=0, pi=pi)


def zero_accumulator(cfg: CurveCfg, n: int, device, k: int = 1) -> Accumulator:
    """Accumulator::zero(n, k); deterministic, so cached per (curve, n, k)."""
    key = (cfg.name, n, k)
    if key not in _ZERO_ACC:
        acc = _zero_acc_from_fixture(cfg, n, k)
        if acc is None:
            acc = prover(cfg, [zero_instance(cfg, n, device)] * k, device)
        _ZERO_ACC[key] = acc
    return _ZERO_ACC[key]
