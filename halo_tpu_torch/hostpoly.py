"""Evaluation vectors and batched NTTs (port of halo_tpu/hostpoly.py:
HostEvals, domain_element, ntt_host_batch / interpolate_evals_batch
:105-166).

HostEvals keeps the reference's Evals quirk that affects bytes: a vector
is stored rotated right by one, so row i of a trace lives at domain
element w^(i+1) (reference crates/group/src/poly.rs:21-31).  The batched
NTTs run every size on the port's NTT and can leave the Montgomery rows on
the device for the prover, as halo_tpu's want_dev=True does.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .curves import PALLAS, VESTA
from .fields import two_adic_root_of_unity
from .plonk.engine import Engine


@lru_cache(maxsize=64)
def _omega(m: int, log_n: int) -> int:
    return two_adic_root_of_unity(m, log_n)


def domain_element(m: int, n: int, i: int) -> int:
    """w^i for w the canonical generator of the size-n domain."""
    return pow(_omega(m, n.bit_length() - 1), i % n, m)


class HostEvals:
    """The reference's Evals: the raw (already rotated) evaluation vector
    over a size-n domain."""

    __slots__ = ("m", "vec")

    def __init__(self, m: int, raw_vec: list[int]):
        self.m = m
        self.vec = raw_vec

    @classmethod
    def from_vec_and_domain(cls, m: int, vec: list[int]) -> "HostEvals":
        return cls(m, [vec[-1]] + vec[:-1])


def _engine(m: int, device) -> Engine:
    """The Engine of whichever Pasta curve has scalar field m."""
    return Engine(PALLAS if PALLAS.r == m else VESTA, device)


def ntt_host_batch(m: int, vecs: list[list[int]], device, inverse: bool = False,
                   want_host: bool = True):
    """k same-length int vectors -> (outs, dev_out, dev_in): the host
    results (None unless want_host), the (8, k, n) Montgomery output rows
    and the (8, k, n) Montgomery input rows, both on `device`."""
    if not vecs:
        return [], None, None
    eng = _engine(m, device)
    a = eng.to_dev_batch(vecs)
    out = eng.intt(a) if inverse else eng.ntt(a)
    outs = None
    if want_host:
        flat = eng.to_ints(out)
        n = a.shape[-1]
        outs = [flat[i * n: (i + 1) * n] for i in range(len(vecs))]
    return outs, out, a


def interpolate_evals_batch(evals: list[HostEvals], device, want_host: bool = True):
    """Batched HostEvals.interpolate over a same-domain group."""
    if not evals:
        return [], None, None
    return ntt_host_batch(evals[0].m, [e.vec for e in evals], device, inverse=True,
                          want_host=want_host)


class LazyHostPolys:
    """List-like view over (8, k, n) Montgomery rows that converts to host
    int lists on first access (port of halo_tpu.plonk.trace.LazyHostPolys)."""

    def __init__(self, eng: Engine, dev: torch.Tensor):
        self._eng = eng
        self._dev = dev
        self._host: list[list[int]] | None = None

    def _materialize(self) -> list[list[int]]:
        if self._host is None:
            flat = self._eng.to_ints(self._dev)
            n = self._dev.shape[-1]
            self._host = [flat[i * n: (i + 1) * n] for i in range(self._dev.shape[1])]
        return self._host

    def __len__(self) -> int:
        return int(self._dev.shape[1])

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())
