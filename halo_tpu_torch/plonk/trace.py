"""Trace preprocessing on tensors (port of halo_tpu/plonk/trace.py;
reference crates/plonk/src/circuit/trace.rs).

build_sigma forms cycles from the copy-constraint classes (sigma[from] =
to, cycle direction as in trace.rs:83-89); public inputs are negated and
padded before interpolation (trace.rs:162-165).  Interpolation runs as
batched port NTTs that leave Montgomery rows on the device; the prover
reuses them (`dev_polys`, torch tensors keyed as in halo_tpu), and the host
int lists are lazy views that convert only when a host consumer asks.
Without a frozen circuit the q/r/id/sigma commitments are one batched port
MSM; with one (the IVC path) its commitments are taken as they are.

Static-circuit cache: for a frozen circuit, re-proven every IVC step, the
sigma map and the interpolated q/r/id/sigma rows depend only on the
circuit's structure, so they are computed once per (circuit, device) and
kept on the device (halo_tpu/plonk/trace.py:103-121,160-165).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import torch

from .. import acc as acc_mod
from .. import pcdl
from ..acc import Accumulator
from ..curves import Affine, CurveCfg
from ..hostpoly import HostEvals, LazyHostPolys, domain_element, interpolate_evals_batch
from .circuit import TRACE_CURVE, SlotId, TraceData
from .constants import S_POLYS
from .engine import Engine


@dataclass
class PlonkCircuitCommitments:
    qs: list[Affine]
    rs: list[Affine]
    ids: list[Affine]
    sigmas: list[Affine]


@dataclass
class PlonkCircuit:
    rows: int
    public_input_count: int
    omega: int
    Cs: PlonkCircuitCommitments


@dataclass
class PlonkPublicInputs:
    public_inputs: list[int]
    acc_prev: Accumulator


@dataclass
class PlonkWitnessPolys:
    ws: list[list[int]]
    qs: list[list[int]]
    rs: list[list[int]]
    ids: list[list[int]]
    sigmas: list[list[int]]


@dataclass
class PlonkWitness:
    omega: int
    polys: PlonkWitnessPolys
    w_evals: list[HostEvals]
    # Montgomery device rows of `polys` from Trace.new's batched
    # interpolation, keys {"ws", "qs", "rs", "ids", "sigmas", "w_evals"} ->
    # (8, k, n); the prover uses them instead of converting the host lists
    dev_polys: Optional[dict] = None


def build_sigma(m: int, eqs: list[list[SlotId]], rows: int):
    """(sigma slot map, id evals x8, sigma evals x8) (trace.rs:65-105)."""
    total = rows * S_POLYS
    sigma = list(range(total))  # sigma[u] = image slot index (as usize)
    for wires in eqs:
        if len(wires) <= 1:
            continue
        for i in range(len(wires)):
            frm = wires[i].to_usize(rows)
            to = wires[(i + 1) % len(wires)]
            sigma[frm] = to.to_usize(rows)

    # SlotId.from_usize(u).to_scalar() is u + 1
    id_evals = [HostEvals.from_vec_and_domain(m, list(range(col * rows + 1, (col + 1) * rows + 1)))
                for col in range(S_POLYS)]
    sigma_evals = [HostEvals.from_vec_and_domain(m, [u + 1 for u in sigma[col * rows:(col + 1) * rows]])
                   for col in range(S_POLYS)]
    return sigma, id_evals, sigma_evals


TRACE_CACHE_ENTRIES = 4  # each pins (8, 49, n) device rows: ~100 MB at 2^16
_STATIC_TRACE_CACHE: dict = {}  # LRU
_STATIC_TRACE_LOCK = threading.Lock()


def _static_key(cfg: CurveCfg, circuit: PlonkCircuit, device: torch.device):
    cs = circuit.Cs
    return (cfg.name, circuit.rows, str(device),
            tuple(cs.qs), tuple(cs.rs), tuple(cs.ids), tuple(cs.sigmas))


def _static_polys(cfg: CurveCfg, data: TraceData, device, circuit: Optional[PlonkCircuit]):
    """(sigma, (8, n_q + n_r + 2*S_POLYS, n) Montgomery coefficient rows of
    the q, r, id and sigma polys, (n_q, n_r, n_s)), from the cache when the
    circuit is frozen and was seen before."""
    with _STATIC_TRACE_LOCK:
        return _static_polys_locked(cfg, data, device, circuit)


def _static_polys_locked(cfg, data, device, circuit):
    key = _static_key(cfg, circuit, device) if circuit is not None else None
    entry = _STATIC_TRACE_CACHE.pop(key, None) if key is not None else None
    if entry is None:
        m = cfg.r
        sigma, id_evals, sigma_evals = build_sigma(m, data.copy_constraints, data.rows)
        r_evals = [HostEvals.from_vec_and_domain(m, col) for col in data.rs]
        q_evals = [HostEvals.from_vec_and_domain(m, col) for col in data.qs]
        _, static_dev, _ = interpolate_evals_batch(
            q_evals + r_evals + id_evals + sigma_evals, device, want_host=False)
        entry = (sigma, static_dev, (len(q_evals), len(r_evals), len(id_evals)))
    if key is not None:
        _STATIC_TRACE_CACHE[key] = entry  # insert or LRU touch
        while len(_STATIC_TRACE_CACHE) > TRACE_CACHE_ENTRIES:
            _STATIC_TRACE_CACHE.pop(next(iter(_STATIC_TRACE_CACHE)))
    return entry


@dataclass
class Trace:
    cfg: CurveCfg
    rows: int
    omega: int
    outputs: list[int]
    sigma: list[int]
    public_inputs: list[int]
    public_inputs_poly: list[int]
    C_qs: list[Affine]
    C_rs: list[Affine]
    C_ids: list[Affine]
    C_sigmas: list[Affine]
    id_polys: LazyHostPolys
    q_polys: LazyHostPolys
    sigma_polys: LazyHostPolys
    w_evals: list[HostEvals]
    w_polys: LazyHostPolys
    r_polys: LazyHostPolys
    acc_prev: Accumulator
    message_pass_inputs: list[int]
    dev_polys: dict

    @classmethod
    def new(cls, cfg: CurveCfg, data: TraceData, device,
            acc_prev: Optional[Accumulator] = None,
            circuit: Optional[PlonkCircuit] = None) -> "Trace":
        device = torch.device(device)
        eng = Engine(cfg, device)
        m = cfg.r
        n = data.rows
        d = n - 1
        omega = domain_element(m, n, 1)

        sigma, static_dev, (n_q, n_r, n_s) = _static_polys(cfg, data, device, circuit)
        parts = torch.split(static_dev, [n_q, n_r, n_s, n_s], dim=1)

        pi = list(data.public_inputs) + [0] * (n - len(data.public_inputs))
        pi = [(-x) % m for x in pi]
        pi_host, _, _ = interpolate_evals_batch([HostEvals.from_vec_and_domain(m, pi)], device)

        w_evals = [HostEvals.from_vec_and_domain(m, col) for col in data.ws]
        _, w_dev, w_raw_dev = interpolate_evals_batch(w_evals, device, want_host=False)

        dev_polys = {"qs": parts[0], "rs": parts[1], "ids": parts[2], "sigmas": parts[3],
                     "ws": w_dev, "w_evals": w_raw_dev}

        if circuit is not None:
            C_qs, C_rs = circuit.Cs.qs, circuit.Cs.rs
            C_ids, C_sigmas = circuit.Cs.ids, circuit.Cs.sigmas
        else:
            Cs = pcdl.commit_rows(cfg, eng.from_mont(static_dev), d)
            C_qs, C_rs = Cs[:n_q], Cs[n_q:n_q + n_r]
            C_ids, C_sigmas = Cs[n_q + n_r:n_q + n_r + n_s], Cs[n_q + n_r + n_s:]

        if acc_prev is None:
            acc_prev = acc_mod.zero_accumulator(cfg, n, device)

        return cls(
            cfg=cfg, rows=n, omega=omega, outputs=data.outputs, sigma=sigma,
            public_inputs=list(data.public_inputs), public_inputs_poly=pi_host[0],
            C_qs=C_qs, C_rs=C_rs, C_ids=C_ids, C_sigmas=C_sigmas,
            id_polys=LazyHostPolys(eng, parts[2]), q_polys=LazyHostPolys(eng, parts[0]),
            sigma_polys=LazyHostPolys(eng, parts[3]), w_evals=w_evals,
            w_polys=LazyHostPolys(eng, w_dev), r_polys=LazyHostPolys(eng, parts[1]),
            acc_prev=acc_prev, message_pass_inputs=list(data.message_pass_inputs),
            dev_polys=dev_polys,
        )

    def consume(self):
        Cs = PlonkCircuitCommitments(qs=self.C_qs, rs=self.C_rs, ids=self.C_ids,
                                     sigmas=self.C_sigmas)
        circuit = PlonkCircuit(rows=self.rows, public_input_count=len(self.public_inputs),
                               omega=self.omega, Cs=Cs)
        x = PlonkPublicInputs(public_inputs=self.public_inputs, acc_prev=self.acc_prev)
        polys = PlonkWitnessPolys(ws=self.w_polys, qs=self.q_polys, rs=self.r_polys,
                                  ids=self.id_polys, sigmas=self.sigma_polys)
        w = PlonkWitness(omega=self.omega, polys=polys, w_evals=self.w_evals,
                         dev_polys=self.dev_polys)
        return circuit, x, w


def trace_pair(builder, device, accs_prev=None, static_circuits=None):
    """TraceBuilder -> (fp Trace, fq Trace), mirroring trace_builder.rs trace()."""
    fp_data, fq_data = builder.trace()
    fp_acc, fq_acc = accs_prev if accs_prev else (None, None)
    fp_circ, fq_circ = static_circuits if static_circuits else (None, None)
    return (Trace.new(TRACE_CURVE[0], fp_data, device, fp_acc, fp_circ),
            Trace.new(TRACE_CURVE[1], fq_data, device, fq_acc, fq_circ))
