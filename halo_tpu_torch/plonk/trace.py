"""Trace preprocessing on tensors (port of halo_tpu/plonk/trace.py
Trace.new / consume / trace_pair :189-334).

The copy-constraint permutation (build_sigma) and the public-input and
witness data classes are halo_tpu's.  Interpolation runs as batched port
NTTs that leave Montgomery rows on the device; the prover reuses them
(`dev_polys`, torch tensors keyed as in halo_tpu), and the host int lists
are lazy views that convert only when a host consumer asks.  Without a
frozen circuit the q/r/id/sigma commitments are one batched port MSM.
The static-circuit cache of halo_tpu (an IVC optimisation) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from halo_tpu.acc import Accumulator
from halo_tpu.curves import Affine, CurveCfg
from halo_tpu.hostpoly import HostEvals, domain_element
from halo_tpu.plonk.circuit import TRACE_CURVE, TraceData
from halo_tpu.plonk.trace import (
    PlonkCircuit,
    PlonkCircuitCommitments,
    PlonkPublicInputs,
    PlonkWitness,
    PlonkWitnessPolys,
    build_sigma,
)

from .. import acc as acc_mod
from .. import pcdl
from ..hostpoly import LazyHostPolys, interpolate_evals_batch
from .engine import Engine


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

        sigma, id_evals, sigma_evals = build_sigma(m, data.copy_constraints, n)
        r_evals = [HostEvals.from_vec_and_domain(m, col) for col in data.rs]
        q_evals = [HostEvals.from_vec_and_domain(m, col) for col in data.qs]
        n_q, n_r, n_s = len(q_evals), len(r_evals), len(id_evals)
        _, static_dev, _ = interpolate_evals_batch(
            q_evals + r_evals + id_evals + sigma_evals, device, want_host=False)
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
