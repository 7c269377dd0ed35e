"""PLONK prover on tensors (port of halo_tpu/plonk/protocol_device.py
naive_prover_device :64-292).

The same 6-round protocol as halo_tpu.plonk.protocol.naive_prover, with
the bulk math in the port's Engine: extended-domain NTTs, the shared
gate_constraints over (8, 8n) rows, the f'/g' products, the grand
product, the quotient, batched commitments and the IPA opens.  The host
keeps the Poseidon transcript and the challenge scalars.  Deterministic
(non-hiding), so the proof bytes equal the host prover's.  Round 5
commits to r and r_omega in one batched MSM, evaluates both with one
pull and opens them in lockstep (ops/ipa.py open_pair_without_eval_device,
halo_tpu's pair branch :224-246), on every device.
"""

from __future__ import annotations

import torch

from .. import acc as acc_mod
from ..curves import CurveCfg
from ..ops import ipa
from ..parallel.mesh import Mesh
from ..pcdl import Instance
from ..poseidon.sponge import Protocols, Sponge
from ..utils.timing import RoundTimer
from .constants import (
    CONSTRAINT_DEGREE_MULTIPLIER,
    Q_POLYS,
    R_POLYS,
    S_POLYS,
    T_POLYS,
    W_POLYS,
)
from .engine import Engine
from .protocol import (
    PlonkProof,
    PlonkProofCommitments,
    PlonkProofEvalProofs,
    PlonkProofEvals,
    _scalar_mds,
    gate_constraints,
)
from .trace import PlonkCircuit, PlonkPublicInputs, PlonkWitness


class DevOps:
    """gate_constraints ops-adapter over (8, N) Montgomery rows."""

    def __init__(self, eng: Engine):
        self.eng = eng

    def add(self, a, b):
        return self.eng.add(a, b)

    def sub(self, a, b):
        return self.eng.sub(a, b)

    def mul(self, a, b):
        return self.eng.mul(a, b)

    def smul(self, a, s: int):
        return self.eng.scale(a, s)

    @property
    def one(self):
        return self.eng.one()


def _roll(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.roll(x, k, dims=-1)


def naive_prover_device(cfg: CurveCfg, circuit: PlonkCircuit, public_inputs: PlonkPublicInputs,
                        witness: PlonkWitness, device, mesh: Mesh | None = None) -> PlonkProof:
    """The proof on `device`; with a mesh, the engine's NTTs and
    commitments run sharded over it (plonk/engine.py), with the same
    bytes."""
    device = torch.device(device)
    timer = RoundTimer(f"plonk.prover_torch[{cfg.name}, n={circuit.rows}, {device}]")
    eng = Engine(cfg, device, mesh)
    m = cfg.r
    n = circuit.rows
    d = n - 1
    big_n = n * CONSTRAINT_DEGREE_MULTIPLIER
    huge_n = 2 * big_n  # 16n, for f_cc2 / quotient
    transcript = Sponge(Protocols.PLONK, cfg)
    mds = _scalar_mds(cfg)
    polys = witness.polys

    # ---- conversions: reuse the trace's device mirrors where present ----
    dp = witness.dev_polys or {}

    def _dev(key, host_cols):
        cached = dp.get(key)
        return cached.to(device) if cached is not None else eng.to_dev_batch(host_cols)

    qs_dev = _dev("qs", polys.qs)
    ws_dev = _dev("ws", polys.ws)
    rs_dev = _dev("rs", polys.rs)
    ids_dev = _dev("ids", polys.ids)
    sigmas_dev = _dev("sigmas", polys.sigmas)
    w_raw = _dev("w_evals", [e.vec for e in witness.w_evals])  # rotated eval vecs

    # ---- Round 0 ----
    pi_vals = list(public_inputs.public_inputs) + [0] * (n - len(public_inputs.public_inputs))
    pi_vals = [(-x) % m for x in pi_vals]
    pi_raw = _roll(eng.to_dev(pi_vals), 1)  # from_vec_and_domain rotation
    pi_poly = eng.intt(pi_raw)

    w_omega_polys = eng.intt(_roll(w_raw[:, :3], -1))  # (8, 3, n)

    q_big = eng.ntt_extended(qs_dev, big_n)
    w_big = eng.ntt_extended(ws_dev, big_n)
    r_big = eng.ntt_extended(rs_dev, big_n)
    nw_big = _roll(w_big[:, :3], -CONSTRAINT_DEGREE_MULTIPLIER)
    pi_big = eng.ntt_extended(pi_poly, big_n)

    # ---- Round 1 ----
    C_ws = eng.commit_batch(ws_dev, d)
    transcript.absorb_g(C_ws)
    timer.mark("round0+1.extend+commit_ws")

    # ---- Round 3 ----
    beta = transcript.challenge()
    gamma = transcript.challenge()
    beta_dev, gamma_dev = eng.consts([beta, gamma])

    ids_big = eng.ntt_extended(ids_dev, big_n)
    sigmas_big = eng.ntt_extended(sigmas_dev, big_n)

    def prod_factors(perm_big):
        factors = eng.add(eng.add(w_big[:, :S_POLYS], eng.mul(perm_big, beta_dev)), gamma_dev)
        out = factors[:, 0]
        for i in range(1, S_POLYS):
            out = eng.mul(out, factors[:, i])
        return out  # (8, 8n) evals of the degree-8(n-1) product

    f_prime_big = prod_factors(ids_big)
    g_prime_big = prod_factors(sigmas_big)
    del ids_big, sigmas_big
    f_prime_poly = eng.intt(f_prime_big)
    g_prime_poly = eng.intt(g_prime_big)

    # n-domain values = stride-8 subsample of the 8n-domain evals
    stride = CONSTRAINT_DEGREE_MULTIPLIER
    f_prime_n = f_prime_big[:, ::stride]
    g_prime_n = g_prime_big[:, ::stride].contiguous()
    ratios = eng.mul(f_prime_n, eng.batch_inv(g_prime_n))
    del f_prime_big, g_prime_big
    z_evals = eng.grand_product(ratios)  # natural order, z[i] @ w^i
    z_raw = _roll(z_evals, 1)
    z_poly = eng.intt(z_raw)
    z_omega_poly = eng.intt(_roll(z_raw, -1))

    C_z = eng.commit(z_poly, d)
    transcript.absorb_g([C_z])
    timer.mark("round3.grand_product")

    # ---- Round 4 ----
    alpha = transcript.challenge()

    o = DevOps(eng)
    f_gc_big = gate_constraints(
        o, list(q_big.unbind(1)), list(w_big.unbind(1)), list(r_big.unbind(1)),
        list(nw_big.unbind(1)), pi_big, mds)
    del q_big, w_big, r_big, nw_big, pi_big
    f_gc_poly = eng.intt(f_gc_big)  # (8, 8n) coeffs
    del f_gc_big

    one = eng.one()
    l1_raw = eng.zeros(n)
    l1_raw[:, 1:2] = one
    l1_poly = eng.intt(l1_raw)
    z_minus_one = torch.cat((eng.sub(z_poly[:, :1], one), z_poly[:, 1:]), -1)
    two_n = 2 * n
    f_cc1_big = eng.mul(eng.ntt_extended(l1_poly, two_n), eng.ntt_extended(z_minus_one, two_n))
    f_cc1_poly = eng.intt(f_cc1_big)  # (8, 2n)

    z_huge = eng.ntt_extended(z_poly, huge_n)
    zw_huge = eng.ntt_extended(z_omega_poly, huge_n)
    fp_huge = eng.ntt_extended(f_prime_poly, huge_n)
    gp_huge = eng.ntt_extended(g_prime_poly, huge_n)
    f_cc2_big = eng.sub(eng.mul(z_huge, fp_huge), eng.mul(zw_huge, gp_huge))
    del z_huge, zw_huge, fp_huge, gp_huge
    f_cc2_poly = eng.intt(f_cc2_big)  # (8, 16n)
    del f_cc2_big

    def pad_to(x, size):
        return torch.cat((x, eng.zeros(size - x.shape[-1])), -1)

    alpha2 = alpha * alpha % m
    f_poly = eng.add(
        pad_to(f_gc_poly, huge_n),
        eng.add(eng.scale(pad_to(f_cc1_poly, huge_n), alpha), eng.scale(f_cc2_poly, alpha2)),
    )
    t_poly = eng.divide_by_vanishing(f_poly, n)  # (8, 15n)
    ts_dev = pad_to(t_poly, T_POLYS * n).reshape(8, T_POLYS, n)
    C_ts = eng.commit_batch(ts_dev, d)
    transcript.absorb_g(C_ts)
    timer.mark("round4.quotient")

    # ---- Round 5 ----
    zeta = transcript.challenge()

    def geometric_dev(stack):  # list of (8, n) -> sum_i zeta^i stack[i], (8, n)
        zpows = [zeta]
        while len(zpows) < len(stack) - 1:
            zpows.append(zpows[-1] * zeta % m)
        zdev = eng.consts(zpows)  # one copy for all of the combination's powers
        out = stack[0]
        for p, zp in zip(stack[1:], zdev):
            out = eng.add(out, eng.mul(p, zp))
        return out

    r_dev = geometric_dev(list(qs_dev.unbind(1)) + list(ws_dev.unbind(1))
                          + list(ts_dev.unbind(1)) + [z_poly])
    r_omega_dev = geometric_dev(list(ws_dev[:, 0:3].unbind(1)) + [z_poly])

    xi = transcript.challenge()
    acc_prev = public_inputs.acc_prev
    z_r = xi
    z_rw = xi * witness.omega % m

    pair = torch.stack((r_dev, r_omega_dev), 1)
    C_r, C_rw = eng.commit_batch(pair, d)
    v_r, v_rw = eng.eval_batch(pair, [z_r, z_rw])
    pi_r, pi_rw = ipa.open_pair_without_eval_device(
        cfg, [(r_dev, C_r, z_r, v_r), (r_omega_dev, C_rw, z_rw, v_rw)], d, device)
    q_r = Instance(C=C_r, d=d, z=z_r, v=v_r, pi=pi_r)
    q_r_omega = Instance(C=C_rw, d=d, z=z_rw, v=v_rw, pi=pi_rw)

    acc_next = acc_mod.prover(cfg, [acc_prev.q, q_r, q_r_omega], device)
    timer.mark("round5.open+accumulate")

    # ---- final evaluations (batched) ----
    all_polys = torch.cat((ws_dev, rs_dev, qs_dev, ts_dev, ids_dev, sigmas_dev,
                           z_poly[:, None], w_omega_polys), 1)
    evals = eng.eval_batch(all_polys, xi)
    i = 0
    ws_e = evals[i:i + W_POLYS]; i += W_POLYS
    rs_e = evals[i:i + R_POLYS]; i += R_POLYS
    qs_e = evals[i:i + Q_POLYS]; i += Q_POLYS
    ts_e = evals[i:i + T_POLYS]; i += T_POLYS
    ids_e = evals[i:i + S_POLYS]; i += S_POLYS
    sigmas_e = evals[i:i + S_POLYS]; i += S_POLYS
    z_e = evals[i]; i += 1
    w_omegas_e = evals[i:i + 3]
    z_omega_e = eng.eval_batch(z_poly, xi * witness.omega % m)[0]

    vs = PlonkProofEvals(ws=ws_e, rs=rs_e, qs=qs_e, ts=ts_e, ids=ids_e, sigmas=sigmas_e,
                         z=z_e, z_omega=z_omega_e, w_omegas=w_omegas_e)
    timer.mark("round5.evals")
    timer.report()
    return PlonkProof(
        vs=vs,
        Cs=PlonkProofCommitments(ws=C_ws, ts=C_ts, z=C_z),
        pis=PlonkProofEvalProofs(r=q_r.pi, r_omega=q_r_omega.pi),
        acc_next=acc_next,
    )
