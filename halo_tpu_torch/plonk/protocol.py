"""PLONK proof format, verifier and prover entry point (port of
halo_tpu/plonk/protocol.py; reference crates/plonk/src/plonk/protocol.rs).

The proof data classes and their byte layout, the dual-use constraint
evaluators (gate_constraints runs over ints here, over device rows in the
prover, and over wires in the in-circuit verifier) and verify_succinct are
host code copied from halo_tpu.  naive_prover runs the tensor prover
(protocol_device.py) on the given device; verify's decider MSM runs on the
device too.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import acc as acc_mod
from .. import pcdl
from ..curves import Affine, CurveCfg, from_jac, jac_add, jac_mul, to_jac
from ..errors import PlonkVerifyError
from ..fields import FP_MOD, inv
from ..poseidon.constants import FP_MDS, FQ_MDS
from ..poseidon.sponge import Protocols, Sponge
from ..serde import Reader, Serde
from .constants import Q_POLYS, R_POLYS, S_POLYS, T_POLYS, W_POLYS
from .trace import PlonkCircuit, PlonkPublicInputs, PlonkWitness

# Byte layout mirrors what arkworks CanonicalSerialize would derive for the
# reference structs (protocol.rs:30-62): fields in declaration order, fixed
# [T; N] arrays as N items with no length prefix, scalars 32 LE bytes,
# points compressed.

@dataclass
class PlonkProofEvals:
    ws: list[int]
    rs: list[int]
    qs: list[int]
    ts: list[int]
    ids: list[int]
    sigmas: list[int]
    z: int
    z_omega: int
    w_omegas: list[int]

    def serialize(self, w, cfg: CurveCfg) -> None:
        for v in (*self.ws, *self.rs, *self.qs, *self.ts, *self.ids,
                  *self.sigmas, self.z, self.z_omega, *self.w_omegas):
            w.field(int(v))

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "PlonkProofEvals":
        m = cfg.r
        return cls(
            ws=[r.field(m) for _ in range(W_POLYS)],
            rs=[r.field(m) for _ in range(R_POLYS)],
            qs=[r.field(m) for _ in range(Q_POLYS)],
            ts=[r.field(m) for _ in range(T_POLYS)],
            ids=[r.field(m) for _ in range(S_POLYS)],
            sigmas=[r.field(m) for _ in range(S_POLYS)],
            z=r.field(m),
            z_omega=r.field(m),
            w_omegas=[r.field(m) for _ in range(3)],
        )


@dataclass
class PlonkProofCommitments:
    ws: list[Affine]
    ts: list[Affine]
    z: Affine

    def serialize(self, w, cfg: CurveCfg) -> None:
        for p in (*self.ws, *self.ts, self.z):
            w.point_compressed(cfg, p)

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "PlonkProofCommitments":
        return cls(
            ws=[r.point_compressed(cfg) for _ in range(W_POLYS)],
            ts=[r.point_compressed(cfg) for _ in range(T_POLYS)],
            z=r.point_compressed(cfg),
        )


@dataclass
class PlonkProofEvalProofs:
    r: pcdl.EvalProof
    r_omega: pcdl.EvalProof

    def serialize(self, w, cfg: CurveCfg) -> None:
        self.r.serialize(w, cfg)
        self.r_omega.serialize(w, cfg)

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "PlonkProofEvalProofs":
        return cls(
            r=pcdl.EvalProof.deserialize(r, cfg),
            r_omega=pcdl.EvalProof.deserialize(r, cfg),
        )


@dataclass
class PlonkProof(Serde):
    vs: PlonkProofEvals
    Cs: PlonkProofCommitments
    pis: PlonkProofEvalProofs
    acc_next: acc_mod.Accumulator

    def serialize(self, w, cfg: CurveCfg) -> None:
        self.vs.serialize(w, cfg)
        self.Cs.serialize(w, cfg)
        self.pis.serialize(w, cfg)
        self.acc_next.serialize(w, cfg)

    @classmethod
    def deserialize(cls, r: Reader, cfg: CurveCfg) -> "PlonkProof":
        return cls(
            vs=PlonkProofEvals.deserialize(r, cfg),
            Cs=PlonkProofCommitments.deserialize(r, cfg),
            pis=PlonkProofEvalProofs.deserialize(r, cfg),
            acc_next=acc_mod.Accumulator.deserialize(r, cfg),
        )


def _scalar_mds(cfg: CurveCfg):
    # MDS over the trace's SCALAR field (protocol.rs uses SCALAR_POSEIDON_MDS)
    return FP_MDS if cfg.r == FP_MOD else FQ_MDS


# ---------------- constraint evaluators (dual-use) ---------------- #
# ops is a namespace providing add/sub/mul/smul/one over plain ints (the
# verifier at xi), device rows (the prover, plonk/protocol_device.py) or
# wires (the in-circuit verifier, frontend/plonk.py), mirroring the
# reference's *_evals / *_generic pairs with one implementation.


class IntOps:
    def __init__(self, m: int):
        self.m = m

    def add(self, a, b):
        return (a + b) % self.m

    def sub(self, a, b):
        return (a - b) % self.m

    def mul(self, a, b):
        return a * b % self.m

    def smul(self, a, s):
        return a * s % self.m

    @property
    def one(self):
        return 1



def poseidon_constraints(o, M, r, w, nw):
    """Gate stream mirrors poseidon_constraints_generic (protocol.rs:623-648)
    exactly for the wire tier: sbox is the left-assoc 6-mul x^7 and is
    RE-evaluated at each of the 3 MDS rows, and the add/sub trees are
    left-associated.  Prover tiers (o.cse truthy, the default) memoize the
    sbox per input to avoid tripling the extended-domain work — value-
    identical, so proofs are unchanged."""
    cache: dict = {}
    cse = getattr(o, "cse", True)

    def sbox(x):
        key = id(x)
        if cse and key in cache:
            return cache[key]
        out = x
        for _ in range(6):
            out = o.mul(out, x)
        cache[key] = out
        return out

    def rnd(w0, w1, w2, w3, w4, w5, r0, r1, r2):
        def row(rc, i):
            # r + sbox(w0)*M[i][0] + sbox(w1)*M[i][1] + sbox(w2)*M[i][2]
            t = o.add(rc, o.smul(sbox(w0), M[i][0]))
            t = o.add(t, o.smul(sbox(w1), M[i][1]))
            return o.add(t, o.smul(sbox(w2), M[i][2]))

        # ((((w3 - X) + w4) - Y) + w5) - Z
        acc = o.sub(w3, row(r0, 0))
        acc = o.sub(o.add(acc, w4), row(r1, 1))
        return o.sub(o.add(acc, w5), row(r2, 2))

    total = rnd(w[0], w[1], w[2], w[3], w[4], w[5], r[0], r[1], r[2])
    total = o.add(total, rnd(w[3], w[4], w[5], w[6], w[7], w[8], r[3], r[4], r[5]))
    total = o.add(total, rnd(w[6], w[7], w[8], w[9], w[10], w[11], r[6], r[7], r[8]))
    total = o.add(total, rnd(w[9], w[10], w[11], w[12], w[13], w[14], r[9], r[10], r[11]))
    total = o.add(total, rnd(w[12], w[13], w[14], nw[0], nw[1], nw[2], r[12], r[13], r[14]))
    return total


def affine_add_constraints(o, w):
    one = o.one
    xp, yp, xq, yq, xr, yr, al, be, ga, de, la = w[:11]

    xq_xp = o.sub(xq, xp)
    yq_yp = o.sub(yq, yp)
    res = o.mul(xq_xp, o.sub(o.mul(xq_xp, la), yq_yp))

    yp2 = o.add(yp, yp)
    xpxp = o.mul(xp, xp)
    xpxp3 = o.add(o.add(xpxp, xpxp), xpxp)
    res = o.add(res, o.mul(o.sub(one, o.mul(xq_xp, al)), o.sub(o.mul(yp2, la), xpxp3)))

    xpxq = o.mul(xp, xq)
    t1 = o.mul(xpxq, o.sub(xq, xp))
    lala = o.mul(la, la)
    t2 = o.sub(o.sub(o.sub(lala, xp), xq), xr)
    res = o.add(res, o.mul(t1, t2))

    t3 = o.sub(o.sub(o.mul(la, o.sub(xp, xr)), yp), yr)
    res = o.add(res, o.mul(t1, t3))

    t4 = o.mul(xpxq, o.add(yq, yp))
    res = o.add(res, o.mul(t4, t2))
    res = o.add(res, o.mul(t4, t3))

    g1 = o.sub(one, o.mul(xp, be))
    res = o.add(res, o.mul(g1, o.sub(xr, xq)))
    res = o.add(res, o.mul(g1, o.sub(yr, yq)))

    g2 = o.sub(one, o.mul(xq, ga))
    res = o.add(res, o.mul(g2, o.sub(xr, xp)))
    res = o.add(res, o.mul(g2, o.sub(yr, yp)))

    g3 = o.sub(o.sub(one, o.mul(o.sub(xq, xp), al)), o.mul(o.add(yq, yp), de))
    res = o.add(res, o.mul(g3, xr))
    res = o.add(res, o.mul(g3, yr))
    return res


def affine_mul_constraints(o, w, nw, two_pow_i):
    """Gate stream mirrors affine_mul_constraints_generic (protocol.rs:763+)
    exactly: the xp/lambda precompute block comes first, cached lambda^2 and
    2xp are reused, (one - xp*beta_q) is recomputed per line like the
    reference, and the final bit-accumulator line is
    (result + bit_acc_next) - (bit_acc + b*2^i)."""
    one = o.one
    xp, yp, a, xg, yg, b, xq, yq, xr, yr, bq, lq, ar, gr, dr, lr = w

    xpxp = o.mul(xp, xp)
    xp2 = o.add(xp, xp)
    lqlq = o.mul(lq, lq)
    xpxp3 = o.add(o.add(xpxp, xpxp), xpxp)
    yp2 = o.add(yp, yp)

    res = o.mul(o.sub(one, o.mul(xp, bq)), xq)
    res = o.add(res, o.mul(o.sub(one, o.mul(xp, bq)), yq))
    res = o.add(res, o.sub(o.mul(yp2, lq), xpxp3))
    res = o.add(res, o.sub(o.sub(lqlq, xp2), xq))
    res = o.add(res, o.sub(o.sub(o.mul(lq, o.sub(xp, xq)), yp), yq))

    # R = Q + G (complete add constraint block with (xq,yq)+(xg,yg)=(xr,yr))
    xg_xq = o.sub(xg, xq)
    yg_yq = o.sub(yg, yq)
    res = o.add(res, o.mul(xg_xq, o.sub(o.mul(xg_xq, lr), yg_yq)))

    yq2 = o.add(yq, yq)
    xqxq = o.mul(xq, xq)
    xqxq3 = o.add(o.add(xqxq, xqxq), xqxq)
    res = o.add(res, o.mul(o.sub(one, o.mul(xg_xq, ar)), o.sub(o.mul(yq2, lr), xqxq3)))

    xqxg = o.mul(xq, xg)
    t1 = o.mul(xqxg, o.sub(xg, xq))
    lala = o.mul(lr, lr)
    t2 = o.sub(o.sub(o.sub(lala, xq), xg), xr)
    res = o.add(res, o.mul(t1, t2))
    t3 = o.sub(o.sub(o.mul(lr, o.sub(xq, xr)), yq), yr)
    res = o.add(res, o.mul(t1, t3))
    t4 = o.mul(xqxg, o.add(yg, yq))
    res = o.add(res, o.mul(t4, t2))
    res = o.add(res, o.mul(t4, t3))

    g1 = o.sub(one, o.mul(xp, bq))  # NOTE: reference uses xp*beta_q here
    res = o.add(res, o.mul(g1, o.sub(xr, xg)))
    res = o.add(res, o.mul(g1, o.sub(yr, yg)))

    g2 = o.sub(one, o.mul(xg, gr))
    res = o.add(res, o.mul(g2, o.sub(xr, xq)))
    res = o.add(res, o.mul(g2, o.sub(yr, yq)))

    g3 = o.sub(o.sub(one, o.mul(o.sub(xg, xq), ar)), o.mul(o.add(yg, yq), dr))
    res = o.add(res, o.mul(g3, xr))
    res = o.add(res, o.mul(g3, yr))

    res = o.add(res, o.mul(b, o.sub(b, one)))

    xs, ys, bit_acc_next = nw
    res = o.add(res, o.sub(xs, o.add(o.mul(b, xr), o.mul(o.sub(one, b), xq))))
    res = o.add(res, o.sub(ys, o.add(o.mul(b, yr), o.mul(o.sub(one, b), yq))))
    # (result + bit_acc_next) - (bit_acc + b * two_pow_i)
    return o.sub(o.add(res, bit_acc_next), o.add(a, o.mul(b, two_pow_i)))


def range_check_constraints(o, w, nw, r):
    res = nw[0]
    res = o.sub(res, w[0])
    for i in range(R_POLYS):
        res = o.sub(res, o.mul(w[i + 1], r[i]))
    return res


def eq_constraints(o, w):
    """eq_generic (protocol.rs): result = (a-b)*eq; result += (a-b)*inv + eq - one
    — note the reference adds eq BEFORE subtracting one."""
    a, b, one_w, eq, invv = w[:5]
    res = o.mul(o.sub(a, b), eq)
    res = o.add(res, o.sub(o.add(o.mul(o.sub(a, b), invv), eq), one_w))
    return res


def gate_constraints(o, qs, ws, rs, nws, pi_term, mds):
    """f_gc = sum of selector-weighted constraint terms + PI (protocol.rs:183-193).

    Gate-order parity with the reference's in-circuit expression
    (frontend/plonk/mod.rs:512-529): constraint terms first (poseidon,
    affine-add, affine-mul, eq, range-check), then the sum built with the
    reference's exact operand order, with the PI term evaluated LAST (pass a
    0-arg callable for pi_term to defer its wire creation)."""
    pos = poseidon_constraints(o, mds, rs, ws, nws)
    aadd = affine_add_constraints(o, ws)
    amul = affine_mul_constraints(o, ws, nws, rs[0])
    eqc = eq_constraints(o, ws)
    rc = range_check_constraints(o, ws, nws, rs)
    f_gc = o.mul(ws[0], qs[0])
    f_gc = o.add(f_gc, o.mul(ws[1], qs[1]))
    f_gc = o.add(f_gc, o.mul(ws[2], qs[2]))
    f_gc = o.add(f_gc, o.mul(o.mul(ws[0], ws[1]), qs[3]))
    f_gc = o.add(f_gc, qs[4])
    f_gc = o.add(f_gc, o.mul(qs[5], pos))
    f_gc = o.add(f_gc, o.mul(qs[6], aadd))
    f_gc = o.add(f_gc, o.mul(qs[7], amul))
    f_gc = o.add(f_gc, o.mul(qs[8], eqc))
    f_gc = o.add(f_gc, o.mul(qs[9], rc))
    f_gc = o.add(f_gc, pi_term() if callable(pi_term) else pi_term)
    return f_gc


def pow_n(m: int, x: int, n: int) -> int:
    for _ in range(n.bit_length() - 1):
        x = x * x % m
    return x


def public_input_eval(m: int, public_inputs, n_scalar, omega, xi, xi_n):
    omega_j = omega
    total = 0
    for x in public_inputs:
        l_j = (xi_n - 1) * omega_j % m * inv(n_scalar * (xi - omega_j) % m, m) % m
        total = (total + l_j * (-x)) % m
        omega_j = omega_j * omega % m
    return total


# ---------------- prover ---------------- #


def naive_prover(cfg: CurveCfg, circuit: PlonkCircuit, x: PlonkPublicInputs,
                 w: PlonkWitness, device, mesh=None) -> PlonkProof:
    """The proof on `device`; `mesh` (parallel/mesh.py Mesh) shards the
    engine's NTTs and commitments over its devices."""
    from .protocol_device import naive_prover_device

    return naive_prover_device(cfg, circuit, x, w, device, mesh)


# ---------------- verifier ---------------- #


def verify_succinct(
    cfg: CurveCfg, proof: PlonkProof, circuit: PlonkCircuit, public_inputs: PlonkPublicInputs
) -> None:
    m = cfg.r
    n = circuit.rows
    d = n - 1
    pi = proof
    transcript = Sponge(Protocols.PLONK, cfg)
    mds = _scalar_mds(cfg)

    if len(public_inputs.public_inputs) != circuit.public_input_count:
        raise PlonkVerifyError("public input count mismatch")

    transcript.absorb_g(pi.Cs.ws)
    beta = transcript.challenge()
    gamma = transcript.challenge()
    transcript.absorb_g([pi.Cs.z])
    alpha = transcript.challenge()
    transcript.absorb_g(pi.Cs.ts)
    zeta = transcript.challenge()
    xi = transcript.challenge()

    xi_n = pow_n(m, xi, n)
    xi_omega = xi * circuit.omega % m

    f_prime = (pi.vs.ws[0] + beta * pi.vs.ids[0] + gamma) % m
    g_prime = (pi.vs.ws[0] + beta * pi.vs.sigmas[0] + gamma) % m
    for i in range(1, S_POLYS):
        f_prime = f_prime * ((pi.vs.ws[i] + beta * pi.vs.ids[i] + gamma) % m) % m
        g_prime = g_prime * ((pi.vs.ws[i] + beta * pi.vs.sigmas[i] + gamma) % m) % m

    o = IntOps(m)
    n_scalar = n % m
    pi_term = public_input_eval(
        m, public_inputs.public_inputs, n_scalar, circuit.omega, xi, xi_n
    )
    f_gc = gate_constraints(o, pi.vs.qs, pi.vs.ws, pi.vs.rs, pi.vs.w_omegas, pi_term, mds)

    omega = circuit.omega
    l1 = omega * (xi_n - 1) % m * inv(n_scalar * (xi - omega) % m, m) % m
    z_H = (xi_n - 1) % m
    f_cc1 = l1 * (pi.vs.z - 1) % m
    f_cc2 = (pi.vs.z * f_prime - pi.vs.z_omega * g_prime) % m

    f = (f_gc + alpha * f_cc1 + alpha * alpha % m * f_cc2) % m

    t = pi.vs.ts[0]
    accp = xi_n
    for i in range(1, T_POLYS):
        t = (t + accp * pi.vs.ts[i]) % m
        accp = accp * xi_n % m

    if f != t * z_H % m:
        raise PlonkVerifyError("PLONK check failed: f(xi) != t(xi) * z_H(xi)")

    def geo_scalar(items):
        result = items[0]
        accum = zeta
        for it in items[1:]:
            result = (result + it * accum) % m
            accum = accum * zeta % m
        return result

    def geo_points(items):
        result = to_jac(items[0])
        accum = zeta
        for it in items[1:]:
            result = jac_add(cfg, result, jac_mul(cfg, to_jac(it), accum))
            accum = accum * zeta % m
        return from_jac(cfg, result)

    v_r = geo_scalar(list(pi.vs.qs) + list(pi.vs.ws) + list(pi.vs.ts) + [pi.vs.z])
    v_r_omega = geo_scalar(list(pi.vs.w_omegas) + [pi.vs.z_omega])
    C_r = geo_points(list(circuit.Cs.qs) + list(pi.Cs.ws) + list(pi.Cs.ts) + [pi.Cs.z])
    C_r_omega = geo_points(list(pi.Cs.ws[0:3]) + [pi.Cs.z])

    instance_1 = pcdl.Instance(C=C_r, d=d, z=xi, v=v_r, pi=pi.pis.r)
    instance_2 = pcdl.Instance(C=C_r_omega, d=d, z=xi_omega, v=v_r_omega, pi=pi.pis.r_omega)

    qs = [public_inputs.acc_prev.q, instance_1, instance_2]
    acc_mod.verifier(cfg, qs, pi.acc_next)


def verify(cfg: CurveCfg, proof: PlonkProof, circuit: PlonkCircuit,
           public_inputs: PlonkPublicInputs, device) -> None:
    """Raises PlonkVerifyError / AccumulationError / PcdlCheckError."""
    verify_succinct(cfg, proof, circuit, public_inputs)
    acc_mod.decider(cfg, proof.acc_next, device)
