"""IPA opens with the fold on tensors (port of halo_tpu/ops/ipa.py
open_without_eval_device :221-291 and open_pair_without_eval_device
:294-413, with their _round_msms_jit, _fold_state_jit, _u_msm_jit :75-124
and pair forms :128-183).

The SRS points are never folded.  After k-1 rounds each folded point is
a xi-weighted sum of original SRS points (module docstring of
halo_tpu/ops/ipa.py), so round k's L and R are two MSMs over n/2 original
points with derived scalars gw[idx] * c[...], and U = MSM(G, gw) after
the last round.  The cross dot products are int64 sums of the u32 words
(in place of _exact_sum).  Only the transcripts run on the host.

Several opens of one size run in lockstep (_open_lockstep): each round
makes one batched MSM pipeline call for the L and R of every open
(msm2.msm_multi over the compact index supports of _round_indices; the
reference's pair form masks full-length scalars instead, which gives the
same group elements), one pull of every open's two dot products, and one
copy of every open's xi and xi^-1 to the card, already in Montgomery
form.  Each open's c, z and G-weights stay its own tensors and fold with
their own field_add/field_mul launches.  The opens' transcripts are
independent, so each proof is the one a single open makes.

The hiding open (open_hiding_device; halo_tpu/pcdl.py:247-267, which
runs it on the host) blinds p on the device: p_bar = (X - z) * q for q
drawn on the host, C_bar = MSM(p_bar) + w_bar*S, p' = p + a*p_bar, then
runs the same rounds over (p', C') on the transcript that drew a.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import Affine, CurveCfg, ec_add, ec_mul
from ..device import cached
from ..fields import inv
from ..plonk.engine import Engine
from ..poseidon.sponge import Protocols, Sponge
from ..utils.timing import RoundTimer
from . import ff, msm2


@cached(64)
def _round_indices(n: int, k: int, device: torch.device):
    """Round k (1-based): original indices of the bit_k = 0 / bit_k = 1
    supports and the cs positions feeding each (halo_tpu _round_indices)."""
    h = n >> k
    j = np.arange(n // 2, dtype=np.int64)
    a, r0 = j // h, j % h
    idxL = a * (2 * h) + r0
    return tuple(torch.from_numpy(x).to(device) for x in (idxL, idxL + h, r0 + h, r0))


def _coeff_rows(eng: Engine, p, n: int) -> torch.Tensor:
    """A host coefficient list or an (8, n') Montgomery row tensor, as
    (8, n) rows zero-padded to n."""
    if isinstance(p, torch.Tensor):
        cs = p.to(eng.device)
    else:
        cs = eng.to_dev([c % eng.m for c in p]) if len(p) else eng.zeros(0)
    if cs.shape[-1] < n:
        cs = torch.cat((cs, eng.zeros(n - cs.shape[-1])), -1)
    return cs


def _open_lockstep(cfg: CurveCfg, opens: list, d: int, device, sponges: list | None = None) -> list:
    """IPA opens of (p, C, z, v) each, all of degree bound d, folded in
    lockstep; byte-identical to opening each alone.  sponges[o], where
    given, is open o's transcript so far (a hiding open's), which C, z
    and v continue; otherwise a fresh PCDL sponge."""
    from .. import srs
    from ..pcdl import EvalProof

    device = torch.device(device)
    n = d + 1
    lg_n = n.bit_length() - 1
    m = cfg.r
    eng = Engine(cfg, device)
    pp = srs.load_srs(cfg.name, max(4, n), device)

    transcripts, xis, H_primes = [], [], []
    for (_, C, z, v), t in zip(opens, sponges or [None] * len(opens)):
        t = Sponge(Protocols.PCDL, cfg) if t is None else t
        t.absorb_g([C])
        t.absorb_fr([z, v])
        xis.append(t.challenge())
        transcripts.append(t)
        H_primes.append(ec_mul(cfg, pp.H, xis[-1]))
    cs = [_coeff_rows(eng, p, n) for p, _, _, _ in opens]

    if n == 1:  # lg(n) = 0: no fold rounds; U = G_0, c = p_0
        c0 = eng.to_ints(torch.cat([c[:, :1] for c in cs], -1))
        return [EvalProof(Ls=[], Rs=[], U=pp.g_affine(0), c=c, C_bar=None, w_prime=None)
                for c in c0]

    xy = srs.srs_pack(cfg.name, n, device)
    zs = [eng.powers(z, n) for _, _, z, _ in opens]
    gw = [eng.one().expand(ff.NWORDS, n).contiguous() for _ in opens]
    iota = torch.arange(n, device=device)

    Ls: list[list[Affine]] = [[] for _ in opens]
    Rs: list[list[Affine]] = [[] for _ in opens]
    for k in range(1, lg_n + 1):
        h = n >> k
        idxL, idxR, cspL, cspR = _round_indices(n, k, device)
        # every open's two cross dots in one pull, and its L and R scalars
        # in one batched MSM: (dot_l, dot_r) and (L, R) per open, in order
        dots = eng.exact_sum(torch.stack([
            eng.mul(x, y) for c, z in zip(cs, zs)
            for x, y in ((c[:, h:2 * h], z[:, :h]), (c[:, :h], z[:, h:2 * h]))], 1))
        K = eng.from_mont(eng.mul(
            torch.stack([g[:, i] for g in gw for i in (idxL, idxR)], 1),
            torch.stack([c[:, i] for c in cs for i in (cspL, cspR)], 1)))
        pts = msm2.msm_multi(cfg, xy, K, pidx=torch.stack([idxL, idxR] * len(opens)))

        for o, t in enumerate(transcripts):
            L = ec_add(cfg, pts[2 * o], ec_mul(cfg, H_primes[o], dots[2 * o]))
            R = ec_add(cfg, pts[2 * o + 1], ec_mul(cfg, H_primes[o], dots[2 * o + 1]))
            Ls[o].append(L)
            Rs[o].append(R)
            t.absorb_fr([xis[o]])
            t.absorb_g([L, R])
            xis[o] = t.challenge()

        # fold c and z at the active prefix; fold xi into the G weights of
        # the points with bit_k set (lanes with (i // h) odd)
        consts = eng.consts([v for xi in xis for v in (xi, inv(xi, m))])
        bit = ((iota // h) & 1) == 1
        for o in range(len(opens)):
            xi_dev, xi_inv_dev = consts[2 * o], consts[2 * o + 1]
            cs[o] = torch.cat((eng.add(cs[o][:, :h], eng.mul(cs[o][:, h:2 * h], xi_inv_dev)),
                               cs[o][:, h:]), -1)
            zs[o] = torch.cat((eng.add(zs[o][:, :h], eng.mul(zs[o][:, h:2 * h], xi_dev)),
                               zs[o][:, h:]), -1)
            gw[o] = torch.where(bit, eng.mul(gw[o], xi_dev), gw[o])

    Us = msm2.msm_multi(cfg, xy, eng.from_mont(torch.stack(gw, 1)))
    c_final = eng.to_ints(torch.cat([c[:, :1] for c in cs], -1))
    return [EvalProof(Ls=Ls[o], Rs=Rs[o], U=Us[o], c=c_final[o], C_bar=None, w_prime=None)
            for o in range(len(opens))]


def open_without_eval_device(cfg: CurveCfg, p, C: Affine, d: int, z: int, v: int,
                             device) -> EvalProof:
    """Non-hiding IPA open; p is a host coefficient list or an (8, n')
    Montgomery row tensor (n' <= d + 1).  Byte-identical to the host open."""
    return _open_lockstep(cfg, [(p, C, z, v)], d, device)[0]


def open_pair_without_eval_device(cfg: CurveCfg, opens: list, d: int, device) -> list:
    """Two non-hiding IPA opens in lockstep (the PLONK prover's round 5:
    r at xi and r_omega at xi * omega).  opens: [(p, C, z, v), (p, C, z,
    v)], each p a host coefficient list or an (8, n') Montgomery row
    tensor.  Returns the two EvalProofs, byte-identical to two
    open_without_eval_device calls."""
    if len(opens) != 2:
        raise ValueError(f"a pair open takes two opens, got {len(opens)}")
    return _open_lockstep(cfg, opens, d, device)


def open_hiding_device(cfg: CurveCfg, p, C: Affine, d: int, z: int, v: int, w: int, rng,
                       device) -> EvalProof:
    """Hiding IPA open of p (a host coefficient list or an (8, n')
    Montgomery row tensor, n' <= d + 1) committed as C with blinding
    factor w.  rng draws q's d coefficients, then w_bar (halo_tpu/pcdl.py
    :251, :256): the same draws give the reference's proof byte for byte.
    Its RoundTimer phases: hiding.draws (host), hiding.pack (q to the
    device), hiding.blind (p_bar, C_bar, a, p', C'), hiding.rounds."""
    from ..pcdl import blind

    device = torch.device(device)
    n = d + 1
    m = cfg.r
    eng = Engine(cfg, device)
    timer = RoundTimer(f"pcdl.open_hiding[{cfg.name}, n={n}, {device}]")
    q = [rng.randrange(m) for _ in range(d)]
    w_bar = rng.randrange(m)
    timer.mark("hiding.draws")
    q_rows = eng.to_dev(q)
    timer.mark("hiding.pack")

    # p_bar = (X - z) q: p_bar_0 = -z q_0, p_bar_i = q_{i-1} - z q_i, p_bar_d = q_{d-1}
    zero = eng.zeros(1)
    p_bar = eng.sub(torch.cat((zero, q_rows), -1),
                    eng.mul(torch.cat((q_rows, zero), -1), eng.const(z)))
    C_bar = blind(cfg, eng.commit(p_bar, d), w_bar)
    t = Sponge(Protocols.PCDL, cfg)
    t.absorb_g([C, C_bar])
    t.absorb_fr([z, v])
    a = t.challenge()
    p_prime = eng.add(_coeff_rows(eng, p, n), eng.mul(p_bar, eng.const(a)))
    w_prime = (w_bar * a + w) % m
    C_prime = blind(cfg, ec_add(cfg, C, ec_mul(cfg, C_bar, a)), (m - w_prime) % m)
    timer.mark("hiding.blind")

    pi = _open_lockstep(cfg, [(p_prime, C_prime, z, v)], d, device, [t])[0]
    timer.mark("hiding.rounds")
    pi.C_bar, pi.w_prime = C_bar, w_prime
    return pi
