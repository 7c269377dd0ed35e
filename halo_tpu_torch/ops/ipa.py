"""IPA open with the fold on tensors (port of halo_tpu/ops/ipa.py
open_without_eval_device :221-291 and its _round_msms_jit,
_fold_state_jit, _u_msm_jit :75-124).

The SRS points are never folded.  After k-1 rounds each folded point is
a xi-weighted sum of original SRS points (module docstring of
halo_tpu/ops/ipa.py), so round k's L and R are two MSMs over n/2 original
points with derived scalars gw[idx] * c[...], run as one batched MSM
pipeline, and U = MSM(G, gw) after the last round.  The cross dot
products are int64 sums of the u32 words (in place of _exact_sum).  Only
the transcript runs on the host.  The two-open lockstep variant
(open_pair_without_eval_device) is not ported: opening twice gives the
same bytes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..curves import Affine, CurveCfg, ec_add, ec_mul
from ..fields import inv
from ..plonk.engine import Engine
from ..poseidon.sponge import Protocols, Sponge
from . import ff, msm2


@lru_cache(maxsize=64)
def _round_indices(n: int, k: int, device: torch.device):
    """Round k (1-based): original indices of the bit_k = 0 / bit_k = 1
    supports and the cs positions feeding each (halo_tpu _round_indices)."""
    h = n >> k
    j = np.arange(n // 2, dtype=np.int64)
    a, r0 = j // h, j % h
    idxL = a * (2 * h) + r0
    return tuple(torch.from_numpy(x).to(device) for x in (idxL, idxL + h, r0 + h, r0))


def open_without_eval_device(cfg: CurveCfg, p, C: Affine, d: int, z: int, v: int,
                             device) -> EvalProof:
    """Non-hiding IPA open; p is a host coefficient list or an (8, n')
    Montgomery row tensor (n' <= d + 1).  Byte-identical to the host open."""
    from .. import srs
    from ..pcdl import EvalProof

    device = torch.device(device)
    n = d + 1
    lg_n = n.bit_length() - 1
    m = cfg.r
    eng = Engine(cfg, device)
    pp = srs.load_srs(cfg.name, max(4, n), device)
    transcript = Sponge(Protocols.PCDL, cfg)

    transcript.absorb_g([C])
    transcript.absorb_fr([z, v])
    xi_i = transcript.challenge()
    H_prime = ec_mul(cfg, pp.H, xi_i)

    if isinstance(p, torch.Tensor):
        cs = p.to(device)
    else:
        cs = eng.to_dev([c % m for c in p]) if len(p) else eng.zeros(0)
    if cs.shape[-1] < n:
        cs = torch.cat((cs, eng.zeros(n - cs.shape[-1])), -1)

    if n == 1:  # lg(n) = 0: no fold rounds; U = G_0, c = p_0
        return EvalProof(Ls=[], Rs=[], U=pp.g_affine(0), c=eng.to_ints(cs[:, :1])[0],
                         C_bar=None, w_prime=None)

    xy = srs.srs_pack(cfg.name, n, device)
    zs = eng.powers(z, n)
    gw = eng.one().expand(ff.NWORDS, n).contiguous()
    iota = torch.arange(n, device=device)

    Ls: list[Affine] = []
    Rs: list[Affine] = []
    for k in range(1, lg_n + 1):
        h = n >> k
        idxL, idxR, cspL, cspR = _round_indices(n, k, device)
        dot_l, dot_r = eng.exact_sum(torch.stack((
            eng.mul(cs[:, h:2 * h], zs[:, :h]), eng.mul(cs[:, :h], zs[:, h:2 * h])), 1))
        sL = eng.from_mont(eng.mul(gw[:, idxL], cs[:, cspL]))
        sR = eng.from_mont(eng.mul(gw[:, idxR], cs[:, cspR]))
        Lpt, Rpt = msm2.msm_multi(cfg, xy, torch.stack((sL, sR), 1),
                                  pidx=torch.stack((idxL, idxR)))
        L = ec_add(cfg, Lpt, ec_mul(cfg, H_prime, dot_l))
        R = ec_add(cfg, Rpt, ec_mul(cfg, H_prime, dot_r))
        Ls.append(L)
        Rs.append(R)

        transcript.absorb_fr([xi_i])
        transcript.absorb_g([L, R])
        xi_next = transcript.challenge()
        xi_i = xi_next

        # fold c and z at the active prefix; fold xi into the G weights of
        # the points with bit_k set (lanes with (i // h) odd)
        xi_dev = eng.to_dev([xi_next])
        xi_inv_dev = eng.to_dev([inv(xi_next, m)])
        cs = torch.cat((eng.add(cs[:, :h], eng.mul(cs[:, h:2 * h], xi_inv_dev)),
                        cs[:, h:]), -1)
        zs = torch.cat((eng.add(zs[:, :h], eng.mul(zs[:, h:2 * h], xi_dev)),
                        zs[:, h:]), -1)
        bit = ((iota // h) & 1) == 1
        gw = torch.where(bit, eng.mul(gw, xi_dev), gw)

    U = msm2.msm_multi(cfg, xy, eng.from_mont(gw)[:, None])[0]
    c_final = eng.to_ints(cs[:, :1])[0]
    return EvalProof(Ls=Ls, Rs=Rs, U=U, c=c_final, C_bar=None, w_prime=None)
