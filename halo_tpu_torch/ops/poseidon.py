"""Batched Poseidon permutation (port of halo_tpu/ops/poseidon.py:
_mont_consts, permute_batch, permute_ints).

The kimchi permutation (55 full rounds: x^7 on all three words, the 3x3
MDS, the round constants; reference crates/poseidon/src/inner_sponge.rs)
over N states at once, as the Schnorr batch hashes its messages
(ops/schnorr_batch.py).  A batch of N states is one (3, 8, N) tensor of
canonical Montgomery word rows: state word c of lane i in [c, :, i].

permute_batch launches the CUDA kernel poseidon_permute (csrc/kernels.cu)
for CUDA tensors and runs its plain version, poseidon_permute_plain, for
CPU tensors; there is no fallback.  The TPU ran this as a lax.scan of
ff.mont_mul's jnp contractions, fused by XLA into one dispatch (no
pl.pallas_call); as a torch composition it would be ~1,155 field_mul-sized
launches a permutation, so it is one kernel.
"""

from __future__ import annotations

import torch

from ..device import cached
from ..fields import FP_MOD, FQ_MOD, R256
from ..poseidon.constants import FP_MDS, FP_ROUND_CONSTANTS, FQ_MDS, FQ_ROUND_CONSTANTS
from ..poseidon.sponge import PERM_ROUNDS_FULL
from . import ff, kernels
from .ff import NL, NWORDS

STATE_SIZE = 3
N_CONSTS = STATE_SIZE * STATE_SIZE + STATE_SIZE * PERM_ROUNDS_FULL  # 174


def _params(m: int):
    if m == FQ_MOD:
        return FQ_MDS, FQ_ROUND_CONSTANTS
    if m == FP_MOD:
        return FP_MDS, FP_ROUND_CONSTANTS
    raise ValueError(f"not a Pasta modulus: {m:#x}")


@cached(8)
def mont_consts(m: int, device: torch.device) -> torch.Tensor:
    """The field's constants in Montgomery form as one (174, 8) int32
    tensor on `device`: the MDS row-major (9), then the round constants,
    three a round (165), as the kernel reads them."""
    mds, rcs = _params(m)
    vals = [v for row in mds for v in row] + [v for row in rcs[:PERM_ROUNDS_FULL] for v in row]
    return ff.to_rows([v * R256 % m for v in vals], device).t().contiguous()


def poseidon_permute_plain(m: int, state: torch.Tensor) -> torch.Tensor:
    """The permutation over ff's limb code, vectorised as the reference's
    round_fn (halo_tpu/ops/poseidon.py:67-78): one sbox pass over all 3N
    words, then the MDS as broadcast products, then one canonicalisation
    a round."""
    consts = ff.words_to_limbs(mont_consts(m, state.device).t())  # (10, 174)
    mds = consts[:, :9].reshape(NL, STATE_SIZE, STATE_SIZE, 1)
    rcs = consts[:, 9:].reshape(NL, PERM_ROUNDS_FULL, STATE_SIZE, 1)
    n = state.shape[2]
    x = ff.words_to_limbs(state.permute(1, 0, 2).reshape(NWORDS, STATE_SIZE * n))
    for rnd in range(PERM_ROUNDS_FULL):
        # canonical x: x^2, x^3, x^4 < 1.3m, x^7 < 1.5m (lazy products)
        x2 = ff.lmul(m, x, x)
        x3, x4 = torch.split(ff.lmul(m, torch.cat((x2, x2), 1), torch.cat((x, x2), 1)), x.shape[1], 1)
        x7 = ff.lmul(m, x4, x3).reshape(NL, 1, STATE_SIZE, n)
        # row i: sum_j mds[i][j] x7_j + rc_i < 3 * 1.4m + m
        y = ff.lmul(m, mds, x7).sum(2) + rcs[:, rnd]
        x = ff.canon(m, y.reshape(NL, STATE_SIZE * n))
    return ff.limbs_to_words(x).reshape(NWORDS, STATE_SIZE, n).permute(1, 0, 2).contiguous()


def permute_batch(m: int, state: torch.Tensor) -> torch.Tensor:
    """Permute N states: (3, 8, N) canonical Montgomery word rows over F_m
    -> the permuted (3, 8, N), canonical."""
    if state.dim() != 3 or state.shape[:2] != (STATE_SIZE, NWORDS):
        raise ValueError(f"bad Poseidon state shape {tuple(state.shape)}")
    if state.device.type == "cpu":
        return poseidon_permute_plain(m, state)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    state = state.contiguous()
    consts = mont_consts(m, state.device)
    kernels.check_cuda(state, consts)
    out = torch.empty_like(state)
    kernels.launch("poseidon_permute", out, state, consts, state.shape[2], ff.field_id(m))
    return out


def permute_ints(m: int, states: list[list[int]], device) -> list[list[int]]:
    """Host-facing wrapper: canonical-int states in and out, permuted on
    `device` (Montgomery form on the way, as halo_tpu's permute_ints)."""
    n = len(states)
    flat = ff.to_rows([v * R256 % m for st in states for v in st], device)  # (8, 3n)
    out = permute_batch(m, flat.reshape(NWORDS, n, STATE_SIZE).permute(2, 0, 1))
    rinv = pow(R256, -1, m)
    ints = ff.from_rows(out.permute(1, 2, 0))  # lane-major, then state word
    return [[v * rinv % m for v in ints[i * STATE_SIZE:(i + 1) * STATE_SIZE]] for i in range(n)]
