"""Polynomial engine on tensors (port of halo_tpu/plonk/engine.py).

Polynomials are canonical Montgomery word rows: one polynomial of n
coefficients or evaluations is (8, n); a batch of k is (8, k, n).  The
NTTs run on the ntt_pass kernel, every product on field_mul (on CUDA
at every size: the JAX engine's 2^15-lane threshold for its rows kernel
was a TPU compile-memory workaround), add/sub on the field_add and
field_sub kernels (no host read: the JAX engine's add_jit/sub_jit
fusions), the grand product and batch inverse are Hillis-Steele scans
over field_mul with one host inversion (mont.scan_mul, mont.batch_inv),
and commitments are batched SRS MSMs (ops/msm2.py).  Host constants go
to the card already in Montgomery form (consts): one copy for a batch of
them, and none for a constant the engine has sent before.

With a mesh (parallel/mesh.py), the NTTs of a size the 4-step split
takes (_mesh_ntt_ok) run as parallel/ntt.py's distributed NTT and the
commitments as parallel/msm.py's sharded MSM; their results come back to
`device`, where everything else stays (halo_tpu/plonk/engine.py:37-96,
:200-223).  The proof bytes are the same either way.
"""

from __future__ import annotations

import torch

from ..curves import CurveCfg
from ..fields import R256
from ..ops import ff, msm2, mont, ntt
from ..parallel import msm as pmsm
from ..parallel import ntt as pntt
from ..parallel.mesh import Mesh, gather


def _powers(m: int, x: int, n: int) -> list[int]:
    out = [0] * n
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = cur * x % m
    return out


class Engine:
    def __init__(self, cfg: CurveCfg, device, mesh: Mesh | None = None):
        self.cfg = cfg
        self.m = cfg.r  # scalar modulus
        self.device = torch.device(device)
        self.mesh = mesh
        self._one = ff.mont_one(self.m, self.device)
        self._r2 = ff.const_rows(R256 * R256 % self.m, self.device)
        self._unit = ff.const_rows(1, self.device)
        self._consts: dict[int, torch.Tensor] = {}

    # ---------------- conversions ---------------- #

    def to_mont(self, t: torch.Tensor) -> torch.Tensor:
        return mont.field_mul(self.m, t, self._r2)

    def from_mont(self, t: torch.Tensor) -> torch.Tensor:
        return mont.field_mul(self.m, t, self._unit)

    def to_dev(self, vals: list[int]) -> torch.Tensor:
        """ints -> (8, n) Montgomery rows."""
        return self.to_mont(ff.to_rows([v % self.m for v in vals], self.device))

    def to_dev_batch(self, cols: list[list[int]]) -> torch.Tensor:
        """k lists of n ints -> (8, k, n) Montgomery rows (one transfer)."""
        flat = [v % self.m for col in cols for v in col]
        return self.to_dev(flat).reshape(ff.NWORDS, len(cols), -1)

    def consts(self, vals: list[int]) -> torch.Tensor:
        """ints -> (k, 8, 1) Montgomery constants in one host-to-device
        copy; [i] is one contiguous (8, 1) element, as field_mul's
        broadcast operand takes it."""
        words = ff.ints_to_words([ff.mont_int(v % self.m, self.m) for v in vals])
        return torch.from_numpy(words.view("<i4").copy()).to(self.device)[:, :, None]

    def const(self, x: int) -> torch.Tensor:
        """One (8, 1) Montgomery constant; sent to the card once per value."""
        x %= self.m
        if x not in self._consts:
            self._consts[x] = self.consts([x])[0]
        return self._consts[x]

    def to_ints(self, dev: torch.Tensor) -> list[int]:
        return ff.from_rows(self.from_mont(dev))

    def one(self) -> torch.Tensor:
        return self._one

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros((ff.NWORDS, *shape), dtype=torch.int32, device=self.device)

    # ---------------- polynomial ops ---------------- #

    def _mesh_ntt_ok(self, n: int) -> bool:
        """halo_tpu's test: a power of two, d | n and n >= d^2."""
        if self.mesh is None:
            return False
        d = len(self.mesh)
        return n >= d * d and n % d == 0 and n & (n - 1) == 0

    def _ntt(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        if self._mesh_ntt_ok(a.shape[-1]):
            return gather(pntt.ntt_distributed(self.m, self.mesh, a, inverse), self.device)
        return ntt.ntt(self.m, a, inverse)

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self._ntt(coeffs, False)

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        return self._ntt(evals, True)

    def ntt_extended(self, coeffs: torch.Tensor, big_n: int) -> torch.Tensor:
        """Evaluate degree-<n coefficients over the size-big_n domain."""
        pad = big_n - coeffs.shape[-1]
        z = torch.zeros((*coeffs.shape[:-1], pad), dtype=coeffs.dtype, device=coeffs.device)
        return self._ntt(torch.cat((coeffs, z), -1), False)

    def mul(self, a, b):
        return mont.field_mul(self.m, a, b)

    def add(self, a, b):
        return mont.field_add(self.m, a, b)

    def sub(self, a, b):
        return mont.field_sub(self.m, a, b)

    def scale(self, a, s: int):
        return self.mul(a, self.const(s))

    def powers(self, x: int, n: int) -> torch.Tensor:
        """[1, x, x^2, ...] as (8, n) Montgomery rows (host-generated)."""
        return self.to_dev(_powers(self.m, x, n))

    def exact_sum(self, prods: torch.Tensor) -> list[int]:
        """Sums over the last axis of (8, *B, n) Montgomery rows -> len(B)
        canonical ints.  The u32 words sum exactly in int64 (n < 2^31)."""
        u = (prods.to(torch.int64) & 0xFFFFFFFF).sum(dim=-1)  # (8, *B)
        cols = u.reshape(ff.NWORDS, -1).T.cpu().tolist()
        rinv = pow(R256, -1, self.m)
        return [sum(int(c) << (32 * i) for i, c in enumerate(row)) % self.m * rinv % self.m
                for row in cols]

    def eval_batch(self, coeffs: torch.Tensor, x) -> list[int]:
        """Evaluate (8, k, n) coefficient batches at x -> k ints; x is one
        point for all k, or a list of k points, one for each polynomial
        (one copy of all their powers and one pull)."""
        n = coeffs.shape[-1]
        if isinstance(x, int):
            pw = self.powers(x, n).reshape(ff.NWORDS, *([1] * (coeffs.dim() - 2)), n)
            pw = pw.expand_as(coeffs)
        else:
            pw = self.to_dev([v for xi in x for v in _powers(self.m, xi, n)])
            pw = pw.reshape(coeffs.shape)
        return self.exact_sum(self.mul(coeffs, pw))

    def divide_by_vanishing(self, coeffs: torch.Tensor, n: int) -> torch.Tensor:
        """Exact quotient by X^n - 1 of (8, k*n) coefficients."""
        k = coeffs.shape[-1] // n
        chunks = coeffs.reshape(ff.NWORDS, k, n)
        # q[k-2] = c[k-1]; q[j] = c[j+1] + q[j+1]  (suffix sums of chunks 1..)
        out = [None] * (k - 1)
        acc = chunks[:, k - 1]
        for j in range(k - 2, -1, -1):
            out[j] = acc
            if j > 0:
                acc = self.add(acc, chunks[:, j])
        return torch.cat(out, -1)

    # ---------------- commitments ---------------- #

    def commit(self, coeffs: torch.Tensor, d: int):
        """Commit (8, n) Montgomery coefficients against the SRS."""
        return self.commit_batch(coeffs[:, None], d)[0]

    def commit_batch(self, coeffs: torch.Tensor, d: int) -> list:
        """Commit an (8, k, n) Montgomery stack -> k affine points, in one
        batched MSM pipeline."""
        n = coeffs.shape[-1]
        assert n <= d + 1, f"degree bound: {n} coeffs > d+1 = {d + 1}"
        if self.mesh is not None:
            return pmsm.msm2_srs_rows_sharded(self.cfg, self.mesh, self.from_mont(coeffs))
        return msm2.msm2_srs_rows_multi(self.cfg, self.from_mont(coeffs))

    # ---------------- sequential algebra ---------------- #

    def grand_product(self, ratios: torch.Tensor) -> torch.Tensor:
        """Permutation accumulator: z[0] = 1, z[i] = z[i-1] * ratios[i]
        (ratios[0] unused; reference protocol.rs:144-155)."""
        x = torch.cat((self._one, ratios[:, 1:]), -1)
        return mont.scan_mul(self.m, x)

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse of (8, n) rows (inv(0) = 0): mont.batch_inv."""
        return mont.batch_inv(self.m, a)
