"""Distributed NTT: the 4-step decomposition over a mesh (port of
halo_tpu/parallel/ntt.py:32-129).

For n = n1 * n2 with n1 = d (one block-row a shard) and n2 = n / d, the
input a[k1 * n2 + k2] is sharded on k1 (shard s holds k1 = s, every k2):

  1. exchange   shard s gathers every k1 of its k2 slab [s c, (s+1) c),
                c = n2 / d (halo_tpu's first all_to_all)
  2. NTT_n1     over k1 for each k2: B[j1, k2]
  3. twiddle    C[j1, k2] = B[j1, k2] * w^(j1 k2)  (field_mul)
  4. exchange   shard s gathers row j1 = s of every slab, then NTT_n2 over
                k2 with root w^n1: grid position [j1, j2] holds A[j2 n1 + j1]
  5. with natural_order, one more exchange and a local transpose leave
     shard s the natural slab A[s n/d : (s+1) n/d]

The sub-transforms are ops/ntt.ntt on (8, ..., len) rows (ntt_pass
launches), the twiddle product is field_mul, and the exchanges are torch
copies between the shards' devices.  An inverse needs no extra scale: the
two inverse sub-transforms contribute 1/n1 * 1/n2 = 1/n.  Every value
stays canonical Montgomery, so the result equals ntt.ntt's word for word.
Leading batch axes ((8, *B, n) rows) ride along in every step.
"""

from __future__ import annotations

import torch

from ..device import cached
from ..ops import ff, mont, ntt
from .mesh import Mesh, shard_leading


def _split(n: int, d: int) -> tuple[int, int]:
    """(log_n, slab width c = n / d^2); n and d powers of two, n >= d^2."""
    log_n, log_d = n.bit_length() - 1, d.bit_length() - 1
    if n != 1 << log_n or d != 1 << log_d or n < d * d:
        raise ValueError(f"a 4-step NTT of {n} over {d} shards needs powers of two, n >= d^2")
    return log_n, n // (d * d)


@cached(32)
def _twiddle_slabs(m: int, mesh: Mesh, log_n: int, inverse: bool) -> tuple[torch.Tensor, ...]:
    """Shard s's w^(j1 k2) for k2 in its slab, j1 < d: (8, c, d)
    Montgomery rows on mesh.devices[s], w the 2^log_n root (inverted for
    an inverse).  Gathered from ntt's twiddle table W = [w^j R], j < n/2,
    and its negation (w^(j + n/2) = -w^j)."""
    d, n = len(mesh), 1 << log_n
    c = n // (d * d)
    out = []
    for s, dev in enumerate(mesh.devices):
        half = ntt._plan_dev(m, log_n, inverse, dev)[0].t()  # (8, n/2)
        full = torch.cat((half, mont.field_sub(m, torch.zeros_like(half[:, :1]), half)), 1)
        k2 = torch.arange(s * c, (s + 1) * c, device=dev)
        j1 = torch.arange(d, device=dev)
        out.append(full[:, (k2[:, None] * j1[None, :]) % n].contiguous())
    return tuple(out)


def ntt_distributed(m: int, mesh: Mesh, a: torch.Tensor, inverse: bool = False,
                    natural_order: bool = True) -> list[torch.Tensor]:
    """The NTT of (8, *B, n) Montgomery rows over `mesh` (a is sharded with
    shard_leading); returns the output's shards, shard s on
    mesh.devices[s].  With natural_order (the default) the shards join
    (mesh.gather) to ntt.ntt(m, a, inverse); with False shard s holds row
    j1 = s of the transposed grid, [j2] = A[j2 d + s] (one exchange
    saved)."""
    d = len(mesh)
    x = shard_leading(mesh, a)
    n2 = x[0].shape[-1]
    log_n, c = _split(n2 * d, d)
    devs = mesh.devices
    tw = _twiddle_slabs(m, mesh, log_n, inverse)
    # 1-3: shard s stacks every k1 of its slab on a last axis, (8, *B, c, d)
    cols = []
    for s, dev in enumerate(devs):
        col = torch.stack([x[t][..., s * c:(s + 1) * c].to(dev) for t in range(d)], -1)
        col = ntt.ntt(m, col, inverse)
        cols.append(mont.field_mul(m, col, tw[s].reshape(
            ff.NWORDS, *([1] * (col.dim() - 3)), c, d).expand(col.shape)))
    # 4: shard s takes row j1 = s of every slab: (8, *B, n2) over k2
    rows = [ntt.ntt(m, torch.cat([cols[t][..., s].to(dev) for t in range(d)], -1), inverse)
            for s, dev in enumerate(devs)]
    if not natural_order:
        return rows
    # 5: shard s takes the j2 slab [s c', (s+1) c'), c' = n2 / d, of every
    # row; local position j2_local * d + j1
    w = n2 // d
    return [torch.stack([rows[t][..., s * w:(s + 1) * w].to(dev) for t in range(d)], -1)
            .reshape(*rows[s].shape[:-1], n2) for s, dev in enumerate(devs)]
