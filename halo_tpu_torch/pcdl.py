"""PCDL commitments and opens on tensors (port of the device seams of
halo_tpu/pcdl.py: _srs_msm :71-78, commit :192-201, open_without_eval
:222-242, open_proof :334-338, check :390-395).

halo_tpu.pcdl reaches jax through ops.msm on every commit and check, and
through ops.ipa for large opens; these versions route the same
operations through the port's MSM (ops/msm2.py) and IPA (ops/ipa.py) on
an explicit device.  The data classes and the succinct check are
halo_tpu's (pure host code).  Only the non-hiding path (w = None, the
PLONK prover's) is ported.
"""

from __future__ import annotations

import torch

from halo_tpu.curves import Affine, CurveCfg
from halo_tpu.errors import PcdlCheckError
from halo_tpu.pcdl import EvalProof, poly_eval, succinct_check

from .ops import ipa, msm2


def _non_hiding(w) -> None:
    if w is not None:
        raise NotImplementedError("halo_tpu_torch.pcdl: hiding commitments are not ported")


def _srs_msm(cfg: CurveCfg, scalars: list[int], device) -> Affine:
    """MSM against the first len(scalars) SRS generators."""
    return msm2.msm2_srs(cfg, [s % cfg.r for s in scalars], device)


def commit(cfg: CurveCfg, p: list[int], d: int, device, w: int | None = None) -> Affine:
    """Pedersen commitment to host coefficients (reference pcdl.rs:275-287)."""
    _non_hiding(w)
    n = d + 1
    assert n & (n - 1) == 0, "n must be a power of two"
    assert len(p) <= n
    return _srs_msm(cfg, p, device)


def commit_rows(cfg: CurveCfg, K: torch.Tensor, d: int) -> list[Affine]:
    """Commit an (8, k, n) stack of canonical coefficient rows."""
    assert K.shape[-1] <= d + 1
    return msm2.msm2_srs_rows_multi(cfg, K)


def open_without_eval(cfg: CurveCfg, p, C: Affine, d: int, z: int, v: int, device,
                      w: int | None = None) -> EvalProof:
    """IPA opening proof (reference pcdl.rs:326-453); p is a host list or
    an (8, n') Montgomery row tensor."""
    _non_hiding(w)
    n = d + 1
    assert n >= 1 and n & (n - 1) == 0
    return ipa.open_without_eval_device(cfg, p, C, d, z, v, device)


def open_proof(cfg: CurveCfg, p: list[int], C: Affine, d: int, z: int, device,
               w: int | None = None) -> EvalProof:
    v = poly_eval(cfg, p, z)
    return open_without_eval(cfg, p, C, d, z, v, device, w)


def check(cfg: CurveCfg, C: Affine, d: int, z: int, v: int, pi: EvalProof, device) -> None:
    """Full (linear-time) check (reference pcdl.rs:563-583)."""
    h, U = succinct_check(cfg, C, d, z, v, pi)
    if U != _srs_msm(cfg, h.coeffs(), device):
        raise PcdlCheckError("check failed: U != MSM(Gs, h_coeffs)")

