"""Typed errors (the port's copy of halo_tpu/errors.py, cut to what the
port raises): a rejected proof raises a VerificationError, malformed proof
bytes a SerdeError."""

from __future__ import annotations


class VerificationError(ValueError):
    """A proof, accumulator or signature failed verification."""


class PcdlCheckError(VerificationError):
    """pcdl succinct_check/check equation failed (pcdl.rs:547-550)."""


class AccumulationError(VerificationError):
    """Accumulation verifier mismatch: C/z/d/h(z) (acc.rs:207-210)."""


class PlonkVerifyError(VerificationError):
    """PLONK verify_succinct failed: f(xi) != t(xi)*z_H(xi) (protocol.rs:441-444)."""


class SerdeError(ValueError):
    """Malformed bytes: early end, a non-canonical field element, a bad
    option tag or point flags, an abscissa off the curve, trailing bytes."""
