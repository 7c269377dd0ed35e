"""Pasta prime fields as Python ints (the port's copy of halo_tpu/fields.py,
cut to what the port calls).

Naming follows the reference (crates/group/src/lib.rs:8-9):
  Fp = scalar field of Pallas = base field of Vesta   (modulus FP_MOD)
  Fq = base field of Pallas = scalar field of Vesta   (modulus FQ_MOD)
"""

from __future__ import annotations

# Pallas base field modulus (ark_pallas::Fq)
FQ_MOD = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Pallas scalar field modulus (ark_pallas::Fr)
FP_MOD = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Montgomery radix of arkworks' 4x64-bit representation (and of the port's
# 8x32-bit words: the same R, so Montgomery values agree bit for bit)
R256 = 1 << 256

# Both Pasta fields are highly 2-adic: p - 1 = 2^32 * t with t odd.
TWO_ADICITY = 32
# smallest multiplicative generator of both fields (arkworks' GENERATOR)
_GENERATOR = 5


def inv(x: int, m: int) -> int:
    """Modular inverse; raises ValueError on 0."""
    return pow(x, -1, m)


def two_adic_root_of_unity(m: int, log_n: int) -> int:
    """Primitive 2^log_n-th root of unity matching ark-poly's choice:
    GENERATOR^t squared down from the 2^32 root."""
    assert log_n <= TWO_ADICITY and m in (FP_MOD, FQ_MOD)
    w = pow(_GENERATOR, (m - 1) >> TWO_ADICITY, m)
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % m
    return w
