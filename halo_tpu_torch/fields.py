"""Pasta prime fields as Python ints (the port's copy of halo_tpu/fields.py,
cut to what the port calls: inverse, square root, roots of unity).

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


class _SqrtCtx:
    """Tonelli-Shanks context for a fixed modulus m - 1 = 2^s * t, t odd."""

    def __init__(self, m: int):
        self.m = m
        t, s = m - 1, 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.s = s
        self.t = t
        z = 2  # the smallest quadratic non-residue
        while pow(z, (m - 1) // 2, m) != m - 1:
            z += 1
        self.root_of_unity = pow(z, t, m)


_SQRT_CACHE: dict[int, _SqrtCtx] = {}


def sqrt(x: int, m: int) -> int | None:
    """A square root of x mod m by Tonelli-Shanks, or None if x is a
    non-residue (halo_tpu.fields.sqrt: the same root for the same x)."""
    x %= m
    if x == 0:
        return 0
    if pow(x, (m - 1) // 2, m) != 1:
        return None
    ctx = _SQRT_CACHE.get(m)
    if ctx is None:
        ctx = _SQRT_CACHE[m] = _SqrtCtx(m)
    c = ctx.root_of_unity
    r = pow(x, (ctx.t + 1) // 2, m)
    tv = pow(x, ctx.t, m)
    mexp = ctx.s
    while tv != 1:
        # the least i, 0 < i < mexp, with tv^(2^i) == 1
        i, t2 = 0, tv
        while t2 != 1:
            t2 = t2 * t2 % m
            i += 1
        b = pow(c, 1 << (mexp - i - 1), m)
        r = r * b % m
        c = b * b % m
        tv = tv * c % m
        mexp = i
    return r
