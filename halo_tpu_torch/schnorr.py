"""Schnorr signatures over the Pasta curves with Poseidon message hashing
(port of halo_tpu/schnorr.py; reference crates/schnorr/src/lib.rs:11-80):

  keygen: pk = sk*G;  sign: R = k*G, e = H(SIGNATURE || pk || R || m),
  s = k + e*sk;  verify: s*G == R + e*pk.

generate_keypair, sign and verify are host code.  sign_batch and
verify_batch run a batch of same-length messages on a device
(ops/schnorr_batch.py): on a CUDA device through the kernels, on the CPU
through their plain versions, only when the caller asks for it.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .curves import Affine, CurveCfg, ec_add, ec_mul
from .ops import ecrows, ff, mont, schnorr_batch
from .poseidon.sponge import hash_message


@dataclass(frozen=True)
class SchnorrSignature:
    r: Affine  # commitment point R = k*G
    s: int  # s = k + e*sk (scalar field)


def _draw_scalar(cfg: CurveCfg, rng) -> int:
    """A scalar in [1, r), drawn as halo_tpu.schnorr draws it (so a seeded
    random.Random gives the same keys and nonces)."""
    if hasattr(rng, "randbelow"):
        return rng.randbelow(cfg.r - 1) + 1
    return rng.randrange(1, cfg.r)


def generate_keypair(cfg: CurveCfg, rng=secrets) -> tuple[int, Affine]:
    """(sk, pk = sk*G), on the host: one scalar multiplication."""
    sk = _draw_scalar(cfg, rng)
    return sk, ec_mul(cfg, cfg.generator, sk)


def sign(cfg: CurveCfg, sk: int, message: list[int], k: int) -> SchnorrSignature:
    """Signature of `message` under `sk` with the nonce k (1 <= k < r)."""
    r_point = ec_mul(cfg, cfg.generator, k)
    pk = ec_mul(cfg, cfg.generator, sk)
    e = hash_message(cfg, pk, r_point, message)
    return SchnorrSignature(r=r_point, s=(k + e * sk) % cfg.r)


def sign_batch(cfg: CurveCfg, sk: int, messages: list[list[int]], device,
               rng=secrets) -> list[SchnorrSignature]:
    """Sign many same-length messages under one key on `device`: one nonce
    a message (drawn in order), R = k*G for all of them in one ec_smul
    launch with the generator broadcast, the affine normalisation on the
    device, one lockstep batch hash; s = k + e*sk on the host."""
    n = len(messages)
    if n == 0:
        raise ValueError("sign_batch needs at least one message")
    pk = ec_mul(cfg, cfg.generator, sk)
    ks = [_draw_scalar(cfg, rng) for _ in range(n)]
    p = cfg.p
    g = ecrows.pack_points(p, [cfg.generator[0]], [cfg.generator[1]], device)
    aff = ecrows.to_affine_rows(p, ecrows.scalar_mul_rows(p, g, ff.to_rows(ks, device)))
    xy = aff.reshape(2, ff.NWORDS, n).permute(1, 0, 2)  # (8, 2, n): x and y
    vals = ff.from_rows(mont.field_mul(p, xy, ff.const_rows(1, device)))  # out of Montgomery form
    rs = list(zip(vals[:n], vals[n:]))
    es = schnorr_batch.hash_message_batch(cfg, pk, rs, messages, device)
    return [SchnorrSignature(r=r, s=(k + e * sk) % cfg.r) for r, k, e in zip(rs, ks, es)]


def verify_batch(cfg: CurveCfg, pk: Affine, messages: list[list[int]],
                 sigs: list[SchnorrSignature], device) -> list[bool]:
    """One verdict per signature under one key, equal to calling verify()
    on each (lockstep Poseidon transcripts and the fixed-base dual
    scalar multiplication, ops/schnorr_batch.py)."""
    return schnorr_batch.verify_batch(cfg, pk, messages, sigs, device)


def verify(cfg: CurveCfg, pk: Affine, message: list[int], sig: SchnorrSignature) -> bool:
    e = hash_message(cfg, pk, sig.r, message)
    lhs = ec_mul(cfg, cfg.generator, sig.s)
    return lhs == ec_add(cfg, sig.r, ec_mul(cfg, pk, e))
