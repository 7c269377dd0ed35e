// Hopper field core for the Pasta fields: canonical Montgomery residues
// (R = 2^256) as 8 little-endian 32-bit words.
//
// Field ids (the repo's naming, halo_tpu/fields.py):
//   0 = Fp, modulus FP_MOD: Pallas scalar field = Vesta base field
//   1 = Fq, modulus FQ_MOD: Pallas base field  = Vesta scalar field
//
// Every function takes and returns canonical values in [0, p): the TPU
// kernels' lazy quasi-2p domain [0, 2p + 2^131) and its final `canon`
// pass (halo_tpu/ops/pallas_mont.py:_canon_kernel) are replaced by the
// conditional subtract that ends mont_mul, add and sub here.
//
// Constants are checked against halo_tpu.fields by tests/test_torch_mont.py
// (test_field_cuh_constants), which parses this file.
#pragma once

#include <stdint.h>

namespace halo {

struct Fe {
  uint32_t w[8];
};

// moduli, little-endian words
__constant__ uint32_t MOD[2][8] = {
    {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u},
    {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u},
};
// Montgomery one: R mod p
__constant__ uint32_t ONE[2][8] = {
    {0xfffffffdu, 0x5b2b3e9cu, 0xe3420567u, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xfffffffdu, 0x34786d38u, 0xe41914adu, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
};
// 3b in Montgomery form (b = 5 on both Pasta curves): 15 * R mod p
__constant__ uint32_t B3[2][8] = {
    {0xffffffc5u, 0xaba7cf64u, 0xcabd14f0u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xffffffc5u, 0xb295b960u, 0xdb4296a3u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
};
// -p^-1 mod 2^32 (both moduli are 1 mod 2^32)
__constant__ uint32_t N0[2] = {0xffffffffu, 0xffffffffu};

__device__ __forceinline__ void fe_one(Fe& r, int f) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = ONE[f][k];
}

__device__ __forceinline__ void fe_b3(Fe& r, int f) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = B3[f][k];
}

__device__ __forceinline__ void fe_zero(Fe& r) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = 0u;
}

// r = t - p if t (with overflow word hi) >= p, else t
__device__ __forceinline__ void fe_reduce_once(Fe& r, const uint32_t* t, uint32_t hi, int f) {
  uint32_t d[8];
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t s = (uint64_t)t[k] - (uint64_t)MOD[f][k] - br;
    d[k] = (uint32_t)s;
    br = s >> 63;
  }
  const bool ge = (hi != 0u) || (br == 0);
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = ge ? d[k] : t[k];
}

__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b, int f) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a.w[k] + (uint64_t)b.w[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_once(r, t, (uint32_t)c, f);
}

__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b, int f) {
  uint32_t t[8];
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t s = (uint64_t)a.w[k] - (uint64_t)b.w[k] - br;
    t[k] = (uint32_t)s;
    br = s >> 63;
  }
  // a < b: add p back (the sum wraps past 2^256 exactly once)
  uint64_t c = 0;
  const uint32_t mask = br ? 0xffffffffu : 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)t[k] + (uint64_t)(MOD[f][k] & mask);
    r.w[k] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a*b*R^-1 mod p: CIOS over 8 x 32-bit words with a
// plain 64-bit multiply-accumulate.  Every accumulate c + t + a*b stays
// below 2^64; the pre-reduction result is < 2p.
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b, int f) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0u;
  const uint32_t n0 = N0[f];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    const uint64_t bi = b.w[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)t[j];
      c += (uint64_t)a.w[j] * bi;
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);

    const uint32_t mq = t[0] * n0;
    c = (uint64_t)t[0] + (uint64_t)mq * MOD[f][0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)t[j];
      c += (uint64_t)mq * MOD[f][j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)t[8];
    t[7] = (uint32_t)c;
    c >>= 32;
    t[8] = t[9] + (uint32_t)c;
  }
  fe_reduce_once(r, t, t[8], f);
}

// ---------------- complete projective formulas, a = 0 ----------------
// Renes-Costello-Batina 2015, algorithm 7 (add), its Z2 = 1 mixed form and
// algorithm 9 (doubling), in the operation order of halo_tpu/ops/
// pallas_mont.py (_padd_kernel :285-301, _pmadd_kernel :340-352,
// _pmadd_pack_kernel :389-403, _pdbl_kernel :431-450).  Points are
// projective (X : Y : Z) in Montgomery form; the identity is (0 : 1 : 0).

struct Pt {
  Fe X, Y, Z;
};

__device__ __forceinline__ void pt_identity(Pt& r, int f) {
  fe_zero(r.X);
  fe_one(r.Y, f);
  fe_zero(r.Z);
}

__device__ __forceinline__ void pt_add(Pt& r, const Pt& p, const Pt& q, int f) {
  Fe t0, t1, t2, t3, t4, X3, Y3, Z3, u, v, b3;
  fe_b3(b3, f);
  fe_mul(t0, p.X, q.X, f);
  fe_mul(t1, p.Y, q.Y, f);
  fe_mul(t2, p.Z, q.Z, f);
  fe_add(u, p.X, p.Y, f);
  fe_add(v, q.X, q.Y, f);
  fe_mul(t3, u, v, f);
  fe_add(u, t0, t1, f);
  fe_sub(t3, t3, u, f);
  fe_add(u, p.Y, p.Z, f);
  fe_add(v, q.Y, q.Z, f);
  fe_mul(t4, u, v, f);
  fe_add(u, t1, t2, f);
  fe_sub(t4, t4, u, f);
  fe_add(u, p.X, p.Z, f);
  fe_add(v, q.X, q.Z, f);
  fe_mul(Y3, u, v, f);
  fe_add(u, t0, t2, f);
  fe_sub(Y3, Y3, u, f);
  fe_add(u, t0, t0, f);
  fe_add(t0, u, t0, f);
  fe_mul(t2, t2, b3, f);
  fe_add(Z3, t1, t2, f);
  fe_sub(t1, t1, t2, f);
  fe_mul(Y3, Y3, b3, f);
  fe_mul(u, t3, t1, f);
  fe_mul(v, t4, Y3, f);
  fe_sub(X3, u, v, f);
  fe_mul(u, t1, Z3, f);
  fe_mul(v, Y3, t0, f);
  fe_add(r.Y, u, v, f);
  fe_mul(u, Z3, t4, f);
  fe_mul(v, t0, t3, f);
  fe_add(r.Z, u, v, f);
  r.X = X3;
}

// p + (x2, y2) with the affine operand a genuine curve point (never the
// identity); 13 multiplications.
__device__ __forceinline__ void pt_add_affine(Pt& r, const Pt& p, const Fe& x2, const Fe& y2, int f) {
  Fe t0, t1, t2, t3, t4, t5, Z3, u, v, b3;
  fe_b3(b3, f);
  fe_mul(t0, p.X, x2, f);
  fe_mul(t1, p.Y, y2, f);
  fe_add(u, p.X, p.Y, f);
  fe_add(v, x2, y2, f);
  fe_mul(t3, u, v, f);
  fe_add(u, t0, t1, f);
  fe_sub(t3, t3, u, f);
  fe_mul(u, p.Z, y2, f);
  fe_add(t4, p.Y, u, f);
  fe_mul(u, p.Z, x2, f);
  fe_add(t5, p.X, u, f);
  fe_add(u, t0, t0, f);
  fe_add(t0, u, t0, f);
  fe_mul(t2, p.Z, b3, f);
  fe_add(Z3, t1, t2, f);
  fe_sub(t1, t1, t2, f);
  fe_mul(t5, t5, b3, f);
  fe_mul(u, t3, t1, f);
  fe_mul(v, t4, t5, f);
  fe_sub(r.X, u, v, f);
  fe_mul(u, t1, Z3, f);
  fe_mul(v, t5, t0, f);
  fe_add(r.Y, u, v, f);
  fe_mul(u, Z3, t4, f);
  fe_mul(v, t0, t3, f);
  fe_add(r.Z, u, v, f);
}

// 2p, complete (the identity and points of order 2 need no branch);
// 9 multiplications, 3b folded as one product by B3.
__device__ __forceinline__ void pt_double(Pt& r, const Pt& p, int f) {
  Fe t0, t1, t2, X3, Y3, Z3, b3;
  fe_b3(b3, f);
  fe_mul(t0, p.Y, p.Y, f);
  fe_add(Z3, t0, t0, f);
  fe_add(Z3, Z3, Z3, f);
  fe_add(Z3, Z3, Z3, f);
  fe_mul(t1, p.Y, p.Z, f);
  fe_mul(t2, p.Z, p.Z, f);
  fe_mul(t2, t2, b3, f);
  fe_mul(X3, t2, Z3, f);
  fe_add(Y3, t0, t2, f);
  fe_mul(Z3, t1, Z3, f);
  fe_add(t1, t2, t2, f);
  fe_add(t2, t1, t2, f);
  fe_sub(t0, t0, t2, f);
  fe_mul(Y3, t0, Y3, f);
  fe_add(Y3, X3, Y3, f);
  fe_mul(t1, p.X, p.Y, f);
  fe_mul(X3, t0, t1, f);
  fe_add(r.X, X3, X3, f);
  r.Y = Y3;
  r.Z = Z3;
}

}  // namespace halo
