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
// conditional subtract that ends fe_mul, fe_add and fe_sub here.  Each
// operation is exact and canonical, so any order of evaluation of a
// formula gives the same output words.
//
// Built for latency.  The field is a template parameter (F = 0 or 1; the
// C entries of kernels.cu dispatch once per launch), so the modulus words
// are immediates and the shape of both Pasta moduli is used at compile time:
//   p = 1 + p1 2^32 + p2 2^64 + p3 2^96 + 2^30 2^224   (words 4-6 are 0)
//   -p^-1 mod 2^32 = 2^32 - 1, so a reduction factor is m = -t0.
//
// fe_mul is CIOS over 8 words on PTX carry chains (one instruction per asm
// volatile statement, so their order, and with it the carry flag, is kept).
// Each outer step i keeps the running value as E + O 2^32, two accumulators
// with a carry chain each: E takes the products a_j b_i of even j and the
// reduction terms m, m p2; O takes those of odd j and m p1, m p3, m 2^254
// (the last as two shifts of m).  The two chains are independent, so their
// instructions interleave, and step i + 1 starts as soon as the low words
// of step i are out.  The shift by one word is a renaming of registers:
// E' = O + E_1 (one add whose carry enters O's next chain), O' = E_2..E_8.
// One product does 88 32x32-bit multiplies (64 for a*b, 24 for m p1..p3;
// a dense CIOS does 136), written as 176 lo/hi multiply-adds that ptxas
// fuses into IMAD.WIDE.U32.X and IMAD.HI.U32.X with carry predicates, and
// ends in one conditional subtract.  On sm_90a the whole k_field_mul
// kernel (loads, one product, stores) is 392 SASS instructions, 161 of
// them IMAD (halo_tpu_torch/kernel_ab.py counts them with cuobjdump).
//
// Multiplications by b3 = 3b = 15 (b = 5 on both curves) are
// fe_mul15<F>: four canonical doublings and one subtraction.
//
// The tables below are checked against halo_tpu.fields by
// tests/test_torch_mont.py (_check_field_cuh_constants), which parses this
// file; the compile-time constants are read from them.
#pragma once

#include <stdint.h>

namespace halo {

struct Fe {
  uint32_t w[8];
};

// moduli, little-endian words
constexpr uint32_t MOD[2][8] = {
    {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u},
    {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u},
};
// Montgomery one: R mod p
constexpr uint32_t ONE[2][8] = {
    {0xfffffffdu, 0x5b2b3e9cu, 0xe3420567u, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xfffffffdu, 0x34786d38u, 0xe41914adu, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
};
// 3b in Montgomery form (b = 5 on both Pasta curves): 15 * R mod p.  No
// kernel reads it: fe_mul(x, B3) and fe_mul15(x) are the same value, and
// the formulas use fe_mul15.  It stays as the checked record of b3 that
// _check_field_cuh_constants parses.
constexpr uint32_t B3[2][8] = {
    {0xffffffc5u, 0xaba7cf64u, 0xcabd14f0u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xffffffc5u, 0xb295b960u, 0xdb4296a3u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
};
// -p^-1 mod 2^32 (both moduli are 1 mod 2^32)
constexpr uint32_t N0[2] = {0xffffffffu, 0xffffffffu};

template <int F>
struct Pasta {
  static constexpr uint32_t P1 = MOD[F][1], P2 = MOD[F][2], P3 = MOD[F][3];
  static constexpr uint32_t O1 = ONE[F][1], O2 = ONE[F][2];
};

constexpr bool pasta_shape(int f) {
  return MOD[f][0] == 1u && MOD[f][4] == 0u && MOD[f][5] == 0u && MOD[f][6] == 0u &&
         MOD[f][7] == (1u << 30) && N0[f] == 0xffffffffu && ONE[f][0] == 0xfffffffdu &&
         ONE[f][3] == 0x992c350bu && ONE[f][4] == 0xffffffffu && ONE[f][5] == 0xffffffffu &&
         ONE[f][6] == 0xffffffffu && ONE[f][7] == 0x3fffffffu && MOD[0][3] == MOD[f][3];
}
static_assert(pasta_shape(0) && pasta_shape(1), "fe_mul's reduction assumes the Pasta moduli");

// ---- PTX carry-chain primitives (CC.CF is the carry, or the borrow) ----
#define HALO_ASM __device__ __forceinline__ uint32_t
HALO_ASM add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
HALO_ASM addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
HALO_ASM addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
HALO_ASM sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
HALO_ASM subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
HALO_ASM subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo(a*b) + c, carry out
HALO_ASM mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// lo(a*b) + c + carry, carry out
HALO_ASM madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a*b) + c + carry, carry out
HALO_ASM madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a*b) + c + carry
HALO_ASM madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
#undef HALO_ASM
// ---- end of the PTX primitives ----

template <int F>
__device__ __forceinline__ void fe_one(Fe& r) {
  r.w[0] = 0xfffffffdu;
  r.w[1] = Pasta<F>::O1;
  r.w[2] = Pasta<F>::O2;
  r.w[3] = 0x992c350bu;
  r.w[4] = 0xffffffffu;
  r.w[5] = 0xffffffffu;
  r.w[6] = 0xffffffffu;
  r.w[7] = 0x3fffffffu;
}

__device__ __forceinline__ void fe_zero(Fe& r) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = 0u;
}

// r = t - p if t >= p, else t (t < 2^256)
template <int F>
__device__ __forceinline__ void fe_reduce_once(Fe& r, const uint32_t* t) {
  using C = Pasta<F>;
  uint32_t d[8];
  d[0] = sub_cc(t[0], 1u);
  d[1] = subc_cc(t[1], C::P1);
  d[2] = subc_cc(t[2], C::P2);
  d[3] = subc_cc(t[3], C::P3);
  d[4] = subc_cc(t[4], 0u);
  d[5] = subc_cc(t[5], 0u);
  d[6] = subc_cc(t[6], 0u);
  d[7] = subc_cc(t[7], 1u << 30);
  const uint32_t lt = subc(0u, 0u);  // all ones when t < p
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = lt ? t[k] : d[k];
}

// a + b < 2p < 2^256: no carry leaves word 7
template <int F>
__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[8];
  t[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 7; ++k) t[k] = addc_cc(a.w[k], b.w[k]);
  t[7] = addc(a.w[7], b.w[7]);
  fe_reduce_once<F>(r, t);
}

template <int F>
__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  using C = Pasta<F>;
  uint32_t t[8];
  t[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) t[k] = subc_cc(a.w[k], b.w[k]);
  const uint32_t m = subc(0u, 0u);  // all ones when a < b: add p back
  r.w[0] = add_cc(t[0], m & 1u);
  r.w[1] = addc_cc(t[1], m & C::P1);
  r.w[2] = addc_cc(t[2], m & C::P2);
  r.w[3] = addc_cc(t[3], m & C::P3);
  r.w[4] = addc_cc(t[4], 0u);
  r.w[5] = addc_cc(t[5], 0u);
  r.w[6] = addc_cc(t[6], 0u);
  r.w[7] = addc(t[7], m & (1u << 30));
}

// One CIOS step's reduction, m = -e[0]: e += (m, 0, m p2) at words 0-3 with
// the carry run up to e[8]; o += (m p1, m p3, 0, m 2^30) at words 0-7.
// o's final carry is 0: the running value stays below 2p (see fe_mul).
template <int F>
__device__ __forceinline__ void redc_step(uint32_t* e, uint32_t* o, uint32_t m) {
  using C = Pasta<F>;
  e[0] = add_cc(e[0], m);  // 0, carry = (e[0] != 0)
  e[1] = addc_cc(e[1], 0u);
  e[2] = madc_lo_cc(m, C::P2, e[2]);
  e[3] = madc_hi_cc(m, C::P2, e[3]);
  e[4] = addc_cc(e[4], 0u);
  e[5] = addc_cc(e[5], 0u);
  e[6] = addc_cc(e[6], 0u);
  e[7] = addc_cc(e[7], 0u);
  e[8] = addc(e[8], 0u);
  o[0] = mad_lo_cc(m, C::P1, o[0]);
  o[1] = madc_hi_cc(m, C::P1, o[1]);
  o[2] = madc_lo_cc(m, C::P3, o[2]);
  o[3] = madc_hi_cc(m, C::P3, o[3]);
  o[4] = addc_cc(o[4], 0u);
  o[5] = addc_cc(o[5], 0u);
  o[6] = addc_cc(o[6], m << 30);
  o[7] = addc(o[7], m >> 2);
}

// Montgomery product a*b*R^-1 mod p (a, b < p).  The running value
// V = E + O 2^32 (E: 9 words, O: 8 words from word 1) is below 2p at each
// step; within a step V + a b_i + m p < 2^288, so E fits 9 words and O 8.
template <int F>
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t e[9], o[8];
  {  // step 0: E = a_even b_0, O = a_odd b_0, no accumulators yet
    const uint32_t y = b.w[0];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      e[j] = a.w[j] * y;
      e[j + 1] = __umulhi(a.w[j], y);
      o[j] = a.w[j + 1] * y;
      o[j + 1] = __umulhi(a.w[j + 1], y);
    }
    e[8] = 0u;
    redc_step<F>(e, o, 0u - e[0]);
  }
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const uint32_t y = b.w[i];
    uint32_t E[9], O[8];
    // shift by one word: E = O + e[1] (its carry enters O's chain at word
    // 0), O = e[2..8]; then O += a_odd y, ending in the fresh word O[7]
    E[0] = add_cc(o[0], e[1]);
    O[0] = madc_lo_cc(a.w[1], y, e[2]);
    O[1] = madc_hi_cc(a.w[1], y, e[3]);
    O[2] = madc_lo_cc(a.w[3], y, e[4]);
    O[3] = madc_hi_cc(a.w[3], y, e[5]);
    O[4] = madc_lo_cc(a.w[5], y, e[6]);
    O[5] = madc_hi_cc(a.w[5], y, e[7]);
    O[6] = madc_lo_cc(a.w[7], y, e[8]);
    O[7] = madc_hi(a.w[7], y, 0u);
    // E += a_even y, ending in the fresh word E[8]
    E[0] = mad_lo_cc(a.w[0], y, E[0]);
    E[1] = madc_hi_cc(a.w[0], y, o[1]);
    E[2] = madc_lo_cc(a.w[2], y, o[2]);
    E[3] = madc_hi_cc(a.w[2], y, o[3]);
    E[4] = madc_lo_cc(a.w[4], y, o[4]);
    E[5] = madc_hi_cc(a.w[4], y, o[5]);
    E[6] = madc_lo_cc(a.w[6], y, o[6]);
    E[7] = madc_hi_cc(a.w[6], y, o[7]);
    E[8] = addc(0u, 0u);
    redc_step<F>(E, O, 0u - E[0]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      e[k] = E[k];
      o[k] = O[k];
    }
    e[8] = E[8];
  }
  // V / 2^32 = O + e[1..8] < 2p
  uint32_t t[8];
  t[0] = add_cc(o[0], e[1]);
#pragma unroll
  for (int k = 1; k < 7; ++k) t[k] = addc_cc(o[k], e[k + 1]);
  t[7] = addc(o[7], e[8]);
  fe_reduce_once<F>(r, t);
}

// r = 15 x (b3 = 3b, b = 5): four doublings and a subtraction
template <int F>
__device__ __forceinline__ void fe_mul15(Fe& r, const Fe& x) {
  Fe t;
  fe_add<F>(t, x, x);
  fe_add<F>(t, t, t);
  fe_add<F>(t, t, t);
  fe_add<F>(t, t, t);
  fe_sub<F>(r, t, x);
}

// ---------------- products of one formula level over a thread group ----------------
//
// G threads of one warp (G divides 32; role q = 0..G-1) own one lane.  A
// level's K independent products run in ceil(K / G) rounds: in round s
// role q multiplies pair s G + q (roles past K repeat pair s G), and every
// role receives each round's products by __shfl_sync.  G = 1 is the plain
// sequence of products.  Every thread of the warp must take part.

template <int G>
__device__ __forceinline__ void fe_shfl(Fe& r, const Fe& v, int src) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = __shfl_sync(0xffffffffu, v.w[k], src, G);
}

template <int F, int G, int K>
__device__ __forceinline__ void level_mul(Fe (&r)[K], const Fe (&x)[K], const Fe (&y)[K], int q) {
#pragma unroll
  for (int s = 0; s < (K + G - 1) / G; ++s) {
    Fe u = x[s * G], v = y[s * G];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      if (s * G + g < K && q == g) {
        u = x[s * G + g];
        v = y[s * G + g];
      }
    }
    Fe z;
    fe_mul<F>(z, u, v);
    if (G == 1) {
      r[s] = z;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (s * G + g < K) fe_shfl<G>(r[s * G + g], z, g);
      }
    }
  }
}

// ---------------- complete projective formulas, a = 0 ----------------
// Renes-Costello-Batina 2015, algorithm 7 (add), its Z2 = 1 mixed form and
// algorithm 9 (doubling), with the values of halo_tpu/ops/pallas_mont.py
// (_padd_kernel :285-301, _pmadd_kernel :340-352, _pmadd_pack_kernel
// :389-403, _pdbl_kernel :431-450).  Points are projective (X : Y : Z) in
// Montgomery form; the identity is (0 : 1 : 0).  pt_add, pt_add_affine and
// pt_double take the thread group of level_mul: 12, 11 and 8 products in
// two levels of 6 and 6, 5 and 6, 4 and 4; the b3 multiplications as
// fe_mul15.

struct Pt {
  Fe X, Y, Z;
};

template <int F>
__device__ __forceinline__ void pt_identity(Pt& r) {
  fe_zero(r.X);
  fe_one<F>(r.Y);
  fe_zero(r.Z);
}

template <int F, int G>
__device__ __forceinline__ void pt_add(Pt& r, const Pt& p, const Pt& q, int role) {
  Fe t[6];
  {
    Fe a[6] = {p.X, p.Y, p.Z, p.X, p.Y, p.X};
    Fe b[6] = {q.X, q.Y, q.Z, q.X, q.Y, q.X};
    fe_add<F>(a[3], p.X, p.Y);
    fe_add<F>(b[3], q.X, q.Y);
    fe_add<F>(a[4], p.Y, p.Z);
    fe_add<F>(b[4], q.Y, q.Z);
    fe_add<F>(a[5], p.X, p.Z);
    fe_add<F>(b[5], q.X, q.Z);
    level_mul<F, G, 6>(t, a, b, role);
  }
  // t0 t1 t2 = X1X2 Y1Y2 Z1Z2; t[3..5] = (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  Fe u, t3, t4, y3, t0, t1, t2, z3;
  fe_add<F>(u, t[0], t[1]);
  fe_sub<F>(t3, t[3], u);
  fe_add<F>(u, t[1], t[2]);
  fe_sub<F>(t4, t[4], u);
  fe_add<F>(u, t[0], t[2]);
  fe_sub<F>(y3, t[5], u);
  fe_add<F>(u, t[0], t[0]);
  fe_add<F>(t0, u, t[0]);
  fe_mul15<F>(t2, t[2]);
  fe_add<F>(z3, t[1], t2);
  fe_sub<F>(t1, t[1], t2);
  fe_mul15<F>(y3, y3);
  Fe s[6];
  {
    Fe a[6] = {t3, t4, t1, y3, z3, t0};
    Fe b[6] = {t1, y3, z3, t0, t4, t3};
    level_mul<F, G, 6>(s, a, b, role);
  }
  fe_sub<F>(r.X, s[0], s[1]);
  fe_add<F>(r.Y, s[2], s[3]);
  fe_add<F>(r.Z, s[4], s[5]);
}

// p + (x2, y2) with the affine operand a genuine curve point (never the
// identity).
template <int F, int G>
__device__ __forceinline__ void pt_add_affine(Pt& r, const Pt& p, const Fe& x2, const Fe& y2,
                                              int role) {
  Fe t[5];
  {
    Fe a[5] = {p.X, p.Y, p.X, p.Z, p.Z};
    Fe b[5] = {x2, y2, x2, y2, x2};
    fe_add<F>(a[2], p.X, p.Y);
    fe_add<F>(b[2], x2, y2);
    level_mul<F, G, 5>(t, a, b, role);
  }
  // t0 = X1 x2, t1 = Y1 y2, t[2] = (X1+Y1)(x2+y2), t[3] = Z1 y2, t[4] = Z1 x2
  Fe u, t0, t1, t2, t3, t4, t5, z3;
  fe_add<F>(u, t[0], t[1]);
  fe_sub<F>(t3, t[2], u);
  fe_add<F>(t4, p.Y, t[3]);
  fe_add<F>(t5, p.X, t[4]);
  fe_add<F>(u, t[0], t[0]);
  fe_add<F>(t0, u, t[0]);
  fe_mul15<F>(t2, p.Z);
  fe_add<F>(z3, t[1], t2);
  fe_sub<F>(t1, t[1], t2);
  fe_mul15<F>(t5, t5);
  Fe s[6];
  {
    Fe a[6] = {t3, t4, t1, t5, z3, t0};
    Fe b[6] = {t1, t5, z3, t0, t4, t3};
    level_mul<F, G, 6>(s, a, b, role);
  }
  fe_sub<F>(r.X, s[0], s[1]);
  fe_add<F>(r.Y, s[2], s[3]);
  fe_add<F>(r.Z, s[4], s[5]);
}

// 2p, complete (the identity and points of order 2 need no branch);
// 8 products in two levels of 4 over the thread group of level_mul, and
// one fe_mul15.
template <int F, int G>
__device__ __forceinline__ void pt_double(Pt& r, const Pt& p, int role) {
  Fe t[4];
  {
    Fe a[4] = {p.Y, p.Y, p.Z, p.X};
    Fe b[4] = {p.Y, p.Z, p.Z, p.Y};
    level_mul<F, G, 4>(t, a, b, role);
  }
  // t[0] = Y^2, t[1] = YZ, t[2] = Z^2, t[3] = XY
  Fe z8, t2, y3, u, t0;
  fe_add<F>(z8, t[0], t[0]);
  fe_add<F>(z8, z8, z8);
  fe_add<F>(z8, z8, z8);
  fe_mul15<F>(t2, t[2]);
  fe_add<F>(y3, t[0], t2);
  fe_add<F>(u, t2, t2);
  fe_add<F>(u, u, t2);
  fe_sub<F>(t0, t[0], u);
  Fe s[4];
  {
    Fe a[4] = {t2, t[1], t0, t0};
    Fe b[4] = {z8, z8, y3, t[3]};
    level_mul<F, G, 4>(s, a, b, role);
  }
  // X3 = 2 t0 XY, Y3 = 15Z^2 8Y^2 + t0 y3, Z3 = 8Y^2 YZ
  fe_add<F>(r.X, s[3], s[3]);
  fe_add<F>(r.Y, s[0], s[2]);
  r.Z = s[1];
}

}  // namespace halo
