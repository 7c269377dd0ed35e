// The port's nine CUDA kernels (sm_90a), over the field core in field.cuh.
//
// Layout: limb-major rows.  A batch of N field elements is 8 rows of N
// words (word k of lane i at k*N + i), so neighbouring threads read
// neighbouring addresses; a batch of N projective points is 3 such
// blocks (X, Y, Z).  Every kernel ends in canonical values and launches
// on the caller's stream without synchronising.  Each C entry picks the
// field's template once per launch and returns cudaGetLastError() as an
// int.
//
// What each replaces (halo_tpu/ops/pallas_mont.py):
//   field_mul      _mm_kernel :256 and _mulc_kernel :474 (b broadcast),
//                  with _canon_kernel :482 folded into the epilogue
//   ntt_butterfly  _bfly_kernel :459, one radix-2 stage per launch
//   ec_padd        _padd_kernel :261 (and, on canonical inputs, the v1
//                  halo_tpu/ops/pallas_ec.py:_ec_add_kernel :110)
//   ec_pmadd       _pmadd_kernel :308 (mixed add, unpacked affine operand,
//                  per lane or one broadcast point)
//   ec_pdbl        _pdbl_kernel :410 (and the v1 pallas_ec.py:
//                  _ec_double_kernel :149)
//   ec_pmadd_scan  _pmadd_pack_kernel :355 together with the lax.scan
//                  around it (halo_tpu/ops/msm2.py:398-417)
//   ec_smul        _pdbl_kernel :410 and _pmadd_kernel :308 together with
//                  the fori_loop around them (halo_tpu/ops/ecrows.py:60-77;
//                  the doubling is also pallas_ec.py:_ec_double_kernel :149)
//   field_addsub   no Pallas kernel: the XLA fusions of halo_tpu/ops/ff.py
//                  add :129 and sub :134 (the engine's add_jit/sub_jit),
//                  two C entries, halo_field_add and halo_field_sub
//   poseidon_permute  no Pallas kernel: halo_tpu/ops/poseidon.py:57
//                  permute_batch, a lax.scan over ff.mont_mul's jnp
//                  contractions that XLA fused into one dispatch
//
// Bounds on an H100: field_mul and ntt_butterfly move 96 bytes per
// element for one field product, so they are memory-bound near 3.35 TB/s
// at large N; they are one thread per lane.  field_addsub moves the same
// 96 bytes for no product at all: one thread per lane, each operand read
// in place through its word stride (a lane-contiguous view such as
// cs[:, :h] needs no copy) or as one broadcast element.  ec_pmadd (11 products, 256
// bytes a lane) and ec_pdbl (8 products, 192 bytes) are one thread per
// lane as well; they are the one-step forms of ec_smul, which no path
// launches.
//
// ec_padd and ec_pmadd_scan are redesigned for latency, which bounds them
// at most of the main path's shapes.  In an IVC step (2^16 rows) the scan
// runs R = 64 dependent mixed adds per lane over F = 32,768 lanes (each
// single commitment and each IPA round, whose L and R are two MSMs over
// n/2 = 32,768 original points) or over the 2^19 lanes of a batched
// commitment; in the 2^14 proof over F = 8,192 lanes.  ec_padd runs 1,920
// launches a step, the levels of msm2's _excl_prefix and _tree_sum at 32
// to 32,736 lanes (a third of them at <= 2,048) and the bucket assembly
// at up to 2^19.  At F = 8,192 the card holds 2 warps an SM, so one lane's
// latency is the launch's time; from F = 32,768 on, and at 66,082 bucket
// lanes, the kernels are bound by the rate the SMs issue the field core's
// instructions (multiply-adds at half rate), not by memory.  What the
// design does about it:
//   - the field core (field.cuh) cuts a product's dependent path to two
//     interleaved carry chains and its work to 88 32x32-bit multiplies
//     (the modulus is a template constant; a dense CIOS does 136), and
//     each b3 = 15 product to four doublings and a subtraction;
//   - a group of G threads of one warp owns one lane and splits each
//     formula level's products (5 + 6 in the mixed add, 6 + 6 in the
//     add) between its threads, exchanging 8-word results by
//     __shfl_sync, so a step's dependent path is ceil(5/G) + ceil(6/G)
//     products instead of 11;
//   - the scan keeps its accumulator in registers across the R steps,
//     loads step t + 1's index, sign and point (64 bytes as four 16-byte
//     loads from a point-major copy of the table) before it computes step
//     t, and stores each prefix from the group's first thread, coalesced.
// The thread-group rule, the same for both kernels: G is the largest of
// 4, 2, 1 with G * lanes <= SMs * 256, i.e. while the launch fits one
// 256-thread block per SM (on an H100, 132 SMs: G = 4 up to 8,448 lanes,
// 2 up to 16,896, else 1).  Below that width the card has idle SMs and a
// lane's latency is the launch's time; above it the card is full and the
// extra threads only add shuffles and the adds every thread of a group
// repeats.  So the 2^14 proof's scans run at G = 4, the IVC step's at
// G = 1, and ec_padd at 4, 2 or 1 by the level's width.  Both kernels
// are __launch_bounds__(256): G = 1 ec_padd takes 128 registers, two
// blocks an SM, so its 66,082-lane launch (259 blocks) is one wave.
//
// ec_smul runs a whole scalar multiplication, the SRS derivation's (the
// generator broadcast to n + 2 = 65,538 or 16,386 lanes) and the naive
// MSM's (2^14 lanes, a base each): one launch where the ladder used to be
// 255 ec_pdbl and 255 ec_pmadd launches and ~1,000 torch launches around
// them, each reading and writing the whole accumulator.  Its work is
// operations: 255 steps of 19 products a lane (ec_pdbl's 8 and ec_pmadd's
// 11), no bytes but the scalar and base in and the point out.  So each
// lane keeps its accumulator in registers for all 255 steps, reads its
// scalar words once each as the ladder reaches them (a running word, not a
// runtime-indexed array, which would go to local memory), and each step is
// pt_double, then pt_add_affine of the base, then a branch-free select on
// the bit.  The group rule of ec_padd and the scan (group_for) splits
// each step's four formula levels (4, 4, 5, 6 products) over G threads:
// G = 1 at 65,538 lanes, 2 at 16,386, 4 up to 8,448.  G = 1 asks for two
// blocks an SM (__launch_bounds__ min 2: 128 registers), so 65,538 lanes
// (257 blocks) are one wave.  The base is re-read at every step by a
// volatile non-coherent load (one address for a broadcast base), so it is
// dead after the add's first level: against a base held in registers for
// all 255 steps (kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700 W, one
// call; PERF.md), G = 2 went 1.95 -> 1.81 ms at 16,386 lanes and G = 4
// 1.34 -> 1.31 ms at 1,025; G = 1 at 65,538 lanes stayed at 7.3 ms: its
// local (spill) bytes fell from 72 to 8, and they were not what held it
// back; the SMs' issue rate of the core's multiply-adds is.
//
// poseidon_permute runs the kimchi permutation (55 full rounds: x^7 on
// the three words, the 3x3 MDS, the round constants) over N states, the
// Schnorr batch's message hashes.  Its work is operations: 55 x (12 + 9)
// = 1,155 products a state against 192 bytes in and out.  As a torch
// composition it would be ~1,155 launches a permutation, so it is one
// launch: one thread a state, the three words in registers for all 55
// rounds.  The 9 MDS entries and 165 round constants (Montgomery form,
// one (174, 8) device tensor per field) are copied into shared memory by
// each block; every thread of a round reads the same constant, so each
// read is a broadcast.  Blocks of 64 threads spread an 8,192-state batch
// over 128 SMs; within a round the three sboxes are independent, which
// is the lane's only parallelism.  With 2 warps an SM at that width a
// lane's latency is the launch's time: 0.43 ms against a 0.083 ms bound
// (19%), and 1.47 ms against 0.66 ms (45%) at 2^16 states (84 registers,
// no spill; chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
// A thread-group form (G threads a state, as ec_smul's) is the redesign.
//
// field_mul on canonical inputs is also the v1 canonical Montgomery
// product of halo_tpu/ops/pallas_ff.py:_mont_mul_kernel :77.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using halo::Fe;
using halo::Pt;

namespace {

constexpr int kThreads = 256;
constexpr int kScalarBits = 255;  // both Pasta scalar moduli are below 2^255

// Threads per lane of ec_padd and ec_pmadd_scan: the largest G of 4, 2, 1
// whose G * lanes threads fit one 256-thread block per SM of the current
// device; past that, more threads per lane only add work.
int group_for(long long lanes) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms = 1;
  }
  const long long room = (long long)sms * kThreads;
  return 4 * lanes <= room ? 4 : 2 * lanes <= room ? 2 : 1;
}

__device__ __forceinline__ void load_fe(Fe& r, const uint32_t* base, long long stride, long long i) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = base[k * stride + i];
}

__device__ __forceinline__ uint32_t ld_nc(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_fe(uint32_t* base, long long stride, long long i, const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) base[k * stride + i] = v.w[k];
}

__device__ __forceinline__ void load_pt(Pt& r, const uint32_t* base, long long stride, long long i) {
  load_fe(r.X, base, stride, i);
  load_fe(r.Y, base + 8 * stride, stride, i);
  load_fe(r.Z, base + 16 * stride, stride, i);
}

__device__ __forceinline__ void store_pt(uint32_t* base, long long stride, long long i, const Pt& v) {
  store_fe(base, stride, i, v.X);
  store_fe(base + 8 * stride, stride, i, v.Y);
  store_fe(base + 16 * stride, stride, i, v.Z);
}

// A thread's lane and role in a group of G threads; lanes past n repeat
// lane n - 1 (their group computes but does not store), so every thread
// of a warp with a live lane takes part in the group's shuffles.
template <int G>
struct GroupLane {
  long long lane;
  int role;
  bool live;
  bool warp_dead;
  __device__ __forceinline__ explicit GroupLane(long long n) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    lane = t / G;
    role = (int)(t % G);
    live = lane < n;
    warp_dead = (t - (threadIdx.x & 31)) / G >= n;
    if (!live) lane = n - 1;
  }
};

// out[i] = a[i] * b[i] (or b[0] when b_bcast) * R^-1 mod p
template <int F>
__global__ void k_field_mul(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b, long long n, int b_bcast) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x, y, r;
  load_fe(x, a, n, i);
  if (b_bcast) {
    load_fe(y, b, 1, 0);
  } else {
    load_fe(y, b, n, i);
  }
  halo::fe_mul<F>(r, x, y);
  store_fe(out, n, i, r);
}

// out[i] = a[i] + b[i] (SUB: a[i] - b[i]) mod p on canonical inputs.
// Operand x holds word k of lane i at x[k * xs + i * xl]: word stride xs,
// lane step xl = 1, or xl = 0 for one element that every lane reads.
template <int F, bool SUB>
__global__ void k_field_addsub(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b, long long n, long long as,
                               long long al, long long bs, long long bl) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x, y, r;
  load_fe(x, a, as, i * al);
  load_fe(y, b, bs, i * bl);
  if (SUB) {
    halo::fe_sub<F>(r, x, y);
  } else {
    halo::fe_add<F>(r, x, y);
  }
  store_fe(out, n, i, r);
}

// One radix-2 decimation-in-time stage over rows of m lanes holding
// blocks of 2*half: for block blk and j < half, with e at blk*2*half + j
// and o at e + half, (e, o) <- (e + w_j*o, e - w_j*o), w_j = tw[j*tw_stride].
template <int F>
__global__ void k_ntt_butterfly(uint32_t* __restrict__ y, const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ tw, long long m, long long half,
                                long long tw_n, long long tw_stride) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m / 2) return;
  const long long blk = t / half;
  const long long j = t - blk * half;
  const long long ie = blk * 2 * half + j;
  const long long io = ie + half;
  Fe e, o, w, p, s, d;
  load_fe(e, x, m, ie);
  load_fe(o, x, m, io);
  load_fe(w, tw, tw_n, j * tw_stride);
  halo::fe_mul<F>(p, o, w);
  halo::fe_add<F>(s, e, p);
  halo::fe_sub<F>(d, e, p);
  store_fe(y, m, ie, s);
  store_fe(y, m, io, d);
}

template <int F, int G>
__global__ void __launch_bounds__(kThreads) k_ec_padd(uint32_t* __restrict__ out,
                                                      const uint32_t* __restrict__ P,
                                                      const uint32_t* __restrict__ Q,
                                                      long long n) {
  const GroupLane<G> g(n);
  if (g.warp_dead) return;
  Pt a, b, r;
  load_pt(a, P, n, g.lane);
  load_pt(b, Q, n, g.lane);
  halo::pt_add<F, G>(r, a, b, g.role);
  if (g.live && g.role == 0) store_pt(out, n, g.lane, r);
}

// out[i] = P[i] + (x, y), the affine operand xy[:, i] (or xy[:, 0] when
// xy_bcast): x words in rows 0-7 and y words in rows 8-15 of the (16, n)
// or (16, 1) operand.  The affine point must not be the identity.
template <int F>
__global__ void k_ec_pmadd(uint32_t* __restrict__ out, const uint32_t* __restrict__ P,
                           const uint32_t* __restrict__ xy, long long n, int xy_bcast) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, r;
  Fe x, y;
  load_pt(a, P, n, i);
  if (xy_bcast) {
    load_fe(x, xy, 1, 0);
    load_fe(y, xy + 8, 1, 0);
  } else {
    load_fe(x, xy, n, i);
    load_fe(y, xy + 8 * n, n, i);
  }
  halo::pt_add_affine<F, 1>(r, a, x, y, 0);
  store_pt(out, n, i, r);
}

template <int F>
__global__ void k_ec_pdbl(uint32_t* __restrict__ out, const uint32_t* __restrict__ P,
                          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, r;
  load_pt(a, P, n, i);
  halo::pt_double<F, 1>(r, a, 0);
  store_pt(out, n, i, r);
}

// k[:, i] * (x, y) by MSB-first double-and-add over bits 254..0 of the
// scalar words k[:, i] (bit 255 is not read), (x, y) = xy[:, i] (or
// xy[:, 0] when xy_bcast; never the identity).  Each step is pt_double,
// then pt_add_affine of the base, then a word-by-word select on the bit:
// the same exact canonical operations in the same order as ec_pdbl,
// ec_pmadd and a lanewise select, so the output words are theirs.  No
// branch depends on the bit: a group's threads shuffle in every step.
template <int F, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 2 : 1)
    k_ec_smul(uint32_t* __restrict__ out, const uint32_t* __restrict__ xy,
              const uint32_t* __restrict__ k, long long n, int xy_bcast) {
  const GroupLane<G> g(n);
  if (g.warp_dead) return;
  // the base is re-read at each step (a volatile load, which the compiler
  // does not hoist): it is dead after the add's first level
  const long long bs = xy_bcast ? 1 : n, bi = xy_bcast ? 0 : g.lane;
  Pt acc;
  halo::pt_identity<F>(acc);
  // the scalar word of bit i, loaded when the ladder reaches it
  uint32_t word = k[7 * n + g.lane];
  for (int i = kScalarBits - 1; i >= 0; --i) {
    const uint32_t take = 0u - ((word >> (i & 31)) & 1u);
    if ((i & 31) == 0 && i > 0) word = k[(long long)((i >> 5) - 1) * n + g.lane];
    Fe x, y;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      x.w[w] = ld_nc(xy + w * bs + bi);
      y.w[w] = ld_nc(xy + (8 + w) * bs + bi);
    }
    Pt d, s;
    halo::pt_double<F, G>(d, acc, g.role);
    halo::pt_add_affine<F, G>(s, d, x, y, g.role);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      acc.X.w[w] = (s.X.w[w] & take) | (d.X.w[w] & ~take);
      acc.Y.w[w] = (s.Y.w[w] & take) | (d.Y.w[w] & ~take);
      acc.Z.w[w] = (s.Z.w[w] & take) | (d.Z.w[w] & ~take);
    }
  }
  if (g.live && g.role == 0) store_pt(out, n, g.lane, acc);
}

__device__ __forceinline__ void load_affine(uint4 (&v)[4], const uint4* __restrict__ xy,
                                            int32_t pi) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __ldg(xy + 4 * (long long)pi + k);
}

// Lane l of nl runs a prefix over R sorted points: acc starts at the
// identity; at step t it adds the affine point idx[t, l] of the
// point-major table xy (npts rows of 16 words: x in 0-7, y in 8-15),
// negated when neg[t, l] != 0, and writes acc to out[:, t, l].
template <int F, int G>
__global__ void __launch_bounds__(kThreads) k_ec_pmadd_scan(uint32_t* __restrict__ out,
                                                            const uint4* __restrict__ xy,
                                                            const int32_t* __restrict__ idx,
                                                            const uint8_t* __restrict__ neg,
                                                            long long R, long long nl) {
  const GroupLane<G> g(nl);
  if (g.warp_dead) return;
  const long long plane = R * nl;
  Pt acc;
  halo::pt_identity<F>(acc);
  Fe zero;
  halo::fe_zero(zero);
  uint4 pt[4];
  load_affine(pt, xy, idx[g.lane]);
  uint8_t ng = neg[g.lane];
  int32_t pi_next = R > 1 ? idx[nl + g.lane] : 0;
  for (long long t = 0; t < R; ++t) {
    Fe x, y, yn;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      x.w[4 * k] = pt[k].x;
      x.w[4 * k + 1] = pt[k].y;
      x.w[4 * k + 2] = pt[k].z;
      x.w[4 * k + 3] = pt[k].w;
      y.w[4 * k] = pt[2 + k].x;
      y.w[4 * k + 1] = pt[2 + k].y;
      y.w[4 * k + 2] = pt[2 + k].z;
      y.w[4 * k + 3] = pt[2 + k].w;
    }
    const bool negate = ng != 0;
    if (t + 1 < R) {  // step t + 1's point and sign, step t + 2's index
      load_affine(pt, xy, pi_next);
      ng = neg[(t + 1) * nl + g.lane];
      if (t + 2 < R) pi_next = idx[(t + 2) * nl + g.lane];
    }
    halo::fe_sub<F>(yn, zero, y);
    if (negate) y = yn;
    halo::pt_add_affine<F, G>(acc, acc, x, y, g.role);
    if (g.live && g.role == 0) store_pt(out, plane, t * nl + g.lane, acc);
  }
}

constexpr int kPoseidonRounds = 55;
constexpr int kPoseidonConsts = 9 + 3 * kPoseidonRounds;  // MDS row-major, then the rounds'
constexpr int kPoseidonThreads = 64;

__device__ __forceinline__ void load_fe_shared(Fe& r, const uint32_t* s) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = s[k];
}

// x^7 = x^4 x^3 with x^2 = x x, x^3 = x^2 x, x^4 = x^2 x^2
template <int F>
__device__ __forceinline__ void fe_pow7(Fe& x) {
  Fe x2, x3, x4;
  halo::fe_mul<F>(x2, x, x);
  halo::fe_mul<F>(x3, x2, x);
  halo::fe_mul<F>(x4, x2, x2);
  halo::fe_mul<F>(x, x4, x3);
}

// out[:, i] = permute(state[:, i]) for the (3, 8, n) canonical Montgomery
// states (word k of state word c of lane i at (8 c + k) n + i); consts
// holds kPoseidonConsts Montgomery elements of 8 words: the MDS row-major,
// then the round constants, three a round.  Each round is the sbox on all
// three words, then the MDS, then the constants (halo_tpu_torch/poseidon/
// sponge.py permute).
template <int F>
__global__ void __launch_bounds__(kPoseidonThreads) k_poseidon_permute(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ state,
    const uint32_t* __restrict__ consts, long long n) {
  __shared__ uint32_t sc[kPoseidonConsts * 8];
  for (int k = threadIdx.x; k < kPoseidonConsts * 8; k += blockDim.x) sc[k] = consts[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) load_fe(s[c], state + 8 * c * n, n, i);
#pragma unroll 1
  for (int r = 0; r < kPoseidonRounds; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) fe_pow7<F>(s[c]);
    const uint32_t* rc = sc + 8 * (9 + 3 * r);
    Fe t[3];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      Fe m, acc, prod;
      load_fe_shared(m, sc + 8 * (3 * row));
      halo::fe_mul<F>(acc, m, s[0]);
#pragma unroll
      for (int col = 1; col < 3; ++col) {
        load_fe_shared(m, sc + 8 * (3 * row + col));
        halo::fe_mul<F>(prod, m, s[col]);
        halo::fe_add<F>(acc, acc, prod);
      }
      load_fe_shared(m, rc + 8 * row);
      halo::fe_add<F>(t[row], acc, m);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = t[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) store_fe(out + 8 * c * n, n, i, s[c]);
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <int F, int G>
void launch_ec_padd(void* out, const void* P, const void* Q, long long n, cudaStream_t s) {
  k_ec_padd<F, G><<<grid_for(n * G), kThreads, 0, s>>>((uint32_t*)out, (const uint32_t*)P,
                                                       (const uint32_t*)Q, n);
}

template <int F>
void launch_ec_padd_g(void* out, const void* P, const void* Q, long long n, int g,
                      cudaStream_t s) {
  if (g == 4) {
    launch_ec_padd<F, 4>(out, P, Q, n, s);
  } else if (g == 2) {
    launch_ec_padd<F, 2>(out, P, Q, n, s);
  } else {
    launch_ec_padd<F, 1>(out, P, Q, n, s);
  }
}

template <int F, int G>
void launch_scan(void* out, const void* xy, const void* idx, const void* neg, long long R,
                 long long nl, cudaStream_t s) {
  k_ec_pmadd_scan<F, G><<<grid_for(nl * G), kThreads, 0, s>>>(
      (uint32_t*)out, (const uint4*)xy, (const int32_t*)idx, (const uint8_t*)neg, R, nl);
}

template <int F>
void launch_scan_g(void* out, const void* xy, const void* idx, const void* neg, long long R,
                   long long nl, int g, cudaStream_t s) {
  if (g == 4) {
    launch_scan<F, 4>(out, xy, idx, neg, R, nl, s);
  } else if (g == 2) {
    launch_scan<F, 2>(out, xy, idx, neg, R, nl, s);
  } else {
    launch_scan<F, 1>(out, xy, idx, neg, R, nl, s);
  }
}

template <int F, int G>
void launch_smul(void* out, const void* xy, const void* k, long long n, int xy_bcast,
                 cudaStream_t s) {
  k_ec_smul<F, G><<<grid_for(n * G), kThreads, 0, s>>>((uint32_t*)out, (const uint32_t*)xy,
                                                       (const uint32_t*)k, n, xy_bcast);
}

template <int F>
void launch_smul_g(void* out, const void* xy, const void* k, long long n, int xy_bcast, int g,
                   cudaStream_t s) {
  if (g == 4) {
    launch_smul<F, 4>(out, xy, k, n, xy_bcast, s);
  } else if (g == 2) {
    launch_smul<F, 2>(out, xy, k, n, xy_bcast, s);
  } else {
    launch_smul<F, 1>(out, xy, k, n, xy_bcast, s);
  }
}

template <bool SUB>
int launch_addsub(void* out, const void* a, const void* b, long long n, long long a_stride,
                  int a_bcast, long long b_stride, int b_bcast, int f, void* stream) {
  if (n > 0) {
    auto k = f ? k_field_addsub<1, SUB> : k_field_addsub<0, SUB>;
    k<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, a_stride, a_bcast ? 0 : 1,
        b_stride, b_bcast ? 0 : 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int halo_field_mul(void* out, const void* a, const void* b, long long n, int b_bcast, int f,
                   void* stream) {
  if (n > 0) {
    auto k = f ? k_field_mul<1> : k_field_mul<0>;
    k<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)a,
                                                          (const uint32_t*)b, n, b_bcast);
  }
  return (int)cudaGetLastError();
}

// out (8, n) contiguous; a and b read at word stride a_stride, b_stride,
// each either per lane or (x_bcast) one element for every lane.
int halo_field_add(void* out, const void* a, const void* b, long long n, long long a_stride,
                   int a_bcast, long long b_stride, int b_bcast, int f, void* stream) {
  return launch_addsub<false>(out, a, b, n, a_stride, a_bcast, b_stride, b_bcast, f, stream);
}

int halo_field_sub(void* out, const void* a, const void* b, long long n, long long a_stride,
                   int a_bcast, long long b_stride, int b_bcast, int f, void* stream) {
  return launch_addsub<true>(out, a, b, n, a_stride, a_bcast, b_stride, b_bcast, f, stream);
}

int halo_ntt_butterfly(void* y, const void* x, const void* tw, long long m, long long half,
                       long long tw_n, long long tw_stride, int f, void* stream) {
  if (m > 0) {
    auto k = f ? k_ntt_butterfly<1> : k_ntt_butterfly<0>;
    k<<<grid_for(m / 2), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)y, (const uint32_t*)x, (const uint32_t*)tw, m, half, tw_n, tw_stride);
  }
  return (int)cudaGetLastError();
}

int halo_ec_padd(void* out, const void* P, const void* Q, long long n, int f, void* stream) {
  if (n > 0) {
    const int g = group_for(n);
    if (f) {
      launch_ec_padd_g<1>(out, P, Q, n, g, (cudaStream_t)stream);
    } else {
      launch_ec_padd_g<0>(out, P, Q, n, g, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

int halo_ec_pmadd(void* out, const void* P, const void* xy, long long n, int xy_bcast, int f,
                   void* stream) {
  if (n > 0) {
    auto k = f ? k_ec_pmadd<1> : k_ec_pmadd<0>;
    k<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)P,
                                                          (const uint32_t*)xy, n, xy_bcast);
  }
  return (int)cudaGetLastError();
}

int halo_ec_pdbl(void* out, const void* P, long long n, int f, void* stream) {
  if (n > 0) {
    auto k = f ? k_ec_pdbl<1> : k_ec_pdbl<0>;
    k<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)P, n);
  }
  return (int)cudaGetLastError();
}

// out and state (3, 8, n); consts (174, 8): the field's MDS and round
// constants in Montgomery form (ops/poseidon.py builds it).
int halo_poseidon_permute(void* out, const void* state, const void* consts, long long n, int f,
                          void* stream) {
  if (n > 0) {
    auto k = f ? k_poseidon_permute<1> : k_poseidon_permute<0>;
    const unsigned grid = (unsigned)((n + kPoseidonThreads - 1) / kPoseidonThreads);
    k<<<grid, kPoseidonThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)state, (const uint32_t*)consts, n);
  }
  return (int)cudaGetLastError();
}

// xy is the point-major (npts, 16) table (ops/mont.py passes it so).
int halo_ec_pmadd_scan(void* out, const void* xy, const void* idx, const void* neg, long long R,
                       long long F, long long npts, int f, void* stream) {
  (void)npts;
  if (R > 0 && F > 0) {
    const int g = group_for(F);
    if (f) {
      launch_scan_g<1>(out, xy, idx, neg, R, F, g, (cudaStream_t)stream);
    } else {
      launch_scan_g<0>(out, xy, idx, neg, R, F, g, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

// out (3, 8, n) = k * (x, y) lane by lane; xy (16, n), or (16, 1) when
// xy_bcast; k (8, n) scalar words.
int halo_ec_smul(void* out, const void* xy, const void* k, long long n, int xy_bcast, int f,
                 void* stream) {
  if (n > 0) {
    const int g = group_for(n);
    if (f) {
      launch_smul_g<1>(out, xy, k, n, xy_bcast, g, (cudaStream_t)stream);
    } else {
      launch_smul_g<0>(out, xy, k, n, xy_bcast, g, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

// Registers and local memory (spill) bytes per thread of each kernel as
// loaded (Fp instances; ec_padd, ec_pmadd_scan and ec_smul with G = 1, 2,
// 4), into regs[0..15] and local[0..15]: field_mul, ntt_butterfly,
// ec_padd G1 G2 G4, ec_pmadd_scan G1 G2 G4, ec_pmadd, ec_pdbl, ec_smul G1
// G2 G4, field_add, field_sub, poseidon_permute.
int halo_kernel_registers(int* regs, int* local) {
  const void* fns[] = {(const void*)k_field_mul<0>,        (const void*)k_ntt_butterfly<0>,
                       (const void*)k_ec_padd<0, 1>,       (const void*)k_ec_padd<0, 2>,
                       (const void*)k_ec_padd<0, 4>,       (const void*)k_ec_pmadd_scan<0, 1>,
                       (const void*)k_ec_pmadd_scan<0, 2>, (const void*)k_ec_pmadd_scan<0, 4>,
                       (const void*)k_ec_pmadd<0>,         (const void*)k_ec_pdbl<0>,
                       (const void*)k_ec_smul<0, 1>,       (const void*)k_ec_smul<0, 2>,
                       (const void*)k_ec_smul<0, 4>,       (const void*)k_field_addsub<0, false>,
                       (const void*)k_field_addsub<0, true>, (const void*)k_poseidon_permute<0>};
  for (int i = 0; i < 16; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
    regs[i] = attr.numRegs;
    local[i] = (int)attr.localSizeBytes;
  }
  return 0;
}

}  // extern "C"
