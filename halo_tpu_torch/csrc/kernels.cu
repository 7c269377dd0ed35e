// The port's ten CUDA kernels (sm_90a), over the field core in field.cuh.
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
//   ntt_butterfly  _bfly_kernel :459, one radix-2 stage per launch (on no
//                  path: the counterpart of the TPU kernel, held against its
//                  plain version)
//   ntt_pass       _bfly_kernel :459 together with the gather and the stage
//                  loop of halo_tpu/ops/ntt.py:_ntt_rows_fn :211-245: up to
//                  10 stages a launch in shared memory, at most 3 launches
//                  a transform of n <= 2^24
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
// Bounds on an H100: field_mul moves 96 bytes per element for one field
// product and ntt_butterfly 64 bytes for half a product, so they are
// memory-bound near 3.35 TB/s at large N; they are one thread per lane.
// A whole transform is not: log2(n) / 2 products an element against 64
// bytes in and out (n = 2^20: 10 products, 0.085 ms of multiply-adds
// against 0.012 ms of bytes at (8, 2^20)), so ntt_pass keeps a tile in
// shared memory for as many stages as it holds (10 in the first pass,
// 7 in a later one) and crosses device memory once a pass instead of
// once a stage; each butterfly is one product, one add and one subtract
// on a tile's words, its twiddle one 32-byte load through L1 (an
// element-major copy of the table).  field_addsub moves the same
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
// launch, the state in registers for all 55 rounds.  The 9 MDS entries and
// 165 round constants (Montgomery form, one (174, 8) device tensor per
// field) are copied into shared memory by each block.  At the batch's
// 8,192 states one thread a state left 2 warps an SM, so one state's
// latency was the launch's time: 0.43 ms against a 0.083 ms bound (19%;
// 1.47 ms against 0.66 ms at 2^16 states; 84 registers; chip_smoke.py on
// an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  So three threads of a warp
// own a state, one word each (ten states a warp, two lanes repeating
// others): a round's 21 products become 7 a thread (its sbox, its MDS
// row) and two 8-word exchanges by __shfl_sync, three times the warps
// at the same width.  A group of 4 would split the 9 MDS products no
// better (3 rows) and leave a quarter of the lanes idle, not 2 of 32.
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

constexpr int kNttTileLog = 10;  // a block of ntt_pass holds 2^10 elements: 32 KB
constexpr int kNttColsLog = 3;   // a later pass's tile: 8 consecutive low offsets a row

// Radix-2 DIT stages s0 + 1 .. s0 + j of k transforms of size n = 2^log_n,
// the (8, M = k n) rows x, into y.  Stage s pairs the positions whose
// index differs in bit s - 1, e below o: (e, o) <- (e + w o, e - w o) with
// w = W[(e mod 2^(s-1)) n / 2^s], W the twiddle table w^i R (i < n/2),
// element-major, one twiddle a 32-byte row (tw[2i], tw[2i + 1]).  With
// s0 = 0 position i is read from x at bit-reverse(i); with scale non-null
// every output is multiplied by the one element scale[0..7] (n^-1 R, the
// inverse's last pass).
//
// A block owns a tile of E = C 2^j elements of one transform, C = 2^c_log:
// rows t < 2^j of C consecutive low offsets c, at positions base + c +
// t 2^s0 (base's low s0 bits are the offset b0 of column 0).  Stages s0 + 1
// .. s0 + j pair rows within a column, so the tile runs them all in shared
// memory, [word][element] like the rows in device memory, with one
// __syncthreads() a stage, and is read once and written once.  With s0 > 0,
// C = min(8, 2^s0): eight columns make each 32-byte sector of a word row
// whole, so the strided rows still load and store coalesced.  The first
// pass (s0 = 0, C = 1) owns 2^j consecutive positions; tile g of a
// transform is the one at rev(g) 2^j, whose input rows rev_j(t)
// 2^(log_n - j) + g lie next to those of tiles g +- 1, so neighbouring
// blocks share each sector.
template <int F>
__global__ void __launch_bounds__(kThreads) k_ntt_pass(uint32_t* __restrict__ y,
                                                       const uint32_t* __restrict__ x,
                                                       const uint4* __restrict__ tw,
                                                       const uint32_t* __restrict__ scale,
                                                       long long M, int log_n, int s0, int j) {
  __shared__ uint32_t sm[8 << kNttTileLog];
  const int c_log = s0 < kNttColsLog ? s0 : kNttColsLog;
  const int e_log = c_log + j;
  const int E = 1 << e_log;
  const int C = 1 << c_log;
  const long long n = 1LL << log_n;
  const long long tiles = n >> e_log;  // a transform's tiles
  const long long poly = (long long)blockIdx.x / tiles;
  const long long g = (long long)blockIdx.x - poly * tiles;
  long long base;
  if (s0 == 0) {
    base = log_n == j ? 0 : (long long)(__brev((unsigned)g) >> (32 - (log_n - j))) << j;
  } else {
    const long long across = (1LL << s0) >> c_log;  // tiles across the low offsets
    base = ((g / across) << (s0 + j)) + ((g % across) << c_log);
  }
  const long long b0 = base & ((1LL << s0) - 1);
  const uint32_t* xp = x + poly * n;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long pos = base + (e & (C - 1)) + ((long long)(e >> c_log) << s0);
    const long long src = s0 == 0 ? (long long)(__brev((unsigned)pos) >> (32 - log_n)) : pos;
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[(k << e_log) + e] = xp[k * M + src];
  }
  __syncthreads();
  for (int l = 0; l < j; ++l) {
    const long long tw_step = n >> (s0 + 1 + l);
    for (int bf = threadIdx.x; bf < E / 2; bf += blockDim.x) {
      const int c = bf & (C - 1), q = bf >> c_log;
      const int t_lo = q & ((1 << l) - 1);
      const int ie = ((((q >> l) << (l + 1)) + t_lo) << c_log) + c;
      const int io = ie + (C << l);
      const long long ti = (b0 + c + ((long long)t_lo << s0)) * tw_step;
      const uint4 w0 = __ldg(tw + 2 * ti), w1 = __ldg(tw + 2 * ti + 1);
      Fe a, b, w, p;
      w.w[0] = w0.x, w.w[1] = w0.y, w.w[2] = w0.z, w.w[3] = w0.w;
      w.w[4] = w1.x, w.w[5] = w1.y, w.w[6] = w1.z, w.w[7] = w1.w;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a.w[k] = sm[(k << e_log) + ie];
        b.w[k] = sm[(k << e_log) + io];
      }
      halo::fe_mul<F>(p, b, w);
      halo::fe_add<F>(b, a, p);
      halo::fe_sub<F>(a, a, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sm[(k << e_log) + ie] = b.w[k];
        sm[(k << e_log) + io] = a.w[k];
      }
    }
    __syncthreads();
  }
  Fe sc;
  if (scale != nullptr) load_fe(sc, scale, 1, 0);
  uint32_t* yp = y + poly * n;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long pos = base + (e & (C - 1)) + ((long long)(e >> c_log) << s0);
    Fe v;
#pragma unroll
    for (int k = 0; k < 8; ++k) v.w[k] = sm[(k << e_log) + e];
    if (scale != nullptr) halo::fe_mul<F>(v, v, sc);
    store_fe(yp, M, pos, v);
  }
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
constexpr int kPoseidonLanes = 30;  // lanes of a warp that own a state word: 10 states
constexpr int kPoseidonStates = kPoseidonLanes / 3;

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
//
// Three threads own a state, thread c its word c: each round it raises its
// word to the 7th power, receives the other two words' powers by 16
// __shfl_sync, and computes row c of the MDS (its row held in registers,
// in the order of the words it receives) plus its round constant: 7
// products a thread a round in place of 21.  Lanes 0-29 of a warp hold
// states 10 w .. 10 w + 9; lanes 30 and 31 repeat lanes 27 and 28 (state
// 10 w + 9, roles 0 and 1) and store nothing, and a state index past n
// repeats state n - 1 and stores nothing, so every lane of a warp with a
// live state takes part in every shuffle.
template <int F>
__global__ void __launch_bounds__(kPoseidonThreads) k_poseidon_permute(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ state,
    const uint32_t* __restrict__ consts, long long n) {
  __shared__ uint32_t sc[kPoseidonConsts * 8];
  for (int k = threadIdx.x; k < kPoseidonConsts * 8; k += blockDim.x) sc[k] = consts[k];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long first = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kPoseidonStates;
  if (first >= n) return;  // the whole warp
  const int slot = lane < kPoseidonLanes ? lane / 3 : kPoseidonStates - 1;
  const int role = lane < kPoseidonLanes ? lane - 3 * slot : lane - kPoseidonLanes;
  long long i = first + slot;
  const bool live = lane < kPoseidonLanes && i < n;
  if (i >= n) i = n - 1;
  const int r1 = role == 2 ? 0 : role + 1, r2 = role == 0 ? 2 : role - 1;
  const int src1 = 3 * slot + r1, src2 = 3 * slot + r2;
  Fe m0, m1, m2, s;
  load_fe_shared(m0, sc + 8 * (3 * role + role));
  load_fe_shared(m1, sc + 8 * (3 * role + r1));
  load_fe_shared(m2, sc + 8 * (3 * role + r2));
  load_fe(s, state + 8 * role * n, n, i);
#pragma unroll 1
  for (int r = 0; r < kPoseidonRounds; ++r) {
    fe_pow7<F>(s);
    Fe a, b, acc, prod;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a.w[k] = __shfl_sync(0xffffffffu, s.w[k], src1);
      b.w[k] = __shfl_sync(0xffffffffu, s.w[k], src2);
    }
    halo::fe_mul<F>(acc, m0, s);
    halo::fe_mul<F>(prod, m1, a);
    halo::fe_add<F>(acc, acc, prod);
    halo::fe_mul<F>(prod, m2, b);
    halo::fe_add<F>(acc, acc, prod);
    load_fe_shared(prod, sc + 8 * (9 + 3 * r + role));
    halo::fe_add<F>(s, acc, prod);
  }
  if (live) store_fe(out + 8 * role * n, n, i, s);
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

// y, x (8, M), M a multiple of n = 2^log_n; tw the (n / 2, 8) twiddle
// table; scale one element (8 words) or null.  A plan ntt_pass cannot
// run (a tile above 2^kNttTileLog elements, stages past log_n) returns
// cudaErrorInvalidValue and launches nothing.
int halo_ntt_pass(void* y, const void* x, const void* tw, const void* scale, long long M,
                  int log_n, int s0, int j, int f, void* stream) {
  const int c_log = s0 < kNttColsLog ? s0 : kNttColsLog;
  if (log_n < 1 || log_n > 30 || s0 < 0 || j < 1 || s0 + j > log_n ||
      c_log + j > kNttTileLog || M <= 0 || (M & ((1LL << log_n) - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = M >> (c_log + j);
  const int half = 1 << (c_log + j - 1);  // butterflies a stage
  const int threads = half < 32 ? 32 : half > kThreads ? kThreads : half;
  auto k = f ? k_ntt_pass<1> : k_ntt_pass<0>;
  k<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)y, (const uint32_t*)x, (const uint4*)tw, (const uint32_t*)scale, M, log_n, s0,
      j);
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
    const long long warps = (n + kPoseidonStates - 1) / kPoseidonStates;
    const unsigned grid = (unsigned)((32 * warps + kPoseidonThreads - 1) / kPoseidonThreads);
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
// 4), into regs[0..16] and local[0..16]: field_mul, ntt_butterfly,
// ec_padd G1 G2 G4, ec_pmadd_scan G1 G2 G4, ec_pmadd, ec_pdbl, ec_smul G1
// G2 G4, field_add, field_sub, poseidon_permute, ntt_pass.
int halo_kernel_registers(int* regs, int* local) {
  const void* fns[] = {(const void*)k_field_mul<0>,        (const void*)k_ntt_butterfly<0>,
                       (const void*)k_ec_padd<0, 1>,       (const void*)k_ec_padd<0, 2>,
                       (const void*)k_ec_padd<0, 4>,       (const void*)k_ec_pmadd_scan<0, 1>,
                       (const void*)k_ec_pmadd_scan<0, 2>, (const void*)k_ec_pmadd_scan<0, 4>,
                       (const void*)k_ec_pmadd<0>,         (const void*)k_ec_pdbl<0>,
                       (const void*)k_ec_smul<0, 1>,       (const void*)k_ec_smul<0, 2>,
                       (const void*)k_ec_smul<0, 4>,       (const void*)k_field_addsub<0, false>,
                       (const void*)k_field_addsub<0, true>, (const void*)k_poseidon_permute<0>,
                       (const void*)k_ntt_pass<0>};
  for (int i = 0; i < 17; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
    regs[i] = attr.numRegs;
    local[i] = (int)attr.localSizeBytes;
  }
  return 0;
}

}  // extern "C"
