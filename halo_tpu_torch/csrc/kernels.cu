// The port's six CUDA kernels (sm_90a), over the field core in field.cuh.
//
// Layout: limb-major rows.  A batch of N field elements is 8 rows of N
// words (word k of lane i at k*N + i), so neighbouring threads read
// neighbouring addresses; a batch of N projective points is 3 such
// blocks (X, Y, Z).  Every kernel is one thread per lane, ends in
// canonical values, and launches on the caller's stream without
// synchronising.  Each C entry returns cudaGetLastError() as an int.
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
//
// Bounds on an H100: field_mul and ntt_butterfly move 96 bytes per
// element for ~130 integer multiply-adds, so they are memory-bound near
// 3.35 TB/s at large N.  The EC kernels are bound by the 32-bit multiply
// throughput: ec_padd (14 products, 288 bytes a lane), ec_pmadd (13
// products, 256 bytes a lane, 192 with a broadcast operand), ec_pdbl (9
// products, 192 bytes a lane) and ec_pmadd_scan (13 products per step,
// held in registers across R steps, with a random 64-byte gather of the
// affine point per step).  This first version is plain CUDA: one thread
// per lane, no shared memory, no PTX carry chains.
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

__device__ __forceinline__ void load_fe(Fe& r, const uint32_t* base, long long stride, long long i) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = base[k * stride + i];
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

// out[i] = a[i] * b[i] (or b[0] when b_bcast) * R^-1 mod p
__global__ void k_field_mul(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b, long long n, int b_bcast, int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x, y, r;
  load_fe(x, a, n, i);
  if (b_bcast) {
    load_fe(y, b, 1, 0);
  } else {
    load_fe(y, b, n, i);
  }
  halo::fe_mul(r, x, y, f);
  store_fe(out, n, i, r);
}

// One radix-2 decimation-in-time stage over rows of m lanes holding
// blocks of 2*half: for block blk and j < half, with e at blk*2*half + j
// and o at e + half, (e, o) <- (e + w_j*o, e - w_j*o), w_j = tw[j*tw_stride].
__global__ void k_ntt_butterfly(uint32_t* __restrict__ y, const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ tw, long long m, long long half,
                                long long tw_n, long long tw_stride, int f) {
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
  halo::fe_mul(p, o, w, f);
  halo::fe_add(s, e, p, f);
  halo::fe_sub(d, e, p, f);
  store_fe(y, m, ie, s);
  store_fe(y, m, io, d);
}

__global__ void k_ec_padd(uint32_t* __restrict__ out, const uint32_t* __restrict__ P,
                          const uint32_t* __restrict__ Q, long long n, int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, b, r;
  load_pt(a, P, n, i);
  load_pt(b, Q, n, i);
  halo::pt_add(r, a, b, f);
  store_pt(out, n, i, r);
}

// out[i] = P[i] + (x, y), the affine operand xy[:, i] (or xy[:, 0] when
// xy_bcast): x words in rows 0-7 and y words in rows 8-15 of the (16, n)
// or (16, 1) operand.  The affine point must not be the identity.
__global__ void k_ec_pmadd(uint32_t* __restrict__ out, const uint32_t* __restrict__ P,
                           const uint32_t* __restrict__ xy, long long n, int xy_bcast, int f) {
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
  halo::pt_add_affine(r, a, x, y, f);
  store_pt(out, n, i, r);
}

__global__ void k_ec_pdbl(uint32_t* __restrict__ out, const uint32_t* __restrict__ P, long long n,
                          int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, r;
  load_pt(a, P, n, i);
  halo::pt_double(r, a, f);
  store_pt(out, n, i, r);
}

// Lane f_ of F runs a prefix over R sorted points: acc starts at the
// identity; at step t it adds the affine point xy[:, idx[t, f_]] (negated
// when neg[t, f_] != 0) and writes acc to out[:, t, f_].  xy holds the
// x words in rows 0-7 and the y words in rows 8-15 of npts lanes.
__global__ void k_ec_pmadd_scan(uint32_t* __restrict__ out, const uint32_t* __restrict__ xy,
                                const int32_t* __restrict__ idx, const uint8_t* __restrict__ neg,
                                long long R, long long F, long long npts, int f) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= F) return;
  const long long plane = R * F;
  Pt acc;
  halo::pt_identity(acc, f);
  Fe x, y, zero;
  halo::fe_zero(zero);
  for (long long t = 0; t < R; ++t) {
    const long long at = t * F + lane;
    const long long pi = idx[at];
    load_fe(x, xy, npts, pi);
    load_fe(y, xy + 8 * npts, npts, pi);
    if (neg[at]) halo::fe_sub(y, zero, y, f);
    halo::pt_add_affine(acc, acc, x, y, f);
    store_pt(out, plane, at, acc);
  }
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int halo_field_mul(void* out, const void* a, const void* b, long long n, int b_bcast, int f,
                   void* stream) {
  if (n > 0) {
    k_field_mul<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, b_bcast, f);
  }
  return (int)cudaGetLastError();
}

int halo_ntt_butterfly(void* y, const void* x, const void* tw, long long m, long long half,
                       long long tw_n, long long tw_stride, int f, void* stream) {
  if (m > 0) {
    k_ntt_butterfly<<<grid_for(m / 2), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)y, (const uint32_t*)x, (const uint32_t*)tw, m, half, tw_n, tw_stride, f);
  }
  return (int)cudaGetLastError();
}

int halo_ec_padd(void* out, const void* P, const void* Q, long long n, int f, void* stream) {
  if (n > 0) {
    k_ec_padd<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)P, (const uint32_t*)Q, n, f);
  }
  return (int)cudaGetLastError();
}

int halo_ec_pmadd(void* out, const void* P, const void* xy, long long n, int xy_bcast, int f,
                   void* stream) {
  if (n > 0) {
    k_ec_pmadd<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)P, (const uint32_t*)xy, n, xy_bcast, f);
  }
  return (int)cudaGetLastError();
}

int halo_ec_pdbl(void* out, const void* P, long long n, int f, void* stream) {
  if (n > 0) {
    k_ec_pdbl<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((uint32_t*)out,
                                                                   (const uint32_t*)P, n, f);
  }
  return (int)cudaGetLastError();
}

int halo_ec_pmadd_scan(void* out, const void* xy, const void* idx, const void* neg, long long R,
                       long long F, long long npts, int f, void* stream) {
  if (R > 0 && F > 0) {
    k_ec_pmadd_scan<<<grid_for(F), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)xy, (const int32_t*)idx, (const uint8_t*)neg, R, F,
        npts, f);
  }
  return (int)cudaGetLastError();
}

// Registers per thread of each kernel as loaded, in the order field_mul,
// ntt_butterfly, ec_padd, ec_pmadd_scan, ec_pmadd, ec_pdbl, into out[0..5].
int halo_kernel_registers(int* out) {
  const void* fns[] = {(const void*)k_field_mul, (const void*)k_ntt_butterfly,
                       (const void*)k_ec_padd,   (const void*)k_ec_pmadd_scan,
                       (const void*)k_ec_pmadd,  (const void*)k_ec_pdbl};
  for (int i = 0; i < 6; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
    out[i] = attr.numRegs;
  }
  return 0;
}

}  // extern "C"
