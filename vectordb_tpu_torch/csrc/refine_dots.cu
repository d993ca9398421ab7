// Exact f32 refine dots over gathered candidate tiles (kernel K2).
//
// Replaces vectordb_tpu/ops/coarse_kernel.py _refine_dots_kernel (launcher
// _refine_dots, called from _refine_topk) and the int8 branch of
// _refine_topk's gather refine. For each query q and each of its m
// selected 16-row tiles tile_idx[q, j], it computes the dot of the query
// with every row of the tile straight from the stored database:
//   out[q, j*16 + r] = sum_k x[tile_idx[q, j]*16 + r, k] * queries[q, k]
// with x the row as stored, by source:
//   SRC=F32   f32 rows;
//   SRC=BF16  bf16 rows (storage="bf16"), widened exactly to f32, as the
//             JAX kernel's rows.astype(f32) before its HIGHEST dot;
//   SRC=INT8  int8 codes (storage="int8"), widened exactly; the finished
//             dot is multiplied by the row's pow2 scale, in the order of
//             _refine_topk's ``dots * scl2`` (exact: an exponent shift).
// Score assembly, top-k and the certificate stay in torch
// (ops/coarse_kernel._refine_topk), as they do in the JAX package.
//
// Numerics: IEEE f32 only -- fmaf per lane (round to nearest), then a
// butterfly of round-to-nearest adds across the warp. No TF32 and no
// tensor cores, so the error bound the certificates assume for the
// refine (at most d*2^-24*|q||x| from summation in some order) holds.
//
// What bounds it on an H100: the gather. At Q=4096 queries, m=32 tiles,
// d=768 it reads 4096*512*768 rows' elements: 6.4 GB of f32, 3.2 GB of
// bf16 or 1.6 GB of int8 codes for 3.2 GFLOP, at most ~2 flop/byte, far
// below the machine balance, so it is bound by memory traffic (HBM at
// 3.35 TB/s, helped by L2 hits on rows shared between queries). It does
// not materialise the gathered candidates: rows stream once from device
// memory into registers.
//
// What the design does about it: each block takes QPB queries and keeps
// their rows in shared memory; one warp per candidate row reads the row
// with 16-byte loads (4 f32, 8 bf16 or 16 int8 per lane, neighbouring
// lanes on neighbouring addresses), so every row is one fully coalesced
// pass. Only the (Q, m*16) dots are written. The JAX gate d % 128 == 0 is
// a Mosaic tiling fact: this kernel takes any d (scalar loads when a row
// is not 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SRC_F32 = 0;
constexpr int SRC_BF16 = 1;
constexpr int SRC_INT8 = 2;

constexpr int SUB = 16;
constexpr int QPB = 4;          // queries per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// elements per 16-byte load
template <int SRC>
struct Vec {
  static constexpr int N = SRC == SRC_F32 ? 4 : (SRC == SRC_BF16 ? 8 : 16);
};

template <int SRC>
__device__ __forceinline__ float elem(const void* row, int k) {
  if constexpr (SRC == SRC_F32) return static_cast<const float*>(row)[k];
  if constexpr (SRC == SRC_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(row)[k]);
  return static_cast<float>(static_cast<const int8_t*>(row)[k]);
}

// fmaf of one 16-byte chunk of the row (N elements from k) with q[k..]
template <int SRC>
__device__ __forceinline__ float fma_chunk(const void* row, const float* q,
                                           int k, float acc) {
  const uint4 u = *reinterpret_cast<const uint4*>(
      static_cast<const char*>(row) + (long)k * (16 / Vec<SRC>::N));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (SRC == SRC_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(__uint_as_float(w[i]), q[k + i],
                                           acc);
  } else if constexpr (SRC == SRC_BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32: widening is a shift
      acc = fmaf(__uint_as_float(w[i] << 16), q[k + 2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), q[k + 2 * i + 1],
                 acc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc = fmaf(static_cast<float>(static_cast<signed char>(
                       (w[i] >> (8 * b)) & 0xffu)),
                   q[k + 4 * i + b], acc);
  }
  return acc;
}

template <int SRC>
__global__ void __launch_bounds__(THREADS)
refine_dots_kernel(const int64_t* __restrict__ tile_idx,
                   const float* __restrict__ queries,
                   const void* __restrict__ db,
                   const float* __restrict__ scales,
                   float* __restrict__ out, int qp, int m, int d, bool vec) {
  extern __shared__ __align__(16) float qs[];   // QPB x d query rows
  constexpr int V = Vec<SRC>::N;
  constexpr int ITEM = 16 / V;                  // bytes per element
  const int qbase = blockIdx.x * QPB;
  const int nq = min(QPB, qp - qbase);
  for (int i = threadIdx.x; i < nq * d; i += THREADS)
    qs[i] = queries[(long)qbase * d + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = m * SUB;
  for (int job = warp; job < nq * rows; job += WARPS) {
    const int qi = job / rows, c = job % rows;
    const long tile = tile_idx[(long)(qbase + qi) * m + c / SUB];
    const long r = tile * SUB + c % SUB;
    const void* x = static_cast<const char*>(db) + r * (long)d * ITEM;
    const float* q = qs + qi * d;
    float acc = 0.0f;
    if (vec) {
      for (int k = lane * V; k < d; k += 32 * V)
        acc = fma_chunk<SRC>(x, q, k, acc);
    } else {
      for (int k = lane; k < d; k += 32) acc = fmaf(elem<SRC>(x, k), q[k],
                                                    acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (SRC == SRC_INT8) acc = __fmul_rn(acc, scales[r]);
    if (lane == 0) out[(long)(qbase + qi) * rows + c] = acc;
  }
}

template <int SRC>
int launch(const void* tile_idx, const void* queries, const void* db,
           const void* scales, void* out, int qp, int m, int d,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * QPB * (size_t)d;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_dots_kernel<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte loads need every row (and its chunks) 16-byte aligned
  const bool vec = (d % Vec<SRC>::N) == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0;
  const int blocks = (qp + QPB - 1) / QPB;
  refine_dots_kernel<SRC><<<blocks, THREADS, smem, stream>>>(
      static_cast<const int64_t*>(tile_idx),
      static_cast<const float*>(queries), db,
      static_cast<const float*>(scales), static_cast<float*>(out), qp, m, d,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). tile_idx (qp, m) int64, queries
// (qp, d) f32, db (n, d) of the source's type, scales (n,) f32 for
// src 2 (else unused), out (qp, m*16) f32, all contiguous.
// src: 0 f32 rows, 1 bf16 rows, 2 int8 codes with pow2 row scales.
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int vdb_refine_dots(const void* tile_idx, const void* queries,
                               const void* db, const void* scales, void* out,
                               int qp, int m, int d, int src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src == SRC_F32)
    return launch<SRC_F32>(tile_idx, queries, db, scales, out, qp, m, d, s);
  if (src == SRC_BF16)
    return launch<SRC_BF16>(tile_idx, queries, db, scales, out, qp, m, d, s);
  if (src == SRC_INT8)
    return launch<SRC_INT8>(tile_idx, queries, db, scales, out, qp, m, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
