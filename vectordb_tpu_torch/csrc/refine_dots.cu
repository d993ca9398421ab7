// Exact f32 refine dots over gathered candidate tiles (kernel K2).
//
// Replaces vectordb_tpu/ops/coarse_kernel.py _refine_dots_kernel (launcher
// _refine_dots, called from _refine_topk). For each query q and each of
// its m selected 16-row tiles tile_idx[q, j], it computes the dot of the
// query with every row of the tile straight from the f32 database:
//   out[q, j*16 + r] = sum_k db[tile_idx[q, j]*16 + r, k] * queries[q, k]
// Score assembly, top-k and the certificate stay in torch
// (ops/coarse_kernel._refine_topk), as they do in the JAX package.
//
// Numerics: IEEE f32 only -- fmaf per lane (round to nearest), then a
// butterfly of round-to-nearest adds across the warp. No TF32 and no
// tensor cores, so the error bound the certificates assume for the
// refine (at most d*2^-24*|q||x| from summation in some order) holds.
//
// What bounds it on an H100: the gather. At Q=4096 queries, m=32 tiles,
// d=768 it reads 4096*512*768*4 B = 6.4 GB of database rows for 3.2 GFLOP,
// ~0.5 flop/byte, far below the machine balance, so it is bound by memory
// traffic (HBM at 3.35 TB/s, helped by L2 hits on rows shared between
// queries). It does not materialise the gathered candidates: rows stream
// once from device memory into registers.
//
// What the design does about it: each block takes QPB queries and keeps
// their rows in shared memory; one warp per candidate row reads the row
// with 16-byte loads (neighbouring lanes on neighbouring addresses), so
// every row is one fully coalesced pass. Only the (Q, m*16) dots are
// written. The JAX gate d % 128 == 0 is a Mosaic tiling fact: this kernel
// takes any d (scalar loads when d % 4 != 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 16;
constexpr int QPB = 4;          // queries per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
refine_dots_kernel(const int64_t* __restrict__ tile_idx,
                   const float* __restrict__ queries,
                   const float* __restrict__ db, float* __restrict__ out,
                   int qp, int m, int d, bool vec4) {
  extern __shared__ __align__(16) float qs[];   // QPB x d query rows
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
    const float* x = db + (tile * SUB + c % SUB) * (long)d;
    const float* q = qs + qi * d;
    float acc = 0.0f;
    if (vec4) {
      for (int k = lane * 4; k < d; k += 128) {
        const float4 xv = *reinterpret_cast<const float4*>(x + k);
        const float4 qv = *reinterpret_cast<const float4*>(q + k);
        acc = fmaf(xv.x, qv.x, acc);
        acc = fmaf(xv.y, qv.y, acc);
        acc = fmaf(xv.z, qv.z, acc);
        acc = fmaf(xv.w, qv.w, acc);
      }
    } else {
      for (int k = lane; k < d; k += 32) acc = fmaf(x[k], q[k], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[(long)(qbase + qi) * rows + c] = acc;
  }
}

}  // namespace

// C interface (loaded with ctypes). tile_idx (qp, m) int64, queries
// (qp, d) f32, db (n, d) f32, out (qp, m*16) f32, all contiguous.
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int vdb_refine_dots(const void* tile_idx, const void* queries,
                               const void* db, void* out, int qp, int m,
                               int d, void* stream) {
  const size_t smem = sizeof(float) * QPB * (size_t)d;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (qp + QPB - 1) / QPB;
  refine_dots_kernel<<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(tile_idx),
      static_cast<const float*>(queries), static_cast<const float*>(db),
      static_cast<float*>(out), qp, m, d, (d % 4) == 0);
  return static_cast<int>(cudaGetLastError());
}
