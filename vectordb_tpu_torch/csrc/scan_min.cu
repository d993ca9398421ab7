// Per-tile minima of f32 distances (kernel K9).
//
// Replaces vectordb_tpu/ops/flat_kernel.py _scan_min_kernel (launcher
// tile_minima, called from two_phase_search). For every query q and every
// tile of tile_rows consecutive database rows it computes
//   out[q, t] = min over rows x of tile t of score(q, x)
// with the JAX kernel's three score forms (flat_kernel.py:61-70):
//   euclidean  max((qaux[q] + raux[x]) - 2 q.x, 0) + inv[x] * 1e30
//              (qaux, raux: squared norms)
//   dot        -q.x + inv[x] * 1e30
//   cosine     -(q.x / den) + inv[x] * 1e30, den = qaux[q] * raux[x]
//              (norms), a zero den taken as 1
// inv[x] is 1.0 for a dead row, 0.0 for a live one. The output is (Q, T),
// the layout tile_minima returns (the TPU kernel wrote (T, Q) and
// transposed: Mosaic wanted lane-aligned output blocks).
//
// Numerics: IEEE f32 only. Each dot is a chain of fmaf over k = 0..d-1 in
// order, no TF32 and no tensor cores, as the JAX kernel's f32 dot and the
// refine that trusts it; the epilogue uses explicit round-to-nearest
// intrinsics so nvcc contracts nothing into an fma.
//
// What bounds it on an H100: operations. 2*Q*N*d flops at the f32 rate
// outside the tensor cores (67 TFLOP/s); at Q=1024, N=2^20, d=768 that is
// 1.65 TFLOP, ~25 ms, against 3.2 GB of rows read once (~1 ms).
//
// What the design does about it: a SIMT shared-memory tiled product. A
// block takes 128 queries x one row tile and walks the tile in 128-row
// steps; each step stages 8-wide k slices of both operands in shared
// memory and each of its 256 threads keeps an 8 x 8 register tile of dots
// (two 4-wide groups per side, so the shared-memory reads are 16-byte and
// conflict-free). The staging stores are transposed: a warp reads 8
// consecutive k of 4 rows (32-byte global sectors) and writes them down 8
// columns of the shared arrays, whose rows are padded by 4 floats so those
// 32 stores land in 32 distinct banks. The (Q, N) score matrix never
// leaves registers: each
// thread folds its scores into 8 running minima, and a 16-lane shuffle
// reduction finishes the tile's minimum per query.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;        // queries per block
constexpr int BR = 128;        // rows per step
constexpr int BK = 8;          // k slice
constexpr int PAD = 4;         // shared row padding: conflict-free staging
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 dots each
constexpr float PENALTY = 1e30f;
constexpr int EUCLID = 0, DOT = 1, COSINE = 2;

template <int MODE>
__device__ __forceinline__ float score(float dot, float qa, float ra,
                                       float inv) {
  const float pen = __fmul_rn(inv, PENALTY);
  if (MODE == EUCLID) {
    const float d2 = __fsub_rn(__fadd_rn(qa, ra), __fmul_rn(2.0f, dot));
    return __fadd_rn(fmaxf(d2, 0.0f), pen);
  }
  if (MODE == DOT) return __fadd_rn(-dot, pen);
  float den = __fmul_rn(qa, ra);
  if (den == 0.0f) den = 1.0f;
  return __fadd_rn(-__fdiv_rn(dot, den), pen);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
scan_min_kernel(const float* __restrict__ q, const float* __restrict__ qaux,
                const float* __restrict__ db, const float* __restrict__ raux,
                const float* __restrict__ inv, float* __restrict__ out,
                int nq, int d, int tile_rows, int ntiles) {
  __shared__ __align__(16) float qs[BK][BQ + PAD];
  __shared__ __align__(16) float rs[BK][BR + PAD];
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16;          // row lanes
  const int ty = threadIdx.x / 16;          // query lanes
  const long tstart = (long)tile * tile_rows;
  const long tend = tstart + tile_rows;

  // this thread's queries: q0 + ty*4 + {0..3} and q0 + 64 + ty*4 + {0..3}
  float qa[8], runmin[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + (i / 4) * 64 + ty * 4 + (i % 4);
    qa[i] = qi < nq ? qaux[qi] : 0.0f;
    runmin[i] = __int_as_float(0x7f800000);  // +inf
  }

  for (long r0 = tstart; r0 < tend; r0 += BR) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // stage a BK-wide slice of 128 queries and 128 rows, transposed
#pragma unroll
      for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
        const int i = e / BK, kk = e % BK;
        const int k = k0 + kk;
        const int qi = q0 + i;
        qs[kk][i] = (qi < nq && k < d) ? q[(long)qi * d + k] : 0.0f;
        const long ri = r0 + i;
        rs[kk][i] = (ri < tend && k < d) ? db[ri * d + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&qs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&rs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&rs[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this step's scores into the running minima
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long r = r0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (r >= tend) continue;
      const float ra = raux[r], iv = inv[r];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        runmin[i] = fminf(runmin[i], score<MODE>(acc[i][j], qa[i], ra, iv));
    }
  }

  // minimum across the 16 row lanes of each query (lanes tx of one ty
  // are 16 consecutive lanes of a warp)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = runmin[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int qi = q0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (tx == 0 && qi < nq) out[(long)qi * ntiles + tile] = v;
  }
}

template <int MODE>
int launch(const void* q, const void* qaux, const void* db, const void* raux,
           const void* inv, void* out, int nq, int d, int tile_rows,
           int ntiles, cudaStream_t stream) {
  const dim3 grid(ntiles, (nq + BQ - 1) / BQ);
  scan_min_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qaux),
      static_cast<const float*>(db), static_cast<const float*>(raux),
      static_cast<const float*>(inv), static_cast<float*>(out), nq, d,
      tile_rows, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). q (nq, d), qaux (nq,), db (n, d), raux
// (n,), inv (n,) f32; out (nq, n / tile_rows) f32; all contiguous, n a
// multiple of tile_rows. mode: 0 euclidean, 1 dot, 2 cosine. Launches on
// ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int vdb_scan_min(const void* q, const void* qaux, const void* db,
                            const void* raux, const void* inv, void* out,
                            long n, int nq, int d, int tile_rows, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || n <= 0) return 0;
  const int ntiles = static_cast<int>(n / tile_rows);
  if (mode == EUCLID)
    return launch<EUCLID>(q, qaux, db, raux, inv, out, nq, d, tile_rows,
                          ntiles, s);
  if (mode == DOT)
    return launch<DOT>(q, qaux, db, raux, inv, out, nq, d, tile_rows,
                       ntiles, s);
  if (mode == COSINE)
    return launch<COSINE>(q, qaux, db, raux, inv, out, nq, d, tile_rows,
                          ntiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
