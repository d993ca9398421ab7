// Per-tile minima of f32 scores (kernel K9): a pipelined SIMT product with
// the minima fused into its epilogue.
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
// outside the tensor cores (67 TFLOP/s; "f32 means IEEE f32, never TF32"
// keeps it off them, so cuBLAS's SIMT SGEMM is its yardstick): at Q=1024,
// N=2^20, d=768 that is 1.65 TFLOP, ~25 ms, against 3.2 GB of rows read
// once (~1 ms). Two things keep a simple tiled kernel far from that: loads
// whose latency no computation hides, and operand traffic from L2 (a block
// that stages its 128 queries again for every 128 rows moves ~51 GB from
// L2 per call at that shape).
//
// What the design does about it:
//   - Block tile: 128 queries x 128 rows per step, 256 threads, an 8 x 8
//     register tile of dots each (queries 4 ty + {0..3} and 64 + 4 ty +
//     {0..3}, rows likewise from tx; ty, tx < 16): per k a thread reads 2
//     query float4 and 2 row float4 from shared memory for 64 independent
//     FMAs, so 16 operand registers feed the 64 accumulators.
//   - A ring of STAGES k slices in shared memory, k-major ([k][row], rows
//     padded to 132 floats), filled by cp.async: 4-byte copies, each warp
//     copying 4 rows x 8 of k at a time (one 32-byte sector a row from
//     device memory, 32 distinct banks in shared memory), zero-filled past
//     d and past the last row or query, so any d and any alignment take
//     the same path. One commit group and one barrier a slice: the copies
//     of slice s + STAGES - 1 are in flight while slice s is multiplied,
//     and the ring runs on across a block's 128-row steps, so the next
//     step's first slices load during this step's epilogue.
//   - A block owns whole tiles (about BLOCK_ROWS rows) and one 128-query
//     block; the blocks that share rows are numbered together (query block
//     fastest), so rows come from HBM about once and the queries stay in
//     L2. 68 KB of shared memory and at most 128 registers a thread let
//     two blocks share an SM.
//   - Epilogue in registers, per 128-row step: the 64 scores; then for
//     each tile the step touches, each lane's minimum over its rows of the
//     tile, a 16-lane shuffle reduction, and a running minimum across
//     steps that the writing lane keeps in shared memory (its own slot: no
//     barrier). Any tile_rows -- several tiles a step, or many steps a
//     tile -- takes the same code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;            // queries per block
constexpr int BR = 128;            // rows per step
constexpr int BK = 16;             // k per slice
constexpr int LDM = BR + 4;        // padded k-row of a slice, floats
constexpr int STAGES = 4;          // slices in the ring
constexpr int THREADS = 256;       // 16 x 16 threads, 8 x 8 dots each
constexpr int BLOCK_ROWS = 512;    // rows a block aims to own
constexpr int STAGE_FLOATS = 2 * BK * LDM;     // queries, then rows
constexpr int SMEM_BYTES = (STAGES * STAGE_FLOATS + BQ) * 4;
constexpr float PENALTY = 1e30f;
constexpr int EUCLID = 0, DOT = 1, COSINE = 2;
static_assert(BQ == BR, "one copy pattern serves both operands");

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

// asynchronous 4-byte copy into shared memory; 0 bytes: zero-filled
__device__ __forceinline__ void cp4(uint32_t dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the block-local query (from ty) or row (from tx) of a thread's i-th of 8
__device__ __forceinline__ int lane_row(int lane16, int i) {
  return (i >> 2) * 64 + lane16 * 4 + (i & 3);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
scan_min_kernel(const float* __restrict__ q, const float* __restrict__ qaux,
                const float* __restrict__ db, const float* __restrict__ raux,
                const float* __restrict__ inv, float* __restrict__ out,
                int nq, int d, long n, int tile_rows, int ntiles,
                int tiles_per_block, int n_qblocks) {
  extern __shared__ __align__(16) float smem[];
  float* carry = smem + STAGES * STAGE_FLOATS;   // [BQ] running minima
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const long rstart =
      static_cast<long>(blockIdx.x / n_qblocks) * tiles_per_block * tile_rows;
  const long rlim = rstart + static_cast<long>(tiles_per_block) * tile_rows;
  const long rend = rlim < n ? rlim : n;
  const int tx = threadIdx.x % 16;          // row lanes
  const int ty = threadIdx.x / 16;          // query lanes
  const int nk = d > 0 ? (d + BK - 1) / BK : 1;
  const int total = static_cast<int>((rend - rstart + BR - 1) / BR) * nk;
  if (tx == 0) {                            // the slots this lane writes
#pragma unroll
    for (int i = 0; i < 8; ++i)
      carry[lane_row(ty, i)] = __int_as_float(0x7f800000);
  }

  // the copies of a slice, the same pattern for both operands: pass (u, h)
  // of warp w moves rows 32 u + 4 w + lane / 8 at k = 8 h + lane % 8
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int crow = 4 * warp + lane / 8, ck = lane % 8;
  const uint32_t cdst = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + ck * LDM + crow));
  const float* qblk = q + static_cast<long>(q0) * d;
  int lk = 0;
  long lr = rstart;                         // first row of the slice
  auto issue = [&](int g) {
    if (g < total) {
      const uint32_t st = cdst + (g % STAGES) * STAGE_FLOATS * 4;
      const float* rblk = db + lr * d;
      const int qleft = nq - q0 - crow;     // this lane's rows in range:
      const int rleft = static_cast<int>(rend - lr) - crow;  // 32 u < left
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
#pragma unroll
        for (int h = 0; h < BK / 8; ++h) {
          const int k = lk * BK + 8 * h + ck;
          const int off = (crow + 32 * u) * d + k;   // within 128 rows
          const uint32_t at = st + (8 * h * LDM + 32 * u) * 4;
          const bool qok = k < d && 32 * u < qleft;
          const bool rok = k < d && 32 * u < rleft;
          cp4(at, qok ? qblk + off : q, qok ? 4 : 0);
          cp4(at + BK * LDM * 4, rok ? rblk + off : db, rok ? 4 : 0);
        }
      }
      if (++lk == nk) {
        lk = 0;
        lr += BR;
      }
    }
    cp_commit();                            // empty groups keep the count
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) issue(g);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  int kb = 0;
  long r0 = rstart;
  for (int g = 0; g < total; ++g) {
    cp_wait<STAGES - 2>();                  // this thread's copies of g
    __syncthreads();                        // everyone's; g - 1 is done
    issue(g + STAGES - 1);                  // into g - 1's stage
    const float* qs = smem + (g % STAGES) * STAGE_FLOATS;
    const float* rs = qs + BK * LDM;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(qs + k * LDM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(qs + k * LDM + 64 + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(rs + k * LDM + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(rs + k * LDM + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (++kb < nk) continue;

    // ---- the step's last slice: fold its scores into the tile minima ----
    kb = 0;
    // rows [r0, r0 + nr) of this step; tile t covers its rows [lo, hi)
    const int nr = rend - r0 < BR ? static_cast<int>(rend - r0) : BR;
    float qa[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + lane_row(ty, i);
      qa[i] = qi < nq ? qaux[qi] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = lane_row(tx, j);
      const float ra = r < nr ? raux[r0 + r] : 0.0f;
      const float iv = r < nr ? inv[r0 + r] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i][j] = score<MODE>(acc[i][j], qa[i], ra, iv);
    }
    for (long t = r0 / tile_rows; t * tile_rows < r0 + nr; ++t) {
      const long t0 = t * tile_rows - r0;   // the tile's rows, step-relative
      const int lo = t0 > 0 ? static_cast<int>(t0) : 0;
      const int hi = t0 + tile_rows < nr ? static_cast<int>(t0 + tile_rows)
                                         : nr;
      float m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = __int_as_float(0x7f800000);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = lane_row(tx, j);
        if (r >= lo && r < hi) {
#pragma unroll
          for (int i = 0; i < 8; ++i) m[i] = fminf(m[i], acc[i][j]);
        }
      }
      // minimum across the 16 row lanes of each query (lanes tx of one ty
      // are 16 consecutive lanes of a warp)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          m[i] = fminf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
      if (tx == 0) {
        const bool ends = hi == t0 + tile_rows;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ql = lane_row(ty, i);
          const float v = fminf(carry[ql], m[i]);
          if (ends && q0 + ql < nq)
            out[static_cast<long>(q0 + ql) * ntiles + t] = v;
          carry[ql] = ends ? __int_as_float(0x7f800000) : v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    r0 += BR;
  }
  cp_wait<0>();                             // no copy outlives the block
}

template <int MODE>
int launch(const void* q, const void* qaux, const void* db, const void* raux,
           const void* inv, void* out, long n, int nq, int d, int tile_rows,
           cudaStream_t stream) {
  const int ntiles = static_cast<int>(n / tile_rows);
  const int tpb = tile_rows >= BLOCK_ROWS ? 1 : BLOCK_ROWS / tile_rows;
  const int n_qblocks = (nq + BQ - 1) / BQ;
  const long blocks = (ntiles + tpb - 1) / tpb * static_cast<long>(n_qblocks);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      scan_min_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_min_kernel<MODE><<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                          stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qaux),
      static_cast<const float*>(db), static_cast<const float*>(raux),
      static_cast<const float*>(inv), static_cast<float*>(out), nq, d, n,
      tile_rows, ntiles, tpb, n_qblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). q (nq, d), qaux (nq,), db (n, d), raux
// (n,), inv (n,) f32; out (nq, n / tile_rows) f32; all contiguous, n a
// multiple of tile_rows >= 1. mode: 0 euclidean, 1 dot, 2 cosine. Launches
// on ``stream``, allocates nothing, returns a cudaError_t.
extern "C" int vdb_scan_min(const void* q, const void* qaux, const void* db,
                            const void* raux, const void* inv, void* out,
                            long n, int nq, int d, int tile_rows, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || n <= 0) return 0;
  if (tile_rows < 1 || n % tile_rows != 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == EUCLID)
    return launch<EUCLID>(q, qaux, db, raux, inv, out, n, nq, d, tile_rows,
                          s);
  if (mode == DOT)
    return launch<DOT>(q, qaux, db, raux, inv, out, n, nq, d, tile_rows, s);
  if (mode == COSINE)
    return launch<COSINE>(q, qaux, db, raux, inv, out, n, nq, d, tile_rows,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}
