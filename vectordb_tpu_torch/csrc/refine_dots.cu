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
// Numerics: IEEE f32 only -- fmaf per lane (round to nearest), then
// round-to-nearest adds across the warp. No TF32 and no tensor cores, so
// the error bound the certificates assume for the refine (at most
// d*2^-24*|q||x| from summation in any order) holds.
//
// Two bodies, chosen by shape in ops/cuda_kernels._refine_route:
//
// "tile_major" (refine_tiles_kernel), for 16-byte aligned rows whose
// elements a lane reads 16 (bf16, f32) or 8 (int8) bytes at a time (d % 4
// == 0 for f32, d % 8 == 0 for bf16 and int8) and whose 16-row tile fits
// twice in shared memory.
//   What bounds it on an H100: the distinct candidate rows, read once from
//   HBM. At Q=4096, m=32, d=768 the 131072 (query, tile) pairs name ~42k
//   distinct tiles: 2.09 GB of f32 rows (0.625 ms at 3.35 TB/s), 1.04 GB of
//   bf16, 0.52 GB of codes; the 3.2 GFLOP of f32 FMA take 0.048 ms at 67
//   TFLOP/s. A query-major walk reads every pair's tile on its own, ~3.1x
//   those bytes.
//   What the design does about it:
//     - The wrapper groups the pairs by tile: one stable sort of the tile
//       ids (torch, on the device) gives the pair ids in tile order.
//       Blocks take windows of WINDOW = 32 sorted pairs; a window splits
//       into segments of one tile (a ballot over the window's tile ids),
//       and each segment is a work item: one tile and at most 32 of the
//       queries that chose it, so a tile every query chose cannot hold one
//       block for the whole batch. A tile whose run crosses a window edge
//       is read once per window.
//     - Persistent blocks (one an SM) walk the windows. One producer
//       thread reads the work list ahead and copies each segment's tile --
//       one contiguous run of 16*d*itemsize bytes, a multiple of 16 --
//       into a ring of shared-memory stages with one 1-D bulk copy
//       (cp.async.bulk ... mbarrier::complete_tx::bytes), each stage
//       guarded by a "full" and an "empty" mbarrier; no row load waits on
//       a tile id. The copies are marked evict-first in L2, and the
//       producer brings the queries of its next window into L2 with a
//       bulk prefetch, so the rows streaming past do not push the queries
//       out.
//     - Sixteen consumer warps: pair i of a window goes to warp i % 16, so
//       the warps stay balanced when segments hold fewer queries than
//       there are warps, and a warp with nothing in a segment runs ahead
//       to the next stage (every warp waits on each stage's "full" barrier
//       and arrives once on its "empty" one). Sixteen rather than eight:
//       the body is bound by latency more than by instruction rate, and the
//       second eight took about a fifth (bf16) and a quarter (int8) off the
//       kernel's time on an H100 (PERF.md).
//     - A warp computes one query's 16 dots: lane l holds the query
//       elements k = l*V + c*32*V of a 768-wide slice of k in registers (24
//       floats; V = 4 f32 or 8 bf16 / int8), read from global memory (the
//       queries stay in L2), and reads each row's matching chunks from the
//       stage: neighbouring lanes on neighbouring 16-byte (int8: 8-byte)
//       words, so every shared-memory read is free of bank conflicts. The
//       16 partial sums are reduced across the warp by a transposing
//       butterfly: 8 + 4 + 2 + 1 + 1 shuffles leave row r's dot in lanes
//       2r and 2r + 1, and lanes 0, 2, .., 30 write the pair's 16 floats
//       as one 64-byte run.
//     - Widening: a bf16 is the high half of an f32 (a shift or a mask);
//       an int8 code c becomes the f32 whose bits are 0x4B0000 | (c + 128)
//       (one byte permute after a sign flip of the word), which is 2^23 +
//       c + 128 exactly, minus 2^23 + 128 (an exact subtraction): no
//       conversion instruction.
//
// "query_major" (refine_rows_kernel), every other shape: each block takes
//   QPB queries and keeps their rows in shared memory; one warp per
//   candidate row reads the row with 16-byte loads where rows are 16-byte
//   aligned (scalar loads otherwise) and the query with 16-byte shared
//   reads, then a 5-step shuffle reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SRC_F32 = 0;
constexpr int SRC_BF16 = 1;
constexpr int SRC_INT8 = 2;

constexpr int SUB = 16;

// ---------------------------------------------------------------- tile-major

constexpr int CWARPS = 16;                      // consumer warps
constexpr int TTHREADS = (CWARPS + 1) * 32;     // + one producer warp
constexpr int WINDOW = 32;                      // sorted pairs a window
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 128;                  // 2 x MAX_STAGES mbarriers
constexpr int SMEM_LIMIT = 232448;              // Hopper, one block

// elements a lane reads per shared-memory load (16 bytes; int8: 8), and
// chunks per lane in one slice of k (a 768-wide slice, 24 query floats)
template <int SRC>
struct Tile {
  static constexpr int V = SRC == SRC_F32 ? 4 : 8;
  static constexpr int ITEM = SRC == SRC_F32 ? 4 : (SRC == SRC_BF16 ? 2 : 1);
  static constexpr int KS = SRC == SRC_F32 ? 6 : 3;
  static constexpr int SLICE = 32 * V * KS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// 1-D bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory, completion counted in
// bytes on bar, marked evict-first in L2
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  uint64_t policy;             // the tiles stream through L2: evict first
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar), "l"(policy)
      : "memory");
}

// bring ``bytes`` (a multiple of 16, 16-byte aligned) into L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes)
               : "memory");
}

// acc += (V elements of a row at ``x``) . (V query floats at ``q``)
template <int SRC>
__device__ __forceinline__ float fma_row(const uint8_t* x, const float* q,
                                         float acc) {
  if constexpr (SRC == SRC_F32) {
    const float4 u = *reinterpret_cast<const float4*>(x);
    acc = fmaf(u.x, q[0], acc);
    acc = fmaf(u.y, q[1], acc);
    acc = fmaf(u.z, q[2], acc);
    acc = fmaf(u.w, q[3], acc);
  } else if constexpr (SRC == SRC_BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(x);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(__uint_as_float(w[i] << 16), q[2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), q[2 * i + 1], acc);
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(x);
    // c + 128 in each byte, then 0x4B0000 | (c + 128) = 2^23 + c + 128
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v = __fsub_rn(
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440 | b)),
            8388736.0f);
        acc = fmaf(v, q[4 * i + b], acc);
      }
  }
  return acc;
}

// one step of the transposing butterfly at lane distance 2H: the lanes
// whose bit 2H is set keep rows H..2H-1 of the current 2H and send rows
// 0..H-1, the others the reverse; acc[0..H-1] then hold the sums of the
// kept rows over both lanes. H is a template argument so that every
// index of acc is a constant and acc stays in registers.
template <int H>
__device__ __forceinline__ void fold(float (&acc)[SUB], int lane) {
  const bool upper = (lane & (2 * H)) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? acc[i + H] : acc[i];
    const float send = upper ? acc[i] : acc[i + H];
    acc[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2 * H));
  }
}

// one 16-row tile's dots for one query: lane l, on return, holds the dot
// of row (l >> 1) in both lanes 2r and 2r + 1
template <int SRC>
__device__ __forceinline__ float tile_dots(const uint8_t* stage,
                                           const float* q, int d, int lane) {
  using T = Tile<SRC>;
  float acc[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += T::SLICE) {
    // lane l's query elements of this slice of k (zeros past d)
    float qv[T::KS][T::V];
#pragma unroll
    for (int c = 0; c < T::KS; ++c) {
      const int k = k0 + lane * T::V + c * 32 * T::V;
#pragma unroll
      for (int i = 0; i < T::V; i += 4) {
        const float4 f = k < d
                             ? *reinterpret_cast<const float4*>(q + k + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[c][i] = f.x;
        qv[c][i + 1] = f.y;
        qv[c][i + 2] = f.z;
        qv[c][i + 3] = f.w;
      }
    }
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      const uint8_t* row = stage + (size_t)r * d * T::ITEM;
#pragma unroll
      for (int c = 0; c < T::KS; ++c) {
        const int k = k0 + lane * T::V + c * 32 * T::V;
        if (k < d)
          acc[r] = fma_row<SRC>(row + (size_t)k * T::ITEM, qv[c], acc[r]);
      }
    }
  }
  // transposing butterfly: after the steps at lane distance 16, 8, 4 and
  // 2, acc[0] of lane l holds row (l >> 1)'s sum over its lane pair
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
  return __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], 1));
}

// the window's segment heads: a bit per lane that starts a run of equal
// tiles among the window's ``cnt`` sorted pairs (lane 0 always)
__device__ __forceinline__ uint32_t segment_heads(long tile, int lane,
                                                  int cnt) {
  const long prev = __shfl_up_sync(0xffffffffu, tile, 1);
  return __ballot_sync(0xffffffffu,
                       lane < cnt && (lane == 0 || tile != prev));
}

template <int SRC>
__global__ void __launch_bounds__(TTHREADS, 1)
refine_tiles_kernel(const int* __restrict__ tiles,
                    const int64_t* __restrict__ pairs, int n_pairs,
                    const float* __restrict__ queries,
                    const uint8_t* __restrict__ db,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int m, int d, int stages) {
  using T = Tile<SRC>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint8_t* ring = smem + BAR_BYTES;
  const uint32_t tile_bytes = static_cast<uint32_t>(SUB * d * T::ITEM);
  const int n_windows = (n_pairs + WINDOW - 1) / WINDOW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int local = 0;                      // this block's segments so far
  if (warp == CWARPS) {
    // ---- producer warp: lane 0 copies each segment's tile into the ring,
    // up to ``stages`` segments ahead of the consumers ----
    for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
      const int cnt = min(WINDOW, n_pairs - w * WINDOW);
      const long tile = lane < cnt ? tiles[(long)w * WINDOW + lane] : -1;
      {
        // the queries of this block's next window, into L2 ahead of the
        // consumers (the tiles pass through L2 marked evict-first)
        const long p = (long)(w + gridDim.x) * WINDOW + lane;
        if (p < n_pairs) prefetch_l2(queries + (pairs[p] / m) * d, d * 4);
      }
      uint32_t heads = segment_heads(tile, lane, cnt);
      while (heads) {
        const long t = __shfl_sync(0xffffffffu, tile, __ffs(heads) - 1);
        heads &= heads - 1;
        if (lane == 0) {
          const int s = local % stages, use = local / stages;
          if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
          mbar_expect_tx(smem_u32(&full[s]), tile_bytes);
          bulk_load(smem_u32(ring + (size_t)s * tile_bytes),
                    db + t * static_cast<long>(tile_bytes), tile_bytes,
                    smem_u32(&full[s]));
        }
        ++local;
      }
    }
    return;
  }

  // ---- consumer warps: pair i of a window goes to warp i % CWARPS ----
  const int rows_out = m * SUB;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    const long p = (long)w * WINDOW + lane;
    const int cnt = min(WINDOW, n_pairs - w * WINDOW);
    const long tile = lane < cnt ? tiles[p] : -1;
    const long pair = lane < cnt ? pairs[p] : 0;
    uint32_t heads = segment_heads(tile, lane, cnt);
    while (heads) {
      const int a = __ffs(heads) - 1;
      heads &= heads - 1;
      const int b = heads ? __ffs(heads) - 1 : cnt;
      const long t = __shfl_sync(0xffffffffu, tile, a);
      const int s = local % stages, use = local / stages;
      ++local;
      mbar_wait(smem_u32(&full[s]), use & 1);
      const uint8_t* stage = ring + (size_t)s * tile_bytes;
      for (int i = a + (warp - a % CWARPS + CWARPS) % CWARPS; i < b;
           i += CWARPS) {
        const long pr = __shfl_sync(0xffffffffu, pair, i);
        const long qi = pr / m;
        const int j = static_cast<int>(pr - qi * m);
        float dot = tile_dots<SRC>(stage, queries + qi * d, d, lane);
        const int r = lane >> 1;
        if (SRC == SRC_INT8) dot = __fmul_rn(dot, scales[t * SUB + r]);
        if ((lane & 1) == 0) out[qi * rows_out + j * SUB + r] = dot;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }
  }
}

// stages of the tile-major ring for rows of ``item`` bytes and width d:
// as many 16-row tiles as fit (at most MAX_STAGES), 0 if fewer than two
int tile_stages(int d, int item) {
  const long tile = static_cast<long>(SUB) * d * item;
  const long fit = (SMEM_LIMIT - BAR_BYTES) / tile;
  if (fit < 2) return 0;
  return static_cast<int>(fit < MAX_STAGES ? fit : MAX_STAGES);
}

template <int SRC>
int launch_tiles(const void* tiles, const void* pairs, int n_pairs,
                 const void* queries, const void* db, const void* scales,
                 void* out, int m, int d, cudaStream_t stream) {
  using T = Tile<SRC>;
  const int stages = tile_stages(d, T::ITEM);
  if (stages < 2 || d % T::V != 0 ||
      reinterpret_cast<uintptr_t>(db) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = BAR_BYTES + stages * SUB * d * T::ITEM;
  cudaError_t e = cudaFuncSetAttribute(
      refine_tiles_kernel<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_windows = (n_pairs + WINDOW - 1) / WINDOW;
  const int grid = n_windows < sms ? n_windows : sms;
  refine_tiles_kernel<SRC><<<grid, TTHREADS, smem, stream>>>(
      static_cast<const int*>(tiles), static_cast<const int64_t*>(pairs),
      n_pairs, static_cast<const float*>(queries),
      static_cast<const uint8_t*>(db), static_cast<const float*>(scales),
      static_cast<float*>(out), m, d, stages);
  return static_cast<int>(cudaGetLastError());
}
// --------------------------------------------------------------- query-major

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

// fmaf of one 16-byte chunk of the row (N elements from k) with q[k..],
// the query read from shared memory 16 bytes at a time
template <int SRC>
__device__ __forceinline__ float fma_chunk(const void* row, const float* q,
                                           int k, float acc) {
  const uint4 u = *reinterpret_cast<const uint4*>(
      static_cast<const char*>(row) + (long)k * (16 / Vec<SRC>::N));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float qv[Vec<SRC>::N];
#pragma unroll
  for (int i = 0; i < Vec<SRC>::N; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(q + k + i);
    qv[i] = f.x;
    qv[i + 1] = f.y;
    qv[i + 2] = f.z;
    qv[i + 3] = f.w;
  }
  if constexpr (SRC == SRC_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(__uint_as_float(w[i]), qv[i],
                                           acc);
  } else if constexpr (SRC == SRC_BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32: widening is a shift
      acc = fmaf(__uint_as_float(w[i] << 16), qv[2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), qv[2 * i + 1], acc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc = fmaf(static_cast<float>(static_cast<signed char>(
                       (w[i] >> (8 * b)) & 0xffu)),
                   qv[4 * i + b], acc);
  }
  return acc;
}

template <int SRC>
__global__ void __launch_bounds__(THREADS)
refine_rows_kernel(const int64_t* __restrict__ tile_idx,
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
int launch_rows(const void* tile_idx, const void* queries, const void* db,
                const void* scales, void* out, int qp, int m, int d,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * QPB * (size_t)d;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_rows_kernel<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte loads need every row (and its chunks) 16-byte aligned, and
  // the 16-byte query reads a d that keeps each query row 16-byte aligned
  const bool vec = (d % Vec<SRC>::N) == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0;
  const int blocks = (qp + QPB - 1) / QPB;
  refine_rows_kernel<SRC><<<blocks, THREADS, smem, stream>>>(
      static_cast<const int64_t*>(tile_idx),
      static_cast<const float*>(queries), db,
      static_cast<const float*>(scales), static_cast<float*>(out), qp, m, d,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). src: 0 f32 rows, 1 bf16 rows, 2 int8
// codes with pow2 row scales. db (n, d) of the source's type, scales (n,)
// f32 for src 2 (else unused), queries (qp, d) f32, out (qp, m*16) f32,
// all contiguous. Each launches on ``stream``, allocates nothing and
// returns cudaGetLastError().

// The query-major body: tile_idx (qp, m) int64.
extern "C" int vdb_refine_dots(const void* tile_idx, const void* queries,
                               const void* db, const void* scales, void* out,
                               int qp, int m, int d, int src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src == SRC_F32)
    return launch_rows<SRC_F32>(tile_idx, queries, db, scales, out, qp, m, d,
                                s);
  if (src == SRC_BF16)
    return launch_rows<SRC_BF16>(tile_idx, queries, db, scales, out, qp, m,
                                 d, s);
  if (src == SRC_INT8)
    return launch_rows<SRC_INT8>(tile_idx, queries, db, scales, out, qp, m,
                                 d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile-major body over the work list of cuda_kernels._refine_work:
// ``pairs`` (int64), the n_pairs = qp*m pair ids q*m + j in the stable
// order of their tile ids, and ``tiles`` (int32), those tile ids in that
// order. db 16-byte aligned, d % 4 == 0 (f32) or d % 8 == 0 (bf16, int8),
// two 16-row tiles within shared memory.
extern "C" int vdb_refine_tiles(const void* tiles, const void* pairs,
                                int n_pairs, const void* queries,
                                const void* db, const void* scales,
                                void* out, int m, int d, int src,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pairs < 1 || m < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define VDB_TILES(SRC)                                                     \
  launch_tiles<SRC>(tiles, pairs, n_pairs, queries, db, scales, out, m, d, \
                    s)
  if (src == SRC_F32) return VDB_TILES(SRC_F32);
  if (src == SRC_BF16) return VDB_TILES(SRC_BF16);
  if (src == SRC_INT8) return VDB_TILES(SRC_INT8);
#undef VDB_TILES
  return static_cast<int>(cudaErrorInvalidValue);
}
