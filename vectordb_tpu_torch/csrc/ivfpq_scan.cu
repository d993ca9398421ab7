// IVF-PQ residual scan, every slot in one launch (kernel K8s).
//
// Replaces no Pallas kernel of its own: it fuses K8 (pq_decode.cu, the port
// of vectordb_tpu/ops/pq.py _pq_decode_pallas_kernel) with the scoring that
// vectordb_tpu/ops/pq.py ivfpq_scan_topr does per chunk in XLA (the two
// bf16 products of the decoded rows against the hi/lo query split, the
// residual's centroid terms, the metric), so that the decoded rows never
// reach device memory. For each slot i (row of ``codes``) and query q:
//
//   dot  = q_hi . r_hat + q_lo . r_hat  (bf16 x bf16 products, f32 sums)
//          + qc[q, cid(i)]              (q . c, the caller's (Q, nlist) table)
//   xsq  = |c|^2 + 2 c . r_hat + |r_hat|^2      (f32, from the decoded values)
//   out[q, i] = -dot | xsq - 2 dot | -dot / sqrt(max(xsq, 1e-30))
//               (dot / euclidean / cosine), +inf where valid[i] is 0,
//
// with r_hat[c*dsub + e] = cb[c, codes[i, c], e] and cid(i) = i / span below
// big_m = nlist * span, else clamp(cid_sp[i - big_m], 0, nlist - 1). These
// are the chunk loop's terms (ops/pq.py ivfpq_scan_topr's plain version);
// only the order of the f32 sums differs. |r_hat|^2 is summed from the
// squares of the decoded bf16 values (each square exact in f32), which is
// what the codeword-norm table holds, without a table read per subspace.
//
// What bounds it on an H100: at the benchmark's shape (Q = 64, ~1.66M slots,
// d = 768, m = 96) the products are 2 * 2 * Q * N * d = 327 GFLOP of bf16
// (0.33 ms at 989 TFLOP/s); the bytes it must move are the codes (N * m,
// 160 MB) and the scores (4 * Q * N, 425 MB): 0.17 ms at 3.35 TB/s. The
// decode's random codeword reads (16 bytes of a 393 KB codebook per row and
// subspace) come mostly from L2: the query tile fills the shared memory and
// leaves ~28 KB of L1. Read on an H100: 2.47-2.50 ms (cosine), 7.5x the
// bound; taking out the codeword loads, the products, the query loads or
// the score stores alone saves 0.3-0.6 ms each, so no one of them is the
// limit: at one block of 8 warps an SM the warps wait on latency.
//
// What the design does about it:
//   - One persistent block an SM (8 warps) holds its tile of NT * 8 queries,
//     hi and lo, in shared memory, laid out so that a warp's B-fragment loads
//     are 256 contiguous bytes (no bank conflict). Warps walk 32-row tiles
//     of slots round-robin; each stages its tile's codes in its own slice of
//     shared memory.
//   - The decode goes straight into the mma.sync A fragments: in k-step s a
//     lane (g = lane / 4, t = lane % 4) loads the 8 bytes of dims 16 s + 4 t
//     .. + 3 of its rows' codewords. The fragment's columns (2t, 2t+1, 2t+8,
//     2t+9) are taken as those four dims, and the B fragments of the queries
//     are read with the same map, so every product pairs the same dim.
//   - Codeword loads run three k-steps ahead of the products (four register
//     stages) through the read-only path; the L1 left beside the shared
//     memory also holds the centroid rows (shared by a cluster's 208
//     slots) and the q.c table.
//   - The centroid terms use the same decoded registers (f32 FMA), reduced
//     over the four lanes of a row at the tile's end; the epilogue adds q.c,
//     applies the metric and writes one f32 score a (query, slot).
//   Not done: wgmma (the query tile read by the tensor cores from shared
//   memory, no B loads, asynchronous products), more warps an SM (the
//   query tile's 192 KB allows one block), selection inside this kernel
//   (select_kernel below reads the scores once).
//
// Numerics: the score arithmetic uses __fadd_rn / __fmul_rn / __fdiv_rn /
// __fsqrt_rn in the plain version's order, so no FMA contraction moves a
// score beyond the f32 summation order of its dots and norms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = 32;              // rows per warp tile: two m16 fragments
constexpr int SMEM_LIMIT = 232448;     // Hopper, one block
constexpr int MODE_EUCLIDEAN = 0;
constexpr int MODE_DOT = 1;

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 bytes of a codeword through the read-only path
__device__ __forceinline__ uint2 ld_codeword(const void* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// one k-step's loads for a lane's four rows: the codeword words (A) and,
// for the norm terms, the centroid words of the same dims
template <int MODE>
__device__ __forceinline__ void issue(uint2 (&a)[4], uint2 (&cen)[4], int s,
                                      int steps, const uint8_t* wcodes,
                                      const int (&lrow)[4],
                                      const uint8_t* __restrict__ cb,
                                      const uint8_t* const (&crow)[4], int m,
                                      int ksub, int dsub, int t) {
  if (s >= steps) return;
  const int pos = 16 * s + 4 * t;           // the lane's first dim
  const int c = pos / dsub;                 // its subspace
  const int off = pos - c * dsub;           // its offset in the codeword
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int code = wcodes[lrow[i] * m + c];
    a[i] = ld_codeword(cb + ((static_cast<long>(c) * ksub + code) * dsub +
                             off) * 2);
    if (MODE != MODE_DOT)
      cen[i] = __ldg(reinterpret_cast<const uint2*>(crow[i] + pos * 2));
  }
}

template <int MODE, int NT>
__device__ __forceinline__ void step(float (&acc)[2][NT][4],
                                     float (&cr)[4], float (&rr)[4],
                                     const uint2 (&a)[4], const uint2 (&cen)[4],
                                     int s, int steps, const uint8_t* qs_hi,
                                     const uint8_t* qs_lo, int g, int t) {
  if (s >= steps) return;
  constexpr int NQ = NT * 8;
  uint2 b[2][NT];                 // the hi and lo B fragments of the step
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    // query 8j + g, dims 16 s + 4 t .. + 3: 16 s * NQ * 2 bytes a k-step
    const int o = ((s * NQ + 8 * j + g) * 16 + 4 * t) * 2;
    b[0][j] = *reinterpret_cast<const uint2*>(qs_hi + o);
    b[1][j] = *reinterpret_cast<const uint2*>(qs_lo + o);
  }
  // all hi products, then all lo ones: 2 NT independent accumulators
  // between two products into one
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint2 r0 = a[2 * mt], r8 = a[2 * mt + 1];
        mma_bf16(acc[mt][j], r0.x, r8.x, r0.y, r8.y, b[p][j].x, b[p][j].y);
      }
  if (MODE != MODE_DOT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = lo_f(a[i].x), x1 = hi_f(a[i].x);
      const float x2 = lo_f(a[i].y), x3 = hi_f(a[i].y);
      cr[i] = fmaf(lo_f(cen[i].x), x0, cr[i]);
      cr[i] = fmaf(hi_f(cen[i].x), x1, cr[i]);
      cr[i] = fmaf(lo_f(cen[i].y), x2, cr[i]);
      cr[i] = fmaf(hi_f(cen[i].y), x3, cr[i]);
      rr[i] = fmaf(x0, x0, rr[i]);
      rr[i] = fmaf(x1, x1, rr[i]);
      rr[i] = fmaf(x2, x2, rr[i]);
      rr[i] = fmaf(x3, x3, rr[i]);
    }
  }
}

template <int MODE, int NT>
__global__ void __launch_bounds__(THREADS, 1)
ivfpq_scan_kernel(const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ cb,
                  const uint4* __restrict__ qhi, const uint4* __restrict__ qlo,
                  const float* __restrict__ qc,
                  const uint8_t* __restrict__ cents,
                  const float* __restrict__ csq,
                  const int* __restrict__ cid_sp,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  long n, long big_m, int q, int d, int m, int ksub, int dsub,
                  int span, int nlist) {
  constexpr int NQ = NT * 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs_hi = smem;                             // NQ * d bf16
  uint8_t* qs_lo = smem + NQ * d * 2;
  uint8_t* codes_s = smem + NQ * d * 4;              // WARPS * 32 * m bytes
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * NQ;
  const int steps = d / 16;

  // the query tile, 16 dims of NQ queries a k-step; zero past q
  const int words = d / 8;                           // 16-byte words a row
  for (int w = tid; w < NQ * words; w += THREADS) {
    const int nq = w / words, k8 = w - nq * words;
    const int o = ((k8 >> 1) * NQ + nq) * 32 + (k8 & 1) * 16;
    uint4 h = make_uint4(0, 0, 0, 0), l = h;
    if (q0 + nq < q) {
      h = qhi[static_cast<long>(q0 + nq) * words + k8];
      l = qlo[static_cast<long>(q0 + nq) * words + k8];
    }
    *reinterpret_cast<uint4*>(qs_hi + o) = h;
    *reinterpret_cast<uint4*>(qs_lo + o) = l;
  }
  __syncthreads();

  uint8_t* wcodes = codes_s + warp * WROWS * m;
  const long ntiles = (n + WROWS - 1) / WROWS;
  const float inf = __int_as_float(0x7f800000);
  // the lane's rows in the tile: fragment mt, row g or g + 8
  int lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lrow[i] = (i >> 1) * 16 + (i & 1) * 8 + g;

  for (long tile = static_cast<long>(blockIdx.x) * WARPS + warp;
       tile < ntiles; tile += static_cast<long>(gridDim.x) * WARPS) {
    const long r0 = tile * WROWS;
    const int nrows = static_cast<int>(n - r0 < WROWS ? n - r0 : WROWS);
    // stage the tile's codes (r0 * m is a multiple of 32: 16-byte aligned)
    __syncwarp();
    {
      const uint8_t* src = codes + r0 * m;
      const int bytes = nrows * m, vec = bytes & ~15;
      for (int o = lane * 16; o < vec; o += 32 * 16)
        *reinterpret_cast<uint4*>(wcodes + o) =
            __ldg(reinterpret_cast<const uint4*>(src + o));
      for (int o = vec + lane; o < WROWS * m; o += 32)
        wcodes[o] = o < bytes ? src[o] : 0;
    }
    __syncwarp();

    int cid[4];
    const uint8_t* crow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + lrow[i];
      int c = 0;
      if (row < big_m) {
        c = static_cast<int>(row / span);
      } else if (row < n) {
        c = cid_sp[row - big_m];
        c = c < 0 ? 0 : (c >= nlist ? nlist - 1 : c);
      }
      cid[i] = c;
      crow[i] = cents + static_cast<long>(c) * d * 2;
    }

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint2 a0[4], a1[4], a2[4], a3[4], c0[4], c1[4], c2[4], c3[4];
#define VDB_ISSUE(A, C, S)                                                   \
  issue<MODE>(A, C, S, steps, wcodes, lrow, cb, crow, m, ksub, dsub, t)
#define VDB_STEP(A, C, S)                                                    \
  step<MODE, NT>(acc, cr, rr, A, C, S, steps, qs_hi, qs_lo, g, t)
    VDB_ISSUE(a0, c0, 0);
    VDB_ISSUE(a1, c1, 1);
    VDB_ISSUE(a2, c2, 2);
    for (int s = 0; s < steps; s += 4) {
      VDB_ISSUE(a3, c3, s + 3);
      VDB_STEP(a0, c0, s);
      VDB_ISSUE(a0, c0, s + 4);
      VDB_STEP(a1, c1, s + 1);
      VDB_ISSUE(a1, c1, s + 5);
      VDB_STEP(a2, c2, s + 2);
      VDB_ISSUE(a2, c2, s + 6);
      VDB_STEP(a3, c3, s + 3);
    }
#undef VDB_ISSUE
#undef VDB_STEP

    // epilogue: a row's norm terms summed over its four lanes, then the
    // scores of the lane's (row, query) pairs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cr[i] += __shfl_xor_sync(0xffffffffu, cr[i], 1);
      cr[i] += __shfl_xor_sync(0xffffffffu, cr[i], 2);
      rr[i] += __shfl_xor_sync(0xffffffffu, rr[i], 1);
      rr[i] += __shfl_xor_sync(0xffffffffu, rr[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + lrow[i];
      if (row >= n) continue;
      const bool ok = valid[row] != 0;
      float xsq = 0.0f, xnorm = 1.0f;
      if (MODE != MODE_DOT) {
        xsq = __fadd_rn(__fadd_rn(csq[cid[i]], __fmul_rn(2.0f, cr[i])),
                        rr[i]);
        xnorm = __fsqrt_rn(fmaxf(xsq, 1e-30f));
      }
      const float* qcr = qc + cid[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gq = q0 + 8 * j + 2 * t + e;
          if (gq >= q) continue;
          const float dot =
              __fadd_rn(acc[i >> 1][j][(i & 1) * 2 + e],
                        qcr[static_cast<long>(gq) * nlist]);
          float sc;
          if (MODE == MODE_DOT)
            sc = -dot;
          else if (MODE == MODE_EUCLIDEAN)
            sc = __fsub_rn(xsq, __fmul_rn(2.0f, dot));
          else
            sc = __fdiv_rn(-dot, xnorm);
          out[static_cast<long>(gq) * n + row] = ok ? sc : inf;
        }
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

template <int MODE, int NT>
int launch(const void* codes, const void* cb, const void* qhi,
           const void* qlo, const void* qc, const void* cents,
           const void* csq, const void* cid_sp, const void* valid, void* out,
           long n, long big_m, int q, int d, int m, int ksub, int dsub,
           int span, int nlist, long smem, cudaStream_t stream) {
  auto kernel = ivfpq_scan_kernel<MODE, NT>;
  // per device and instantiation: the dynamic shared memory allowed so far
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = static_cast<int>(smem);
  }
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long tiles = (n + WROWS - 1) / WROWS;
  const long want = (tiles + WARPS - 1) / WARPS;
  const dim3 grid(static_cast<unsigned>(want < sms ? want : sms),
                  static_cast<unsigned>((q + NT * 8 - 1) / (NT * 8)));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(cb),
      static_cast<const uint4*>(qhi), static_cast<const uint4*>(qlo),
      static_cast<const float*>(qc), static_cast<const uint8_t*>(cents),
      static_cast<const float*>(csq), static_cast<const int*>(cid_sp),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), n, big_m,
      q, d, m, ksub, dsub, span, nlist);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_nt(int nt, const void* codes, const void* cb, const void* qhi,
              const void* qlo, const void* qc, const void* cents,
              const void* csq, const void* cid_sp, const void* valid,
              void* out, long n, long big_m, int q, int d, int m, int ksub,
              int dsub, int span, int nlist, long smem, cudaStream_t s) {
  switch (nt) {
    case 8:
      return launch<MODE, 8>(codes, cb, qhi, qlo, qc, cents, csq, cid_sp,
                             valid, out, n, big_m, q, d, m, ksub, dsub, span,
                             nlist, smem, s);
    case 2:
      return launch<MODE, 2>(codes, cb, qhi, qlo, qc, cents, csq, cid_sp,
                             valid, out, n, big_m, q, d, m, ksub, dsub, span,
                             nlist, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- selection
//
// The exact top k of each row of K8s's scores, in two launches of one
// kernel (ops/pq.py _select_topr): each block takes SEL_SEG keys of one row
// and writes their k smallest, sorted, with their slots; a second launch
// over the (rows, segments * k) candidates leaves k a row. The k smallest
// of a row are the k smallest of its segments' k smallest, so the
// selection is exact for any segment length; only the order of equal
// scores may differ from torch.topk's.
//
// What bounds it: the scores' bytes, read once from device memory into
// shared memory (425 MB at the benchmark's Q = 64: 0.13 ms). The design:
// keys become order-preserving uint32 in shared memory. A threshold t with
// k <= #(keys < t) <= SEL_CAP comes from a sorted sample of 256 keys (a
// count pass each try, no atomics); the keys below it are gathered with
// one shared atomic a warp (ballot) and sorted (bitonic). A segment of at
// most k finite keys keeps them and fills with +inf ones. Where no sample
// threshold fits (scores tied in bulk) four 8-bit radix passes find the
// k-th key exactly instead. torch.topk over the same (64, 1.66M) scores
// is about twenty launches (its multi-block radix select); this is two.

constexpr int SEL_THREADS = 256;
constexpr int SEL_SEG = 16384;         // keys a block selects from
constexpr int SEL_CAP = 2048;          // candidates a threshold may keep
constexpr int SEL_TRIES = 8;           // sample thresholds tried
constexpr uint32_t SEL_PAD = 0xffffffffu;  // after every key, +inf too
constexpr uint32_t SEL_INF = 0xff800000u;  // order_key(+inf)

// f32 -> uint32 in the same order (-0 before +0, NaN after +inf)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// inclusive sum of v over the block's SEL_THREADS threads
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += x;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return v + before;
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warp_sums) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < SEL_THREADS / 32; ++w) s += warp_sums[w];
  __syncthreads();
  return s;
}

// ascending bitonic sort of n2 (a power of two) (key, position) pairs
__device__ __forceinline__ void bitonic(uint32_t* key, int* pos, int n2) {
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2; i += SEL_THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const uint32_t a = key[i], b = key[j];
          if ((a > b) == up) {
            key[i] = b;
            key[j] = a;
            const int t = pos[i];
            pos[i] = pos[j];
            pos[j] = t;
          }
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ keys,
              const long long* __restrict__ pay, float* __restrict__ out_v,
              long long* __restrict__ out_i, long len, int k) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem);     // SEL_SEG
  uint32_t* ckey = skey + SEL_SEG;                         // SEL_CAP
  int* cpos = reinterpret_cast<int*>(ckey + SEL_CAP);      // SEL_CAP
  __shared__ uint32_t hist[256];
  __shared__ uint32_t warp_sums[SEL_THREADS / 32];
  __shared__ uint32_t sh_prefix, sh_kk, cnt_less, cnt_eq;
  const int tid = threadIdx.x, lane = tid & 31;
  const int seg = blockIdx.x, segs = gridDim.x;
  const long row = blockIdx.y;
  const long s0 = static_cast<long>(seg) * SEL_SEG;
  const int n = static_cast<int>(len - s0 < SEL_SEG ? len - s0 : SEL_SEG);
  const int nr = (n + 31) & ~31;         // whole warps in every trip
  const float* src = keys + row * len + s0;
  uint32_t fin = 0;
#pragma unroll 8
  for (int i = tid; i < n; i += SEL_THREADS) {
    const uint32_t key = order_key(src[i]);
    skey[i] = key;
    fin += key < SEL_INF;
  }
  const uint32_t nf = block_sum(fin, warp_sums);

  // keep the keys below t and ``need`` keys equal to it: n_less of them
  // are below t, so the kept keys fill positions 0 .. n_less + need - 1
  uint32_t t, need, n_less;
  if (nf <= static_cast<uint32_t>(k)) {  // every finite key, then +inf ones
    t = SEL_INF;
    n_less = nf;
    need = k - nf;
  } else {
    // a threshold from the sorted sample: the j-th of 256 samples leaves
    // about j n / 256 keys below it; aim at twice k
    ckey[tid] = skey[static_cast<long>(tid) * n / SEL_THREADS];
    cpos[tid] = tid;
    __syncthreads();
    bitonic(ckey, cpos, SEL_THREADS);
    int j = static_cast<int>(2L * k * SEL_THREADS / n) + 1;
    bool found = false;
    t = 0;
    uint32_t c = 0;
    for (int tries = 0; tries < SEL_TRIES && !found; ++tries) {
      j = j < SEL_THREADS - 1 ? j : SEL_THREADS - 1;
      t = ckey[j];
      uint32_t mine = 0;
      for (int i = tid; i < n; i += SEL_THREADS) mine += skey[i] < t;
      c = block_sum(mine, warp_sums);
      if (c < static_cast<uint32_t>(k)) {
        if (j == SEL_THREADS - 1) break;
        j = 2 * j + 1;
      } else if (c > static_cast<uint32_t>(SEL_CAP)) {
        if (j == 0) break;
        j /= 2;
      } else {
        found = true;
      }
    }
    __syncthreads();                     // the sample's last reads
    if (found) {
      n_less = c;
      need = 0;
    } else {
      // the k-th smallest key exactly: four 8-bit radix passes, lanes that
      // share a digit adding once
      uint32_t prefix = 0, mask = 0, kk = k;
      for (int shift = 24; shift >= 0; shift -= 8) {
        hist[tid] = 0;
        __syncthreads();
        for (int i = tid; i < nr; i += SEL_THREADS) {
          const bool act = i < n && (skey[i] & mask) == prefix;
          const uint32_t dig = act ? (skey[i] >> shift) & 255u : 256u + lane;
          const uint32_t peers = __match_any_sync(0xffffffffu, dig);
          if (act && lane == __ffs(peers) - 1)
            atomicAdd(&hist[dig], __popc(peers));
        }
        __syncthreads();
        const uint32_t h = hist[tid];
        const uint32_t incl = block_scan(h, warp_sums);
        if (incl - h < kk && kk <= incl) {   // the k-th key's digit
          sh_prefix = prefix | (static_cast<uint32_t>(tid) << shift);
          sh_kk = kk - (incl - h);
        }
        __syncthreads();
        prefix = sh_prefix;
        kk = sh_kk;
        mask |= 255u << shift;
      }
      t = prefix;
      n_less = k - kk;
      need = kk;
    }
  }

  // gather: one shared atomic a warp for each kind
  if (tid == 0) cnt_less = cnt_eq = 0;
  __syncthreads();
  const uint32_t below = (1u << lane) - 1;
  for (int i = tid; i < nr; i += SEL_THREADS) {
    const uint32_t key = i < n ? skey[i] : SEL_PAD;
    const bool lt = key < t, eq = i < n && key == t;
    const uint32_t m_lt = __ballot_sync(0xffffffffu, lt);
    const uint32_t m_eq = __ballot_sync(0xffffffffu, eq);
    uint32_t b_lt = 0, b_eq = 0;
    if (lane == 0) {
      if (m_lt) b_lt = atomicAdd(&cnt_less, __popc(m_lt));
      if (m_eq && need) b_eq = atomicAdd(&cnt_eq, __popc(m_eq));
    }
    b_lt = __shfl_sync(0xffffffffu, b_lt, 0);
    b_eq = __shfl_sync(0xffffffffu, b_eq, 0);
    if (lt) {
      const uint32_t p = b_lt + __popc(m_lt & below);
      ckey[p] = key;
      cpos[p] = i;
    } else if (eq && need) {
      const uint32_t p = b_eq + __popc(m_eq & below);
      if (p < need) {
        ckey[n_less + p] = key;
        cpos[n_less + p] = i;
      }
    }
  }
  __syncthreads();
  const uint32_t kept = n_less + (cnt_eq < need ? cnt_eq : need);
  int n2 = 1;
  while (n2 < static_cast<int>(kept > static_cast<uint32_t>(k) ? kept : k))
    n2 <<= 1;
  for (int i = static_cast<int>(kept) + tid; i < n2; i += SEL_THREADS) {
    ckey[i] = SEL_PAD;
    cpos[i] = -1;
  }
  __syncthreads();
  bitonic(ckey, cpos, n2);

  const long o = (row * segs + seg) * k;
  for (int i = tid; i < k; i += SEL_THREADS) {
    const int p = cpos[i];
    out_v[o + i] = key_float(ckey[i]);
    out_i[o + i] = p < 0 ? -1 : (pay ? pay[row * len + s0 + p] : s0 + p);
  }
}

}  // namespace

// C interface (loaded with ctypes). codes (n, m) uint8, each < ksub; cb
// (m, ksub, dsub) bf16; qhi, qlo (q, d) bf16; qc (q, nlist) f32; cents
// (nlist, d) bf16; csq (nlist,) f32; cid_sp (n - big_m,) int32; valid (n,)
// bool; out (q, n) f32; all contiguous, codes, cb, cents, qhi and qlo
// 16-byte aligned. d % 16 == 0, dsub % 8 == 0, nt 8 or 2 (queries a block:
// 8 nt), mode 0 euclidean, 1 dot, 2 cosine. Launches on
// ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" long vdb_ivfpq_scan_smem(int d, int m, int nt) {
  return 4L * nt * 8 * d + static_cast<long>(WARPS) * WROWS * m;
}

// the k smallest of each SEL_SEG keys of each row of ``keys`` (rows, len)
// f32, sorted: out_v, out_i (rows, segments, k) f32 and int64, out_i the
// key's column or, with ``pay`` (rows, len) int64, its payload; -1 and NaN
// past a segment's last key. 1 <= k <= 1024.
extern "C" int vdb_select(const void* keys, const void* pay, void* out_v,
                          void* out_i, long rows, long len, int k,
                          void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (k < 1 || k > 1024 || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long segs = (len + SEL_SEG - 1) / SEL_SEG;
  const int smem = SEL_SEG * 4 + SEL_CAP * 8;
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  select_kernel<<<dim3(static_cast<unsigned>(segs),
                       static_cast<unsigned>(rows)),
                  SEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const long long*>(pay),
      static_cast<float*>(out_v), static_cast<long long*>(out_i), len, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vdb_ivfpq_scan(const void* codes, const void* cb,
                              const void* qhi, const void* qlo,
                              const void* qc, const void* cents,
                              const void* csq, const void* cid_sp,
                              const void* valid, void* out, long n,
                              long big_m, int q, int d, int m, int ksub,
                              int dsub, int span, int nlist, int nt, int mode,
                              void* stream) {
  if (n <= 0 || q <= 0) return 0;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(cb) |
      reinterpret_cast<uintptr_t>(cents) | reinterpret_cast<uintptr_t>(qhi) |
      reinterpret_cast<uintptr_t>(qlo);
  const long smem = vdb_ivfpq_scan_smem(d, m, nt);
  if (d % 16 != 0 || dsub % 8 != 0 || m * dsub != d || align % 16 != 0 ||
      span < 1 || nlist < 1 || big_m > n || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_nt<0>(nt, codes, cb, qhi, qlo, qc, cents, csq, cid_sp,
                          valid, out, n, big_m, q, d, m, ksub, dsub, span,
                          nlist, smem, s);
    case 1:
      return launch_nt<1>(nt, codes, cb, qhi, qlo, qc, cents, csq, cid_sp,
                          valid, out, n, big_m, q, d, m, ksub, dsub, span,
                          nlist, smem, s);
    case 2:
      return launch_nt<2>(nt, codes, cb, qhi, qlo, qc, cents, csq, cid_sp,
                          valid, out, n, big_m, q, d, m, ksub, dsub, span,
                          nlist, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
