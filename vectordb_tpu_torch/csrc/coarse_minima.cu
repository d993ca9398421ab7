// Coarse bf16 scan with fused tile / super-tile minima, the mma.sync body
// (kernel K6, K3 at one pass, and the K1 / K3 / K4 / K5 / K7 shapes TMA
// cannot take).
//
// One template, coarse_minima_kernel<SRC, PASSES, EMIT_SUPER>, serves six
// Pallas kernels of vectordb_tpu/ops/coarse_kernel.py:
//   K6  _coarse_kernel_1p (launchers _coarse_minima_1p(_tq)): SRC=MIRRORS,
//       PASSES=1, tile minima only; the same instantiation serves K3 at one
//       pass, which only chip_smoke.py's control calls;
// and, only for the shapes TMA cannot take (d not a multiple of 8 -- of 16
// for int8 codes -- or rows not 16-byte aligned, for K3 either mirror):
//   K3  _coarse_kernel (launcher _coarse_minima): SRC=MIRRORS, PASSES=3
//       (bf16x3: hi.qhi + lo.qhi + hi.qlo), tile minima only;
//   K5  _coarse_kernel_f32 (launcher _coarse_minima_f32): SRC=F32,
//       PASSES=3 or 1 -- K3 over the f32 rows, hi/lo split on chip;
//   K7  _coarse_kernel_int8_1p_sup (src "int8"): SRC=INT8, PASSES=1,
//       EMIT_SUPER -- K1 over int8 codes, the dot times a pow2 row scale;
//   K1  _coarse_kernel_1p_sup (src "mirrors" or "bf16"): SRC=MIRRORS,
//       PASSES=1, EMIT_SUPER, and
//   K4  _coarse_kernel_f32_1p_sup (src "f32"): SRC=F32, PASSES=1,
//       EMIT_SUPER. Every other K1, K3 (3 passes), K4, K5 and K7 launch
//       runs coarse_wgmma.cu (TMA ring + wgmma, persistent blocks);
//       ops/cuda_kernels.py's _coarse_route picks the body by shape.
//
// What it computes: for every 16-row database tile t and query q,
//   min over the tile's rows r of score(r, q) + inv[r] * 1e30, with
//   score = col[r] + qrow[q] - 2 dot   (euclidean: col=|x|^2, qrow=|q|^2)
//         = -dot                        (dot product)
//         = -(dot * col[r] * qrow[q])   (cosine: col=1/|x|, qrow=1/|q|)
// where dot is the bf16 x bf16 -> f32 product (SRC=INT8: that product
// times the row's pow2 scale, before the score, as the JAX kernel orders
// it). The (N, Q) score matrix never reaches device memory: each block
// reduces its scores in registers and writes (N/16, Q) tile minima
// (+ (N/256, Q) super minima).
//
// What each source must get right:
//   F32: hi = __float2bfloat16_rn(x), lo = __float2bfloat16_rn(x - hi):
//     round to nearest even, as torch's cast that computes the residual
//     bound elo_max the 1-pass certificate trusts. Truncation would leave
//     residuals past that bound.
//   INT8: |code| <= 127, so code -> bf16 is exact; the pow2 scale multiply
//     is exact too, so the database side adds no error (elo_max = 0).
//
// What bounds it on an H100: it is a bf16 GEMM (2*N*Q*d flops per pass;
// 6.6 TFLOP per pass at N=2^20, Q=4096, d=768). The source rows (1.6 GB
// of bf16, 3.2 GB of f32 or 0.8 GB of int8 at that shape) are far larger
// than the 50 MB L2, and the tile minima write is 1.07 GB. At the tensor
// cores' bf16 rate the GEMM is compute-bound; this body is limited by its
// instruction throughput (single-stage shared-memory tiles, no cp.async /
// TMA / wgmma: ~8-10% of the bf16 rate), and K5 adds the on-chip split per
// element. coarse_wgmma.cu is the redesign for Hopper (K3 at 3 passes is
// its MIRRORS/3 form); K6 is to move onto its mirrors form at one pass
// without super minima in a later change (ROADMAP queue 2); this body
// keeps K6 and the ragged shapes.
//
// What the design does about it: one block owns one 256-row super-tile x
// 64 queries, so the super minimum is a block-local reduction (no second
// pass over the tile minima, the reason K1 exists). Blocks are ordered
// query-block-fastest, so the 64 blocks that share a database tile run
// together and read it from L2 rather than from HBM. The source switch
// lives only in the shared-memory fill (16-byte loads of bf16, two of f32,
// one 8-byte load of int8 codes per 8 elements; scalar loads for ragged
// d), so every variant feeds the same mma loop. The score epilogue and
// both minima are fused into the accumulator registers.
//
// Numerics: tensor-core f32 accumulation does not round to nearest
// (Fasi, Higham, Mikaitis & Pranesh, "Numerical behavior of NVIDIA tensor
// cores", PeerJ CS 2021), so the certificates in ops/coarse_kernel.py
// double their coarse accumulation term for results of this body
// (_accum_coeff("mma_sync")).
// Score arithmetic uses __fadd_rn/__fmul_rn so it is not contracted into
// FMAs and matches the plain version's operation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SRC_MIRRORS = 0;     // bf16 hi (and lo) mirrors
constexpr int SRC_F32 = 1;         // f32 rows, split on chip
constexpr int SRC_INT8 = 2;        // int8 codes + per-row pow2 scales

constexpr int SUB = 16;            // rows per tile
constexpr int SUPER = 16;          // tiles per super-tile
constexpr int BM = SUB * SUPER;    // database rows per block: one super-tile
constexpr int BN = 64;             // queries per block
constexpr int BK = 16;             // depth per stage: one mma k-step
constexpr int LDS = BK + 8;        // padded shared-memory row (bank spread)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WM = BM / WARPS;     // 32 rows per warp
constexpr int MT = WM / 16;        // 2 m16 fragments per warp
constexpr int NT = BN / 8;         // 8 n8 fragments per warp
constexpr float PENALTY = 1e30f;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 consecutive bf16 of one database row into shared memory; zero past d.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, int kvalid,
                                      bool vec) {
  if (vec && kvalid >= 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = i < kvalid ? src[i] : __float2bfloat16(0.0f);
  }
}

// 8 consecutive f32 values of one row (F32: the rows; INT8: the codes,
// exactly); zero past d.
template <int SRC>
__device__ __forceinline__ void load8_f32(float x[8], const void* src,
                                          long off, int kvalid, bool vec) {
  if constexpr (SRC == SRC_F32) {
    const float* p = static_cast<const float*>(src) + off;
    if (vec && kvalid >= 8) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = i < kvalid ? p[i] : 0.0f;
    }
  } else {
    const int8_t* p = static_cast<const int8_t*>(src) + off;
    if (vec && kvalid >= 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = static_cast<float>(
            static_cast<signed char>((u.x >> (8 * i)) & 0xffu));
        x[4 + i] = static_cast<float>(
            static_cast<signed char>((u.y >> (8 * i)) & 0xffu));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = i < kvalid ? static_cast<float>(p[i]) : 0.0f;
    }
  }
}

// The source switch: 8 elements of one row into the hi (and, for 3
// passes, lo) shared-memory operands.
template <int SRC, int PASSES>
__device__ __forceinline__ void fill8(bf16* hi, bf16* lo, const void* db,
                                      const void* db_lo, long off,
                                      int kvalid, bool vec) {
  if constexpr (SRC == SRC_MIRRORS) {
    load8(hi, static_cast<const bf16*>(db) + off, kvalid, vec);
    if (PASSES == 3)
      load8(lo, static_cast<const bf16*>(db_lo) + off, kvalid, vec);
  } else {
    float x[8];
    load8_f32<SRC>(x, db, off, kvalid, vec);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf16 h = __float2bfloat16_rn(x[i]);
      hi[i] = h;
      if (PASSES == 3)
        lo[i] = __float2bfloat16_rn(__fsub_rn(x[i], __bfloat162float(h)));
    }
  }
}

__device__ __forceinline__ float score_of(float dot, float colr, float qr,
                                          float invr, int mode) {
  float s;
  if (mode == 0) {
    s = __fsub_rn(__fadd_rn(colr, qr), __fmul_rn(2.0f, dot));
  } else if (mode == 1) {
    s = -dot;
  } else {
    s = -__fmul_rn(__fmul_rn(dot, colr), qr);
  }
  return __fadd_rn(s, __fmul_rn(invr, PENALTY));
}

template <int SRC, int PASSES, bool EMIT_SUPER>
__global__ void __launch_bounds__(THREADS)
coarse_minima_kernel(const bf16* __restrict__ qt_hi,
                     const bf16* __restrict__ qt_lo,
                     const float* __restrict__ qrow,
                     const void* __restrict__ db,
                     const void* __restrict__ db_lo,
                     const float* __restrict__ scales,
                     const float* __restrict__ col,
                     const float* __restrict__ inv,
                     float* __restrict__ out_tile,
                     float* __restrict__ out_sup, int d, int qp, int mode,
                     int n_qblocks, bool vec) {
  constexpr int NS = PASSES == 3 ? 2 : 1;   // hi (+ lo) operand sets
  __shared__ __align__(16) bf16 As[NS][BM][LDS];
  __shared__ __align__(16) bf16 Bs[NS][BN][LDS];
  __shared__ float tmin_s[EMIT_SUPER ? SUPER : 1][BN];

  // query block fastest: the blocks that share a database tile run
  // together and find it in L2
  const int qblk = blockIdx.x % n_qblocks;
  const long rblk = blockIdx.x / n_qblocks;
  const int q0 = qblk * BN;
  const long row0 = rblk * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // database tile (BM x BK): two 8-element chunks per row
    for (int i = tid; i < BM * 2; i += THREADS) {
      const int r = i >> 1, c = (i & 1) * 8;
      const long off = (row0 + r) * (long)d + k0 + c;
      fill8<SRC, PASSES>(&As[0][r][c], &As[NS - 1][r][c], db, db_lo, off,
                         d - (k0 + c), vec);
    }
    // query tile (BK x BN) from the (d, Qp) layout, transposed into
    // Bs[n][k]; consecutive threads read consecutive queries
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const int k = k0 + kk, q = q0 + n;
      bf16 vh = __float2bfloat16(0.0f), vl = __float2bfloat16(0.0f);
      if (k < d && q < qp) {
        vh = qt_hi[(long)k * qp + q];
        if (PASSES == 3) vl = qt_lo[(long)k * qp + q];
      }
      Bs[0][n][kk] = vh;
      if (PASSES == 3) Bs[NS - 1][n][kk] = vl;
    }
    __syncthreads();

    uint32_t a[NS][MT][4];
#pragma unroll
    for (int p = 0; p < NS; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* ap = &As[p][warp * WM + mt * 16 + g][2 * t];
        a[p][mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[p][mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS);
        a[p][mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[p][mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS + 8);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[NS][2];
#pragma unroll
      for (int p = 0; p < NS; ++p) {
        const bf16* bp = &Bs[p][nt * 8 + g][2 * t];
        b[p][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[p][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][nt], a[0][mt], b[0]);
        if (PASSES == 3) {
          mma_bf16(acc[mt][nt], a[NS - 1][mt], b[0]);   // lo . qhi
          mma_bf16(acc[mt][nt], a[0][mt], b[NS - 1]);   // hi . qlo
        }
      }
    }
    __syncthreads();
  }

  // epilogue: (scale,) score, penalty, min over each 16-row tile (the two
  // rows a thread holds, then across the 8 row groups of the warp)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long r_lo = row0 + warp * WM + mt * 16 + g;
    const long r_hi = r_lo + 8;
    const float col_lo = col[r_lo], col_hi = col[r_hi];
    const float inv_lo = inv[r_lo], inv_hi = inv[r_hi];
    const float scl_lo = SRC == SRC_INT8 ? scales[r_lo] : 1.0f;
    const float scl_hi = SRC == SRC_INT8 ? scales[r_hi] : 1.0f;
    const long tile = rblk * SUPER + warp * MT + mt;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt * 8 + 2 * t + j;
        const int q = q0 + n;
        const float qr = q < qp ? qrow[q] : 0.0f;
        float dot_lo = acc[mt][nt][j], dot_hi = acc[mt][nt][j + 2];
        if (SRC == SRC_INT8) {   // pow2 row scale: exact
          dot_lo = __fmul_rn(dot_lo, scl_lo);
          dot_hi = __fmul_rn(dot_hi, scl_hi);
        }
        float v = fminf(score_of(dot_lo, col_lo, qr, inv_lo, mode),
                        score_of(dot_hi, col_hi, qr, inv_hi, mode));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (g == 0) {
          if (q < qp) out_tile[tile * qp + q] = v;
          if (EMIT_SUPER) tmin_s[warp * MT + mt][n] = v;
        }
      }
    }
  }
  if (EMIT_SUPER) {
    __syncthreads();
    if (tid < BN && q0 + tid < qp) {
      float m = tmin_s[0][tid];
#pragma unroll
      for (int i = 1; i < SUPER; ++i) m = fminf(m, tmin_s[i][tid]);
      out_sup[rblk * qp + q0 + tid] = m;
    }
  }
}

template <int SRC, int PASSES, bool EMIT_SUPER>
void launch(const void* qt_hi, const void* qt_lo, const void* qrow,
            const void* db, const void* db_lo, const void* scales,
            const void* col, const void* inv, void* out_tile, void* out_sup,
            long n, int d, int qp, int mode, cudaStream_t stream) {
  const int n_qblocks = (qp + BN - 1) / BN;
  const long blocks = (n / BM) * (long)n_qblocks;
  // vector loads need every 8-element chunk aligned: d % 8 == 0 and an
  // aligned base (16 bytes covers all three sources)
  const bool vec = (d % 8) == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
                   (PASSES != 3 || SRC != SRC_MIRRORS ||
                    reinterpret_cast<uintptr_t>(db_lo) % 16 == 0);
  coarse_minima_kernel<SRC, PASSES, EMIT_SUPER>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          static_cast<const bf16*>(qt_hi), static_cast<const bf16*>(qt_lo),
          static_cast<const float*>(qrow), db, db_lo,
          static_cast<const float*>(scales), static_cast<const float*>(col),
          static_cast<const float*>(inv), static_cast<float*>(out_tile),
          static_cast<float*>(out_sup), d, qp, mode, n_qblocks, vec);
}

}  // namespace

// C interface (loaded with ctypes). n must be a multiple of 256; qp >= 1.
// mode: 0 euclidean, 1 dot product, 2 cosine.
// src: 0 bf16 mirrors (db = hi, db_lo = lo for 3 passes), 1 f32 rows (db),
//      2 int8 codes (db) with f32 pow2 row scales (scales, n entries).
// passes: 1 or 3 (3 only for src 0 and 1). emit_super (passes 1 only,
// and required for src 2): also write out_sup (n/256, qp).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int vdb_coarse_minima(const void* qt_hi, const void* qt_lo,
                                 const void* qrow, const void* db,
                                 const void* db_lo, const void* scales,
                                 const void* col, const void* inv,
                                 void* out_tile, void* out_sup, long n,
                                 int d, int qp, int mode, int src,
                                 int passes, int emit_super, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDB_LAUNCH(SRC, P, E)                                               \
  launch<SRC, P, E>(qt_hi, qt_lo, qrow, db, db_lo, scales, col, inv,        \
                    out_tile, out_sup, n, d, qp, mode, s)
  if (src == SRC_MIRRORS && passes == 3 && !emit_super)
    VDB_LAUNCH(SRC_MIRRORS, 3, false);                    // K3
  else if (src == SRC_MIRRORS && passes == 1 && emit_super)
    VDB_LAUNCH(SRC_MIRRORS, 1, true);                     // K1
  else if (src == SRC_MIRRORS && passes == 1)
    VDB_LAUNCH(SRC_MIRRORS, 1, false);                    // K6, K3 1-pass
  else if (src == SRC_F32 && passes == 1 && emit_super)
    VDB_LAUNCH(SRC_F32, 1, true);                         // K4
  else if (src == SRC_F32 && passes == 3 && !emit_super)
    VDB_LAUNCH(SRC_F32, 3, false);                        // K5 3-pass
  else if (src == SRC_F32 && passes == 1)
    VDB_LAUNCH(SRC_F32, 1, false);                        // K5 1-pass
  else if (src == SRC_INT8 && passes == 1 && emit_super)
    VDB_LAUNCH(SRC_INT8, 1, true);                        // K7
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef VDB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
