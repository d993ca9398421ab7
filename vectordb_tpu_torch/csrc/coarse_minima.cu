// Coarse bf16 scan with fused tile / super-tile minima (kernels K1 and K3).
//
// Replaces two Pallas kernels of vectordb_tpu/ops/coarse_kernel.py:
//   K1  _coarse_kernel_1p_sup (launcher _minima_1p_sup, src="mirrors"):
//       PASSES=1, EMIT_SUPER=1 -- one bf16 pass, 16-row tile minima AND
//       256-row super-tile minima from the same pass;
//   K3  _coarse_kernel (launcher _coarse_minima): PASSES=3 (bf16x3:
//       hi.qhi + lo.qhi + hi.qlo) or PASSES=1, EMIT_SUPER=0, tile minima
//       only.
// K4-K7 (f32 / int8 sources, the legacy 1-pass kernel) are meant to join
// as further template switches.
//
// What it computes: for every 16-row database tile t and query q,
//   min over the tile's rows r of score(r, q) + inv[r] * 1e30, with
//   score = col[r] + qrow[q] - 2 dot   (euclidean: col=|x|^2, qrow=|q|^2)
//         = -dot                        (dot product)
//         = -(dot * col[r] * qrow[q])   (cosine: col=1/|x|, qrow=1/|q|)
// where dot is the bf16 x bf16 -> f32 product. The (N, Q) score matrix
// never reaches device memory: each block reduces its scores in
// registers and writes (N/16, Q) tile minima (+ (N/256, Q) super minima).
//
// What bounds it on an H100: it is a bf16 GEMM (2*N*Q*d flops per pass;
// 6.6 TFLOP per pass at N=2^20, Q=4096, d=768) over a 1.6 GB bf16 mirror
// that is far larger than the 50 MB L2, plus a 1.07 GB tile-minima write
// at that shape. With mma.sync at the tensor cores' bf16 rate the GEMM is
// compute-bound; the first version here is limited by its own issue rate
// (single-stage shared-memory tiles, no cp.async / TMA / wgmma).
//
// What the design does about it: one block owns one 256-row super-tile x
// 64 queries, so the super minimum is a block-local reduction (no second
// pass over the tile minima, the reason K1 exists). Blocks are ordered
// query-block-fastest, so the 64 blocks that share a database tile run
// together and read it from L2 rather than from HBM. The score epilogue
// and both minima are fused into the accumulator registers. A faster
// version (TMA ring + wgmma, persistent blocks) is later work.
//
// Numerics: tensor-core f32 accumulation does not round to nearest
// (Fasi, Higham, Mikaitis & Pranesh, "Numerical behavior of NVIDIA tensor
// cores", PeerJ CS 2021), so the certificates in ops/coarse_kernel.py
// double their coarse accumulation term for results of this kernel.
// Score arithmetic uses __fadd_rn/__fmul_rn so it is not contracted into
// FMAs and matches the plain version's operation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

template <int PASSES, bool EMIT_SUPER>
__global__ void __launch_bounds__(THREADS)
coarse_minima_kernel(const bf16* __restrict__ qt_hi,
                     const bf16* __restrict__ qt_lo,
                     const float* __restrict__ qrow,
                     const bf16* __restrict__ db_hi,
                     const bf16* __restrict__ db_lo,
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
      const int kvalid = d - (k0 + c);
      load8(&As[0][r][c], db_hi + off, kvalid, vec);
      if (PASSES == 3) load8(&As[NS - 1][r][c], db_lo + off, kvalid, vec);
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

  // epilogue: score, penalty, min over each 16-row tile (the two rows a
  // thread holds, then across the 8 row groups of the warp)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long r_lo = row0 + warp * WM + mt * 16 + g;
    const long r_hi = r_lo + 8;
    const float col_lo = col[r_lo], col_hi = col[r_hi];
    const float inv_lo = inv[r_lo], inv_hi = inv[r_hi];
    const long tile = rblk * SUPER + warp * MT + mt;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt * 8 + 2 * t + j;
        const int q = q0 + n;
        const float qr = q < qp ? qrow[q] : 0.0f;
        float v = fminf(score_of(acc[mt][nt][j], col_lo, qr, inv_lo, mode),
                        score_of(acc[mt][nt][j + 2], col_hi, qr, inv_hi,
                                 mode));
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

template <int PASSES, bool EMIT_SUPER>
void launch(const void* qt_hi, const void* qt_lo, const void* qrow,
            const void* db_hi, const void* db_lo, const void* col,
            const void* inv, void* out_tile, void* out_sup, long n, int d,
            int qp, int mode, cudaStream_t stream) {
  const int n_qblocks = (qp + BN - 1) / BN;
  const long blocks = (n / BM) * (long)n_qblocks;
  const bool vec = (d % 8) == 0;
  coarse_minima_kernel<PASSES, EMIT_SUPER><<<(unsigned)blocks, THREADS, 0,
                                             stream>>>(
      static_cast<const bf16*>(qt_hi), static_cast<const bf16*>(qt_lo),
      static_cast<const float*>(qrow), static_cast<const bf16*>(db_hi),
      static_cast<const bf16*>(db_lo), static_cast<const float*>(col),
      static_cast<const float*>(inv), static_cast<float*>(out_tile),
      static_cast<float*>(out_sup), d, qp, mode, n_qblocks, vec);
}

}  // namespace

// C interface (loaded with ctypes). n must be a multiple of 256; qp >= 1.
// mode: 0 euclidean, 1 dot product, 2 cosine. passes: 1 or 3.
// emit_super (passes 1 only): also write out_sup (n/256, qp).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int vdb_coarse_minima(const void* qt_hi, const void* qt_lo,
                                 const void* qrow, const void* db_hi,
                                 const void* db_lo, const void* col,
                                 const void* inv, void* out_tile,
                                 void* out_sup, long n, int d, int qp,
                                 int mode, int passes, int emit_super,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3 && !emit_super)
    launch<3, false>(qt_hi, qt_lo, qrow, db_hi, db_lo, col, inv, out_tile,
                     out_sup, n, d, qp, mode, s);
  else if (passes == 1 && emit_super)
    launch<1, true>(qt_hi, qt_lo, qrow, db_hi, db_lo, col, inv, out_tile,
                    out_sup, n, d, qp, mode, s);
  else if (passes == 1)  // the store path never runs this switch: it is
                         // K6's body, and chip_smoke.py's control run
    launch<1, false>(qt_hi, qt_lo, qrow, db_hi, db_lo, col, inv, out_tile,
                     out_sup, n, d, qp, mode, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
