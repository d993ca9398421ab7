// Coarse bf16 scan for Hopper: a TMA ring feeding wgmma, with the 16-row
// tile minima (and 256-row super-tile minima) fused into the epilogue
// (kernels K1, K3, K4, K5, K6 and K7).
//
// One template, coarse_wgmma_kernel<SRC, PASSES, EMIT_SUPER>, replaces six
// Pallas kernels of vectordb_tpu/ops/coarse_kernel.py, seven
// instantiations:
//   K1  _coarse_kernel_1p_sup (:261; launcher _minima_1p_sup, src
//       "mirrors" or "bf16"): MIRRORS/1/super -- one bf16 pass over the hi
//       mirror (or a bf16-stored database);
//   K6  _coarse_kernel_1p (:185; launcher _coarse_minima_1p): MIRRORS/1/-
//       -- the same pass, tile minima only (the legacy fast path; also K3
//       at one pass);
//   K3  _coarse_kernel (:96; launcher _coarse_minima): MIRRORS/3/- (bf16x3
//       over the hi and lo mirrors: hi.qhi + lo.qhi + hi.qlo), tile minima
//       only -- tier 2 of the mirrors store;
//   K4  _coarse_kernel_f32_1p_sup (:295; src "f32"): F32/1/super -- the
//       same pass over the f32 rows, rounded to bf16 on chip;
//   K7  _coarse_kernel_int8_1p_sup (:329; src "int8"): INT8/1/super -- the
//       same pass over int8 codes widened exactly to bf16, each dot times
//       its row's pow2 scale before the score;
//   K5  _coarse_kernel_f32 (:704; launcher _coarse_minima_f32): F32/3/-
//       (bf16x3: hi.qhi + lo.qhi + hi.qlo, hi = RNE(x), lo = RNE(x - hi)
//       split on chip) and F32/1/- (one pass), tile minima only.
// It computes what coarse_minima.cu's coarse_minima_kernel<SRC, PASSES,
// EMIT_SUPER> computes, with the same score forms (score_of: __fadd_rn /
// __fmul_rn in the same order), the same PENALTY masking, and the same
// outputs: (N/16, Qp) tile minima and, with EMIT_SUPER, (N/256, Qp) super
// minima, f32, tile-major. Each super minimum is the minimum of its 16 tile
// minima, exactly. ops/cuda_kernels.py's _coarse_route sends here the K1,
// K3, K4, K5, K6 and K7 launches whose operands TMA can take (d % 8 == 0:
// a 16-byte row pitch for the bf16 queries and the bf16 / f32 rows; d % 16
// == 0 for int8 codes; 16-byte aligned rows, K3's lo mirror too); every
// other shape stays on coarse_minima.cu.
//
// What bounds it on an H100: a bf16 GEMM of 2*N*Q*d flops per pass (6.6
// TFLOP at N=2^20, Q=4096, d=768: 6.7 ms at the 989 TFLOP/s dense bf16
// rate), so the tensor cores, provided (1) they are fed by wgmma, the only
// Hopper instruction that reaches that rate, (2) loads stay in flight while
// they work, and (3) the operand traffic from L2 to the SMs stays under
// L2's rate: a 256 x 128 block tile moves (256 * s + 128 * 2 * q) * d bytes
// per 2 * 256 * 128 * d flops (s bytes per row element, q query operands):
// 77 GB at that shape for K1, 129 GB for K4's f32 rows, 51.5 GB for K7's
// codes; K5 at 3 passes moves 9.7 GB at Q=256 for 3x the flops. K3 at 3
// passes over 2^20 mirror rows: 3.2 GB of hi + lo read once (0.97 ms at
// 3.35 TB/s) for Q <= 128, so at tier 2's Q=65 it is bound by bytes.
//
// What the design does about it:
//   - Block tile: one 256-row super-tile (M: database rows) x 128 queries
//     (N). Two consumer warpgroups own 128 rows each and issue 2 x
//     m64n128k16 wgmma per k16 step and pass (128 f32 accumulators a
//     thread).
//   - Operands reach shared memory by TMA into a ring of stages: one
//     producer thread waits on a stage's "empty" mbarrier, arms its "full"
//     barrier with the byte count and issues a 2-D tensor load per operand;
//     the consumers wait on "full", run wgmma, and arrive on "empty".
//     setmaxnreg moves registers from the producer warpgroup (40) to the
//     consumers (232).
//   - MIRRORS: stages of 64 bf16 of depth (128-byte rows, 128B swizzle), 4
//     stages (48 KB each); A and B both from shared memory by descriptor;
//     one wgmma group stays in flight while the next stage is issued. At
//     three passes (K3) a stage holds 32 bf16 of depth of four operands,
//     hi and lo rows (16 KB each) and qhi and qlo (8 KB each), all 64-byte
//     rows in the 64B swizzle, 4 stages (48 KB each; at 64 of depth only
//     2 would fit); per k16 step and slab three wgmma by descriptor into
//     one accumulator (hi.qhi, lo.qhi, hi.qlo). No operand passes through
//     registers, so K3 has none of K4/K5's fragment draining.
//   - F32: stages of 32 f32 of depth (128-byte rows, 128B swizzle) and 32
//     bf16 of queries (64-byte rows, 64B swizzle), 5 stages (40 KB each) at
//     one pass; at three passes a second query operand (qlo) per stage, 4
//     stages (48 KB each). The consumers read their A fragments from the
//     f32 stage, round them with __floats2bfloat162_rn (round to nearest
//     even, as torch's cast that computes elo_max; at three passes also
//     lo = RNE(x - hi) with __fsub_rn, as coarse_minima.cu) and issue wgmma
//     with A from registers: one per slab and k16 step, three at three
//     passes (hi.qhi, lo.qhi, hi.qlo into one accumulator). A converting
//     warpgroup that writes a swizzled bf16 copy was the alternative; it
//     costs a second shared-memory buffer per stage, a proxy fence and a
//     barrier between warpgroups per stage, where the register route reads
//     each f32 element once, conflict-free, in the thread that multiplies
//     it.
//   - INT8: stages of 64 codes of depth (64-byte rows, 64B swizzle, the
//     bytes copied as they are: a UINT8 tensor map) and 64 bf16 of queries
//     (128B swizzle, K1's query stage), 6 stages (32 KB each). Each thread
//     reads four adjacent codes of a row with one 32-bit load
//     (conflict-free: a warp's 8 rows x 4 words cover 32 distinct banks
//     under the swizzle) and widens them to two packed bf16 pairs exactly
//     (widen4: no conversion unit, integer masks and a bf16 subtraction).
//     Those four codes are k = 4t..4t+3 of a k16 step, where the mma
//     fragment wants k = 2t, 2t+1, 2t+8, 2t+9: the wrapper permutes the
//     query copy's k order within each 16-block to match
//     (cuda_kernels._INT8_K_ORDER), which leaves every dot as it was, so
//     any d % 16 == 0 is taken without padding. The row's pow2 scale
//     multiplies the finished dot in the epilogue, before the score.
//   - Registers of a consumer thread (setmaxnreg 232; ptxas allocates 168
//     and keeps every instantiation free of spills): 2 x 64 f32
//     accumulators, plus A fragments of 4 registers per slab and k16 step
//     wherever A comes from registers (K1 and K3 read both operands by
//     descriptor and hold none). K4 and K5 at one pass hold one stage's
//     (2 steps x 2 slabs x 4 = 16) and drain each stage before reading
//     the next (wgmma reads its A
//     registers until its group completes). K7 and K5 at three passes
//     pipeline by k16 step instead: two sets of one step's fragments (K7:
//     2 slabs x 4 = 8 registers a set; K5: 16, hi and lo), step j + 1 read
//     and widened (split) into one set while step j's group runs on the
//     other, wgmma_wait<1> retiring step j - 1's group; a stage is released
//     once its last step's group retires. Two sets of a whole stage (2 x
//     32 registers) spill at 240 registers and ran slower on an H100.
//   - The queries arrive K-major: the wrapper passes one (Qp, d) bf16 copy
//     of qThi (and of qTlo at three passes) per call (6.3 MB at Q=4096,
//     d=768), so both operands take the same K-major swizzled layout and no
//     transpose bit is used. TMA fills rows past Qp and columns past d with
//     zeros.
//   - Epilogue in registers: in an m64 accumulator, warp w of a warpgroup
//     holds rows 16w..16w+15 of its slab -- exactly one 16-row tile. The
//     (scale,) score, the penalty and the min over the lane's two rows
//     happen in registers; a reduce-scatter over the 8 row groups (shuffles
//     at lane distance 16, 8, 4) leaves each lane 4 finished tile minima,
//     which go to a double-buffered shared tile of 16 x 128 minima. After
//     one named barrier of the consumers, the tile minima are written
//     coalesced and the super minima are the column minima of that tile.
//   - Persistent blocks: one per SM, walking the tiles query block
//     fastest, so the blocks that share a database super-tile run together
//     and the rows are read from HBM about once; the ring carries on across
//     tiles, so the next tile's loads overlap this tile's epilogue.
//
// Numerics: the dots are bf16 x bf16 products summed in f32 by the tensor
// cores (int8 codes and both halves of the f32 split are exact in bf16).
// How wgmma accumulates is not documented; chip_smoke.py phase 2 reads its
// error on raw dots for each instantiation and ops/coarse_kernel's
// _accum_coeff sets the certificates' coefficient for this body from those
// readings.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SRC_MIRRORS = 0;     // bf16 hi mirror / bf16-stored rows
constexpr int SRC_F32 = 1;         // f32 rows, rounded (split) on chip
constexpr int SRC_INT8 = 2;        // int8 codes + per-row pow2 scales

constexpr int SUB = 16;            // rows per tile
constexpr int SUPER = 16;          // tiles per super-tile
constexpr int BM = SUB * SUPER;    // database rows per block tile
constexpr int BN = 128;            // queries per block tile
constexpr int CONSUMERS = 2;       // consumer warpgroups (128 rows each)
constexpr int CTHREADS = CONSUMERS * 128;
constexpr int THREADS = CTHREADS + 128;   // + the producer warpgroup
constexpr float PENALTY = 1e30f;

// per instantiation: depth per stage, ring length, bytes of each row
// operand (A; NA of them) and of each query operand (B; NB of them), the
// query operand's wgmma layout (1: 128B swizzle, 2: 64B) and stride
// between 8-row groups, and whether the row stage has 64-byte rows (64B
// swizzle; else 128-byte rows, 128B swizzle)
template <int SRC, int PASSES> struct Cfg;
template <> struct Cfg<SRC_MIRRORS, 1> {
  static constexpr int BK = 64;          // bf16 depth per stage
  static constexpr int STAGES = 4;
  static constexpr int NA = 1;
  static constexpr int NB = 1;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr uint64_t B_LAYOUT = 1;
  static constexpr uint32_t B_SBO = 8 * BK * 2;
  static constexpr bool A_SW64 = false;
};
template <> struct Cfg<SRC_MIRRORS, 3> {
  static constexpr int BK = 32;          // bf16 depth per stage
  static constexpr int STAGES = 4;
  static constexpr int NA = 2;           // hi and lo rows
  static constexpr int NB = 2;           // qhi and qlo
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr uint64_t B_LAYOUT = 2;
  static constexpr uint32_t B_SBO = 8 * BK * 2;
  static constexpr bool A_SW64 = true;   // 64-byte rows
};
template <> struct Cfg<SRC_F32, 1> {
  static constexpr int BK = 32;          // f32 depth per stage
  static constexpr int STAGES = 5;
  static constexpr int NA = 1;
  static constexpr int NB = 1;
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr uint64_t B_LAYOUT = 2;
  static constexpr uint32_t B_SBO = 8 * BK * 2;
  static constexpr bool A_SW64 = false;
};
template <> struct Cfg<SRC_F32, 3> {
  static constexpr int BK = 32;          // f32 depth per stage
  static constexpr int STAGES = 4;
  static constexpr int NA = 1;
  static constexpr int NB = 2;           // qhi and qlo
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr uint64_t B_LAYOUT = 2;
  static constexpr uint32_t B_SBO = 8 * BK * 2;
  static constexpr bool A_SW64 = false;
};
template <> struct Cfg<SRC_INT8, 1> {
  static constexpr int BK = 64;          // codes per stage
  static constexpr int STAGES = 6;
  static constexpr int NA = 1;
  static constexpr int NB = 1;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr uint64_t B_LAYOUT = 1;
  static constexpr uint32_t B_SBO = 8 * BK * 2;
  static constexpr bool A_SW64 = true;   // 64-byte rows
};

template <int SRC, int PASSES>
constexpr int smem_bytes() {
  using C = Cfg<SRC, PASSES>;
  return 1024                                          // alignment slack
         + C::STAGES * (C::NA * C::A_BYTES + C::NB * C::B_BYTES)  // ring
         + 2 * SUPER * BN * 4                          // tile minima x 2
         + 2 * C::STAGES * 8;                          // mbarriers
}
static_assert(smem_bytes<SRC_MIRRORS, 1>() <= 232448, "shared memory");
static_assert(smem_bytes<SRC_MIRRORS, 3>() <= 232448, "shared memory");
static_assert(smem_bytes<SRC_F32, 1>() <= 232448, "shared memory");
static_assert(smem_bytes<SRC_F32, 3>() <= 232448, "shared memory");
static_assert(smem_bytes<SRC_INT8, 1>() <= 232448, "shared memory");

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

// 2-D tensor load: box at (inner c0, outer c1) into shared memory at dst,
// completion counted in bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major swizzled tile: start address,
// leading offset (unused for swizzled K-major: 1), stride offset between
// 8-row groups, layout (1: 128B swizzle, 2: 64B). Buffers are 1024-byte
// aligned, so the base offset is 0; a k16 step adds 32 bytes to the start.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint64_t layout,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
#define VDB_ACC8(b)                                                         \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),           \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define VDB_ACC64                                                           \
  VDB_ACC8(0), VDB_ACC8(8), VDB_ACC8(16), VDB_ACC8(24), VDB_ACC8(32),       \
      VDB_ACC8(40), VDB_ACC8(48), VDB_ACC8(56)
#define VDB_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A . B, m64n128k16, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VDB_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VDB_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B, m64n128k16, A from registers (the mma.m16n8k16 A fragment
// of the warp's 16 rows), B from shared memory (K-major)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VDB_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : VDB_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef VDB_ACC8
#undef VDB_ACC64
#undef VDB_REGS64

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

// one step of the reduce-scatter over a warp's row groups: the lane keeps
// the lower (upper == 0) or upper half of v, takes the min with the same
// half of its partner at lane distance ``dist``
template <int HALF>
__device__ __forceinline__ void reduce_half(float* v, int upper, int dist) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, dist));
  }
}

// two rounded values of a 128B-swizzled f32 stage (rows of 32 floats):
// row r, columns c and c + 1 (c even), as one packed bf16 pair
__device__ __forceinline__ uint32_t bf16x2_at(const uint8_t* stage, int r,
                                              int c) {
  const int off = (r * 128 + c * 4) ^ ((r & 7) << 4);
  const float2 x = *reinterpret_cast<const float2*>(stage + off);
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the bf16x3 split of the same two values: hi = RNE(x), lo = RNE(x - hi)
// (__fsub_rn, as coarse_minima.cu's fill8), each as a packed bf16 pair
__device__ __forceinline__ void split_at(const uint8_t* stage, int r, int c,
                                         uint32_t& hi, uint32_t& lo) {
  const int off = (r * 128 + c * 4) ^ ((r & 7) << 4);
  const float2 x = *reinterpret_cast<const float2*>(stage + off);
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x.x, hf.x), __fsub_rn(x.y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// four int8 codes of a 64B-swizzled code stage (rows of 64 bytes): row r,
// codes c..c+3 (c a multiple of 4). 64B swizzle XORs byte-offset bits 4-5
// with bits 7-8, which for 64-byte rows are bits 1-2 of the row
__device__ __forceinline__ uint32_t codes4_at(const uint8_t* stage, int r,
                                              int c) {
  const int off = (r * 64 + c) ^ (((r >> 1) & 3) << 4);
  return *reinterpret_cast<const uint32_t*>(stage + off);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// four int8 codes (code i in byte i of w) as two packed bf16 pairs, lo =
// (c0, c1) and hi = (c2, c3), exactly: bf16 0x43mm is 128 + m for a 7-bit
// m, and 0x4380 is 256, so (0x4300 | (b & 0x7f)) - (0x4300 | (b & 0x80)) =
// (b & 0x7f) - 128 * (b >> 7), the code; every operand and the difference
// are bf16-exact, so the subtraction does not round
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, neg = w & 0x80808080u;
  lo = bf16x2_sub(__byte_perm(mag, 0x43434343u, 0x4140),
                  __byte_perm(neg, 0x43434343u, 0x4140));
  hi = bf16x2_sub(__byte_perm(mag, 0x43434343u, 0x4342),
                  __byte_perm(neg, 0x43434343u, 0x4342));
}

// the A fragments of one k16 step for wgmma from registers, [slab][4]:
// rows g and g + 8 of the warp's 16, columns 2t and 2t + 8 (the
// mma.m16n8k16 A layout); hi holds the rounded f32 rows or the widened
// codes, lo the f32 rows' lo halves at three passes
template <int PASSES> struct StepFrags {
  uint32_t hi[2][4];
  uint32_t lo[PASSES == 3 ? 2 : 1][4];
};

template <int SRC, int PASSES>
__device__ __forceinline__ void load_step(StepFrags<PASSES>& f,
                                          const uint8_t* as, int kk, int wg,
                                          int w, int g, int t) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = wg * 128 + s * 64 + w * 16 + g;
    if constexpr (SRC == SRC_INT8) {
      // codes 4t..4t+3 of the k16 step: the query copy's k order
      const int c = kk * 16 + 4 * t;
      widen4(codes4_at(as, r, c), f.hi[s][0], f.hi[s][2]);
      widen4(codes4_at(as, r + 8, c), f.hi[s][1], f.hi[s][3]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kk * 16 + 8 * h + 2 * t;
        split_at(as, r, c, f.hi[s][2 * h], f.lo[s][2 * h]);
        split_at(as, r + 8, c, f.hi[s][2 * h + 1], f.lo[s][2 * h + 1]);
      }
    }
  }
}

// one k16 step's wgmma group: per slab hi.qhi, and at three passes lo.qhi,
// then hi.qlo, into one accumulator; the query operands at b0 (qlo at
// b0 + B_BYTES)
template <int SRC, int PASSES>
__device__ __forceinline__ void issue_step(float (&acc)[2][64],
                                           const StepFrags<PASSES>& f,
                                           uint32_t b0, int kk, bool first) {
  using C = Cfg<SRC, PASSES>;
  const uint64_t db = smem_desc(b0 + kk * 32, C::B_LAYOUT, C::B_SBO);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    wgmma_rs(acc[s], f.hi[s], db, !first);
    if constexpr (PASSES == 3) {
      const uint64_t dbl =
          smem_desc(b0 + C::B_BYTES + kk * 32, C::B_LAYOUT, C::B_SBO);
      wgmma_rs(acc[s], f.lo[s], db, 1);
      wgmma_rs(acc[s], f.hi[s], dbl, 1);
    }
  }
}

// keeps one step's fragment registers live (unmoved, not reused) up to
// this point of the program: wgmma reads them asynchronously
template <int PASSES>
__device__ __forceinline__ void fence_step(StepFrags<PASSES>& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm volatile("" : "+r"(f.hi[s][i]) :: "memory");
      if constexpr (PASSES == 3)
        asm volatile("" : "+r"(f.lo[s][i]) :: "memory");
    }
}

template <int SRC, int PASSES, bool EMIT_SUPER>
__global__ void __launch_bounds__(THREADS, 1)
coarse_wgmma_kernel(const __grid_constant__ CUtensorMap tm_db,
                    const __grid_constant__ CUtensorMap tm_lo,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_qlo,
                    const float* __restrict__ qrow,
                    const float* __restrict__ scales,
                    const float* __restrict__ col,
                    const float* __restrict__ inv,
                    float* __restrict__ out_tile,
                    float* __restrict__ out_sup, int d, int qp, int mode,
                    int n_qblocks, int n_tiles) {
  using C = Cfg<SRC, PASSES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int A_STAGE = C::NA * C::A_BYTES;     // [stage][NA] buffers
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + C::STAGES * A_STAGE;       // [stage][NB] buffers
  float* tmin_s =
      reinterpret_cast<float*>(b_s + C::STAGES * C::NB * C::B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(tmin_s + 2 * SUPER * BN);
  uint64_t* empty = full + C::STAGES;
  const int nk = (d + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CTHREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CTHREADS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int q0 = (tile % n_qblocks) * BN;
        const int row0 = (tile / n_qblocks) * BM;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t fb = smem_u32(&full[stage]);
          mbar_expect_tx(fb, A_STAGE + C::NB * C::B_BYTES);
          uint8_t* as = a_s + stage * A_STAGE;
          tma_load(smem_u32(as), &tm_db, fb, kb * C::BK, row0);
          if constexpr (C::NA == 2)
            tma_load(smem_u32(as + C::A_BYTES), &tm_lo, fb, kb * C::BK,
                     row0);
          uint8_t* bs = b_s + stage * C::NB * C::B_BYTES;
          tma_load(smem_u32(bs), &tm_q, fb, kb * C::BK, q0);
          if constexpr (C::NB == 2)
            tma_load(smem_u32(bs + C::B_BYTES), &tm_qlo, fb, kb * C::BK, q0);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma over the ring, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x;
    const int w = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[2][64];
    int stage = 0, buf = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int q0 = (tile % n_qblocks) * BN;
      const long rblk = tile / n_qblocks;
      if constexpr (SRC == SRC_MIRRORS) {
        // rows of AROW bytes (128: 128B swizzle; K3's 64: 64B swizzle)
        constexpr int AROW = C::BK * 2;
        constexpr uint64_t A_LAYOUT = C::A_SW64 ? 2 : 1;
        int prev = 0;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(smem_u32(&full[stage]), phase);
          // this warpgroup's 128 rows, slab s at +64 rows (the lo rows at
          // +A_BYTES, qlo at +B_BYTES)
          const uint32_t a0 =
              smem_u32(a_s + stage * A_STAGE) + wg * 128 * AROW;
          const uint32_t b0 = smem_u32(b_s + stage * C::NB * C::B_BYTES);
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk) {
            const uint32_t bk = b0 + kk * 32;
            const uint64_t db = smem_desc(bk, C::B_LAYOUT, C::B_SBO);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const uint32_t ak = a0 + s * 64 * AROW + kk * 32;
              const uint64_t da = smem_desc(ak, A_LAYOUT, 8 * AROW);
              wgmma_ss(acc[s], da, db, (kb | kk) != 0);
              if constexpr (PASSES == 3) {       // + lo.qhi + hi.qlo
                const uint64_t dal =
                    smem_desc(ak + C::A_BYTES, A_LAYOUT, 8 * AROW);
                const uint64_t dbl =
                    smem_desc(bk + C::B_BYTES, C::B_LAYOUT, C::B_SBO);
                wgmma_ss(acc[s], dal, db, 1);
                wgmma_ss(acc[s], da, dbl, 1);
              }
            }
          }
          wgmma_commit();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          if (kb > 0) {            // the previous stage's group is done
            wgmma_wait<1>();
            mbar_arrive(smem_u32(&empty[prev]));
          }
          prev = stage;
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        mbar_arrive(smem_u32(&empty[prev]));
      } else if constexpr (SRC == SRC_INT8 || PASSES == 3) {
        // A from registers, one k16 step a group: step j + 1 is read and
        // widened (split) into one set of fragments while step j's group
        // runs on the other; wgmma_wait<1> retires step j - 1's group, and
        // a stage is released once its last step's group is retired
        constexpr int KS = C::BK / 16;
        static_assert(KS % 2 == 0, "a stage ends on the second set");
        StepFrags<PASSES> sf[2];
        int prev = stage;
        mbar_wait(smem_u32(&full[stage]), phase);
        load_step<SRC, PASSES>(sf[0], a_s + stage * A_STAGE, 0, wg, w, g, t);
        for (int kb = 0; kb < nk; ++kb) {
          const uint8_t* as = a_s + stage * A_STAGE;
          const uint32_t b0 = smem_u32(b_s + stage * C::NB * C::B_BYTES);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            wgmma_fence();
            issue_step<SRC, PASSES>(acc, sf[kk & 1], b0, kk,
                                    kb == 0 && kk == 0);
            wgmma_commit();
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            wgmma_wait<1>();           // step kk - 1's group is done
            fence_step(sf[(kk + 1) & 1]);
            if (kk == 0 && kb > 0) mbar_arrive(smem_u32(&empty[prev]));
            if (kk + 1 < KS)
              load_step<SRC, PASSES>(sf[(kk + 1) & 1], as, kk + 1, wg, w, g,
                                     t);
          }
          prev = stage;
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (kb + 1 < nk) {
            mbar_wait(smem_u32(&full[stage]), phase);
            load_step<SRC, PASSES>(sf[0], a_s + stage * A_STAGE, 0, wg, w, g,
                                   t);
          }
        }
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        mbar_arrive(smem_u32(&empty[prev]));
      } else {
        // K4 and K5 at one pass: one stage's fragments [kk][slab][4], rows
        // g and g + 8 of the warp's 16, columns 2t and 2t + 8 of the k16
        // step, rounded to bf16 (RNE); the stage drains before the next is
        // read, since wgmma reads the registers until the group completes
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(smem_u32(&full[stage]), phase);
          const uint8_t* as = a_s + stage * A_STAGE;
          uint32_t a[C::BK / 16][2][4];
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const int r = wg * 128 + s * 64 + w * 16 + g;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = kk * 16 + 8 * h + 2 * t;
                a[kk][s][2 * h] = bf16x2_at(as, r, c);
                a[kk][s][2 * h + 1] = bf16x2_at(as, r + 8, c);
              }
            }
          const uint32_t b0 = smem_u32(b_s + stage * C::B_BYTES);
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk) {
            const uint64_t db = smem_desc(b0 + kk * 32, C::B_LAYOUT,
                                          C::B_SBO);
#pragma unroll
            for (int s = 0; s < 2; ++s)
              wgmma_rs(acc[s], a[kk][s], db, (kb | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          mbar_arrive(smem_u32(&empty[stage]));
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }

      // ---- epilogue: (scale,) score, penalty, tile minima, super minima --
      // acc[s][4j + e] holds row 16w + g + 8 (e >> 1) of slab s, query
      // column 8j + 2t + (e & 1)
      float* tm = tmin_s + buf * SUPER * BN;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int tl = wg * 8 + s * 4 + w;        // tile in the super-tile
        const long r_lo = rblk * BM + tl * SUB + g;
        const long r_hi = r_lo + 8;
        const float col_lo = col[r_lo], col_hi = col[r_hi];
        const float inv_lo = inv[r_lo], inv_hi = inv[r_hi];
        float scl_lo = 1.0f, scl_hi = 1.0f;
        if constexpr (SRC == SRC_INT8) {
          scl_lo = scales[r_lo];
          scl_hi = scales[r_hi];
        }
        float v[32];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = q0 + 8 * j + 2 * t + e;
            const float qr = q < qp ? __ldg(&qrow[q]) : 0.0f;
            float dot_lo = acc[s][4 * j + e], dot_hi = acc[s][4 * j + 2 + e];
            if constexpr (SRC == SRC_INT8) {   // pow2 row scale: exact
              dot_lo = __fmul_rn(dot_lo, scl_lo);
              dot_hi = __fmul_rn(dot_hi, scl_hi);
            }
            v[2 * j + e] = fminf(score_of(dot_lo, col_lo, qr, inv_lo, mode),
                                 score_of(dot_hi, col_hi, qr, inv_hi, mode));
          }
        // over the 8 row groups g (lane bits 4, 3, 2): v[i] then holds the
        // tile minimum of column 16g + 8 (i >> 1) + 2t + (i & 1)
        reduce_half<16>(v, (g >> 2) & 1, 16);
        reduce_half<8>(v, (g >> 1) & 1, 8);
        reduce_half<4>(v, g & 1, 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tm[tl * BN + 16 * g + 8 * (i >> 1) + 2 * t + (i & 1)] = v[i];
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(CTHREADS) : "memory");
      for (int i = ct; i < SUPER * BN; i += CTHREADS) {
        const int q = q0 + i % BN;
        if (q < qp) out_tile[(rblk * SUPER + i / BN) * (long)qp + q] = tm[i];
      }
      if constexpr (EMIT_SUPER) {
        if (ct < BN && q0 + ct < qp) {
          float m = tm[ct];
#pragma unroll
          for (int i = 1; i < SUPER; ++i) m = fminf(m, tm[i * BN + ct]);
          out_sup[rblk * (long)qp + q0 + ct] = m;
        }
      }
      buf ^= 1;     // the next tile's minima go to the other buffer
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major (outer, inner) tensor, boxes of (box_outer, box_inner);
// elements past the tensor's edge load as zeros
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              long inner, long outer, long pitch_bytes, int box_inner,
              int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int SRC, int PASSES, bool EMIT_SUPER>
int launch(const void* qk, const void* qk_lo, const void* qrow,
           const void* db, const void* db_lo, const void* scales,
           const void* col,
           const void* inv, void* out_tile, void* out_sup, long n, int d,
           int qp, int mode, cudaStream_t stream) {
  using C = Cfg<SRC, PASSES>;
  const int n_qblocks = (qp + BN - 1) / BN;
  const long n_tiles = (n / BM) * static_cast<long>(n_qblocks);
  if (n_tiles < 1 || n_tiles > 0x7fffffffL || n > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType db_type =
      SRC == SRC_F32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : SRC == SRC_INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long db_item = SRC == SRC_F32 ? 4 : SRC == SRC_INT8 ? 1 : 2;
  const CUtensorMapSwizzle q_swizzle = C::B_LAYOUT == 1
                                           ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle db_swizzle = C::A_SW64
                                            ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_db, tm_lo, tm_q, tm_qlo;
  bool ok =
      make_map(&tm_db, db_type, db, d, n, static_cast<long>(d) * db_item,
               C::BK, BM, db_swizzle) &&
      make_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qk, d, qp,
               static_cast<long>(d) * 2, C::BK, BN, q_swizzle);
  if (PASSES == 3)
    ok = ok && make_map(&tm_qlo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qk_lo, d,
                        qp, static_cast<long>(d) * 2, C::BK, BN, q_swizzle);
  else
    tm_qlo = tm_q;                 // not read at one pass
  if (C::NA == 2)                  // K3: the lo mirror, as the hi one
    ok = ok && make_map(&tm_lo, db_type, db_lo, d, n,
                        static_cast<long>(d) * db_item, C::BK, BM,
                        db_swizzle);
  else
    tm_lo = tm_db;                 // not read
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<SRC, PASSES>();
  cudaError_t e = cudaFuncSetAttribute(
      coarse_wgmma_kernel<SRC, PASSES, EMIT_SUPER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  coarse_wgmma_kernel<SRC, PASSES, EMIT_SUPER><<<grid, THREADS, smem,
                                                 stream>>>(
      tm_db, tm_lo, tm_q, tm_qlo, static_cast<const float*>(qrow),
      static_cast<const float*>(scales), static_cast<const float*>(col),
      static_cast<const float*>(inv), static_cast<float*>(out_tile),
      static_cast<float*>(out_sup), d, qp, mode, n_qblocks,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). qk (and qk_lo at three passes): the
// queries as (qp, d) bf16, K-major (for src 2 with each 16-block of k in the
// order cuda_kernels._INT8_K_ORDER gives); db: (n, d) bf16 (src 0: the hi
// mirror, and db_lo the lo mirror at three passes), f32 (src 1) or int8
// codes (src 2, with f32 pow2 row scales ``scales``, n entries) rows,
// 16-byte aligned, d % 8 == 0 (d % 16 == 0 for src 2); n a positive
// multiple of 256; qp >= 1. mode: 0 euclidean, 1 dot product, 2 cosine.
// Routed: src 0 and src 1 at one pass with or without super minima, and
// at three passes without; src 2 at one pass with super minima. Writes
// out_tile (n/16, qp) and, with emit_super, out_sup (n/256, qp). Launches
// on ``stream``, allocates nothing, returns a cudaError_t.
extern "C" int vdb_coarse_wgmma(const void* qk, const void* qk_lo,
                                const void* qrow, const void* db,
                                const void* db_lo, const void* scales,
                                const void* col,
                                const void* inv, void* out_tile,
                                void* out_sup, long n, int d, int qp,
                                int mode, int src, int passes,
                                int emit_super, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d % 8 != 0 || qp < 1 || n % BM != 0 ||
      reinterpret_cast<uintptr_t>(db) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qk) % 16 != 0 ||
      (src == SRC_INT8 && (d % 16 != 0 || scales == nullptr)) ||
      (passes == 3 && (qk_lo == nullptr ||
                       reinterpret_cast<uintptr_t>(qk_lo) % 16 != 0)) ||
      (src == SRC_MIRRORS && passes == 3 &&
       (db_lo == nullptr || reinterpret_cast<uintptr_t>(db_lo) % 16 != 0)) ||
      (emit_super && out_sup == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define VDB_LAUNCH(SRC, P, E)                                                \
  launch<SRC, P, E>(qk, qk_lo, qrow, db, db_lo, scales, col, inv,           \
                    out_tile, out_sup, n, d, qp, mode, s)
  if (src == SRC_MIRRORS && passes == 1 && emit_super)
    return VDB_LAUNCH(SRC_MIRRORS, 1, true);               // K1
  if (src == SRC_MIRRORS && passes == 1 && !emit_super)
    return VDB_LAUNCH(SRC_MIRRORS, 1, false);              // K6; K3, 1 pass
  if (src == SRC_MIRRORS && passes == 3 && !emit_super)
    return VDB_LAUNCH(SRC_MIRRORS, 3, false);              // K3, 3 passes
  if (src == SRC_F32 && passes == 1 && emit_super)
    return VDB_LAUNCH(SRC_F32, 1, true);                   // K4
  if (src == SRC_INT8 && passes == 1 && emit_super)
    return VDB_LAUNCH(SRC_INT8, 1, true);                  // K7
  if (src == SRC_F32 && passes == 3 && !emit_super)
    return VDB_LAUNCH(SRC_F32, 3, false);                  // K5, 3 passes
  if (src == SRC_F32 && passes == 1 && !emit_super)
    return VDB_LAUNCH(SRC_F32, 1, false);                  // K5, 1 pass
#undef VDB_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
