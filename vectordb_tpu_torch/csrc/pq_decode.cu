// PQ decode: uint8 codes -> bf16 rows, bit for bit the codewords (kernel K8).
//
// Replaces vectordb_tpu/ops/pq.py _pq_decode_pallas_kernel (launcher
// pq_decode_rows, reached from pq_scan_topr through _decode_block_auto):
//   out[i, c*dsub : (c+1)*dsub] = codebook[c, codes[i, c], :]
// for every row i and subspace c, with the codebook (m, ksub, dsub) bf16
// (pq_fit rounds codewords to bf16 values, so the bf16 table is exact).
// The TPU kernel reached the MXU with a one-hot matmul against the packed
// block-diagonal codebook; each output element has one nonzero term, so
// it was a table lookup written as a product. On Hopper it is the lookup.
//
// What bounds it on an H100: bytes. It reads rows*m code bytes and writes
// rows*d*2 bytes of bf16 and does no arithmetic; at the scan chunk of
// 16384 rows, m=96, d=768 that is 26.7 MB, ~8 us at 3.35 TB/s (PyTorch's
// fill kernel writes the same 25.2 MB output in ~8.4 us). The codebook
// (m*ksub*dsub*2 bytes: 384 KB at m=96, ksub=256, dsub=8) is the only data
// read more than once, at random: one 16-byte read per output word, each
// to another L1 line, so the L1's rate of scattered reads and the wait
// for each block's first codes are what keep a decode above the fill.
//
// Two bodies, chosen by shape in ops/cuda_kernels._decode_route:
//
// "tile_ring" (pq_decode_tiles_kernel), for 16-byte codewords or a multiple
// of them (dsub % 8 == 0) with 16-byte aligned codes, codebook and output,
// and codes of 16 rows that fit twice in shared memory (m <= 4096 by the
// route).
//   What the design does about it:
//     - Work items are a tile of rows (a multiple of 16, so every tile's
//       codes start 16-byte aligned) times a group of subspaces whose
//       codebook slice fits in L1 beside the other blocks' (the wrapper's
//       plan, _decode_plan: 32 rows x 24 subspaces, a 96 KB slice, at the
//       scan chunk). Persistent blocks, four an SM, walk the items; the
//       grid is a multiple of the group count, so a block keeps one group
//       and its slice stays in L1 across its items.
//     - Thread 0 brings each item's codes (whole rows: one contiguous run)
//       into a ring of two shared-memory stages by one 1-D bulk copy
//       (cp.async.bulk, mbarrier completion), one item ahead: no codeword
//       load waits on a code byte from global memory. A last tile whose
//       code bytes are not a multiple of 16 copies the multiple, and its
//       last few bytes are read from global memory.
//     - Neighbouring threads take neighbouring 16-byte output words, so a
//       warp reads 32 neighbouring code bytes from the stage (one
//       conflict-free wavefront) and its stores are coalesced 16-byte
//       stores. Each thread issues BATCH independent codeword loads
//       (ld.global.nc, L1 evict-last: the slice is the data re-read) before
//       it stores any of them.
//     - Index arithmetic is 32-bit and division-free in the loop: each
//       thread steps its (row, subspace, word) by the block's width with
//       carries, from a split computed once an item.
//   Forms timed and not kept (PERF.md): the codebook slice in shared
//   memory (its 12.7 MB load at the start cost more than the L1 misses it
//   saved), a shared-memory output tile sent by bulk stores, no subspace
//   groups, larger or smaller items, more loads in flight, more or fewer
//   threads an SM, a first item read without the ring, an evict-last
//   output.
//
// "grid_stride" (pq_decode_kernel), every other shape (dsub % 8 != 0,
//   unaligned pointers, wider m): one thread per (row, subspace, V-byte
//   word of the codeword), neighbouring threads on neighbouring subspaces
//   of one row, a grid-stride loop over at most 132 x 16 blocks. V is the
//   widest of 16, 8, 4, 2 bytes that divides the codeword and the
//   pointers' alignment, so any dsub and any ksub <= 256 work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- tile_ring

constexpr int RTHREADS = 256;
constexpr int STAGES = 2;              // code tiles in the ring
constexpr int BLOCKS_PER_SM = 4;       // the persistent grid
constexpr int BATCH = 4;               // codeword loads in flight a thread
constexpr int BAR_BYTES = 64;          // STAGES mbarriers, padded
constexpr int SMEM_LIMIT = 232448;     // Hopper, one block

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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// 1-D bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory, completion counted in
// bytes on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// one 16-byte codeword word through the read-only path, kept in L1
__device__ __forceinline__ uint4 ld_codeword(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::evict_last.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__global__ void __launch_bounds__(RTHREADS, BLOCKS_PER_SM)
pq_decode_tiles_kernel(const uint8_t* __restrict__ codes,
                       const uint4* __restrict__ cb, uint4* __restrict__ out,
                       long rows, int m, int ksub, int words, int tile_rows,
                       int group, int n_groups, int items) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + BAR_BYTES;
  const int stage_bytes = tile_rows * m;           // a multiple of 16
  const int tid = threadIdx.x;
  const int row_words = m * words;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: copy the codes of this block's local-th item into its stage
  auto issue = [&](int local) {
    const int item = blockIdx.x + local * gridDim.x;
    if (item >= items) return;
    const long row0 = static_cast<long>(item / n_groups) * tile_rows;
    const long nrows = rows - row0 < tile_rows ? rows - row0 : tile_rows;
    const uint32_t bulk = static_cast<uint32_t>(nrows * m) & ~15u;
    const int s = local % STAGES;
    mbar_expect_tx(smem_u32(&full[s]), bulk);
    if (bulk)
      bulk_load(smem_u32(ring + s * stage_bytes), codes + row0 * m, bulk,
                smem_u32(&full[s]));
  };
  if (tid == 0)
    for (int l = 0; l < STAGES; ++l) issue(l);

  for (int local = 0;; ++local) {
    const int item = blockIdx.x + local * gridDim.x;
    if (item >= items) break;
    const int t = item / n_groups;
    const int c0 = (item - t * n_groups) * group;
    const long row0 = static_cast<long>(t) * tile_rows;
    const int nrows = static_cast<int>(
        rows - row0 < tile_rows ? rows - row0 : tile_rows);
    const int gsize = min(group, m - c0);
    const int cols = gsize * words;                 // output words a row
    const int total = nrows * cols;
    const int bulk = (nrows * m) & ~15;
    const int s = local % STAGES;
    const uint8_t* stage = ring + s * stage_bytes;
    const uint8_t* tail = codes + row0 * m;         // bytes past ``bulk``
    uint4* dst = out + row0 * row_words + c0 * words;
    // word o = tid as (row r, subspace c, word w), and the step of
    // RTHREADS words as (dr, dc, dw)
    int r = tid / cols;
    int c = (tid - r * cols) / words;
    int w = tid - r * cols - c * words;
    const int dr = RTHREADS / cols;
    const int dc = (RTHREADS - dr * cols) / words;
    const int dw = RTHREADS - dr * cols - dc * words;
    mbar_wait(smem_u32(&full[s]), (local / STAGES) & 1);
    for (int o0 = 0; o0 < total; o0 += BATCH * RTHREADS) {
      uint4 v[BATCH];
      int at[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        at[u] = -1;
        if (o0 + u * RTHREADS + tid < total) {
          const int p = r * m + c0 + c;
          const int code = p < bulk ? stage[p] : tail[p];
          v[u] = ld_codeword(cb + ((c0 + c) * ksub + code) * words + w);
          at[u] = r * row_words + c * words + w;
        }
        w += dw;
        c += dc;
        if (w >= words) {
          w -= words;
          ++c;
        }
        if (c >= gsize) {
          c -= gsize;
          ++r;
        }
        r += dr;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (at[u] >= 0) dst[at[u]] = v[u];
    }
    __syncthreads();            // every thread is done with stage s
    if (tid == 0) issue(local + STAGES);
  }
}

// per device: SM count, and the dynamic shared memory the kernel may use
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

cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(pq_decode_tiles_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

int launch_tiles(const void* codes, const void* cb, void* out, long rows,
                 int m, int ksub, int dsub, int tile_rows, int group,
                 cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(codes) |
                          reinterpret_cast<uintptr_t>(cb) |
                          reinterpret_cast<uintptr_t>(out);
  if (dsub % 8 != 0 || align % 16 != 0 || tile_rows < 16 ||
      tile_rows % 16 != 0 || group < 1 || group > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = dsub / 8;
  const int n_groups = (m + group - 1) / group;
  const long n_tiles = (rows + tile_rows - 1) / tile_rows;
  if (n_tiles * n_groups >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = static_cast<int>(n_tiles * n_groups);
  const long smem = BAR_BYTES + static_cast<long>(STAGES) * tile_rows * m;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  int grid = sms * BLOCKS_PER_SM;
  if (grid >= n_groups) grid -= grid % n_groups;   // a block keeps a group
  if (grid > items) grid = items;
  pq_decode_tiles_kernel<<<grid, RTHREADS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint4*>(cb),
      static_cast<uint4*>(out), rows, m, ksub, words, tile_rows, group,
      n_groups, items);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- grid_stride

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;    // grid-stride beyond this

template <int V> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };

template <int V>
__global__ void __launch_bounds__(THREADS)
pq_decode_kernel(const uint8_t* __restrict__ codes,
                 const char* __restrict__ cb, char* __restrict__ out,
                 long rows, int m, int ksub, int sub_bytes) {
  using W = typename Word<V>::T;
  const int per_sub = sub_bytes / V;            // words per codeword
  const long per_row = (long)m * per_sub;
  const long total = rows * per_row;
  for (long t = blockIdx.x * (long)THREADS + threadIdx.x; t < total;
       t += (long)gridDim.x * THREADS) {
    const long row = t / per_row;
    const int rem = static_cast<int>(t - row * per_row);
    const int c = rem / per_sub;
    const int w = rem - c * per_sub;
    // codes are < ksub: pq_encode emits them so, adopt_codes checks
    const int code = codes[row * m + c];
    const W* src = reinterpret_cast<const W*>(
        cb + ((long)c * ksub + code) * sub_bytes);
    W* dst = reinterpret_cast<W*>(out + (row * m + c) * (long)sub_bytes);
    dst[w] = __ldg(src + w);
  }
}

template <int V>
int launch(const void* codes, const void* cb, void* out, long rows, int m,
           int ksub, int sub_bytes, cudaStream_t stream) {
  const long total = rows * (long)m * (sub_bytes / V);
  const long want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  pq_decode_kernel<V><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const char*>(cb),
      static_cast<char*>(out), rows, m, ksub, sub_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). codes (rows, m) uint8, each < ksub, cb
// (m, ksub, dsub) bf16, out (rows, m*dsub) bf16, all contiguous. Each
// launches on ``stream``, allocates nothing and returns cudaGetLastError().

// "tile_ring": tiles of ``tile_rows`` rows (a multiple of 16) times groups
// of ``group`` subspaces (the wrapper's _decode_plan); dsub % 8 == 0, all
// three pointers 16-byte aligned and m <= 4096, else cudaErrorInvalidValue
extern "C" int vdb_pq_decode_tiles(const void* codes, const void* cb,
                                   void* out, long rows, int m, int ksub,
                                   int dsub, int tile_rows, int group,
                                   void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  return launch_tiles(codes, cb, out, rows, m, ksub, dsub, tile_rows, group,
                      static_cast<cudaStream_t>(stream));
}

// "grid_stride": any shape
extern "C" int vdb_pq_decode(const void* codes, const void* cb, void* out,
                             long rows, int m, int ksub, int dsub,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || m <= 0) return 0;
  const int sub_bytes = dsub * 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(cb) |
                          reinterpret_cast<uintptr_t>(out);
  if (sub_bytes % 16 == 0 && align % 16 == 0)
    return launch<16>(codes, cb, out, rows, m, ksub, sub_bytes, s);
  if (sub_bytes % 8 == 0 && align % 8 == 0)
    return launch<8>(codes, cb, out, rows, m, ksub, sub_bytes, s);
  if (sub_bytes % 4 == 0 && align % 4 == 0)
    return launch<4>(codes, cb, out, rows, m, ksub, sub_bytes, s);
  return launch<2>(codes, cb, out, rows, m, ksub, sub_bytes, s);
}
