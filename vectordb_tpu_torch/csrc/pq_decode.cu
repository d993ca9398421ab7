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
// 16384 rows, m=96, d=768 that is 26.7 MB, ~8 us at 3.35 TB/s. The
// codebook (m*ksub*dsub*2 bytes: 384 KB at m=96, ksub=256, dsub=8) is read
// at random but stays in L2 (50 MB) and largely in L1 across the launch.
//
// What the design does about it: one thread per (row, subspace, V-byte
// word of the codeword); neighbouring threads take neighbouring subspaces
// of one row, so the code bytes are read and the output words written
// contiguously (one 16-byte store per codeword at dsub=8). Codewords are
// read through the read-only path (__ldg). V is the widest of 16, 8, 4, 2
// bytes that divides the codeword and the pointers' alignment, so any dsub
// (any m dividing d) and any ksub <= 256 work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// (m, ksub, dsub) bf16, out (rows, m*dsub) bf16, all contiguous. Launches on
// ``stream``, allocates nothing, returns cudaGetLastError().
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
