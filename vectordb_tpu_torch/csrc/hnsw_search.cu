// Batched HNSW search on the card (kernel H1): the whole traversal of one
// query in one thread block.
//
// Replaces vectordb_tpu/ops/hnsw_device.py hnsw_search_device, an XLA
// program (a lax.while_loop per query, vmapped), not a Pallas kernel. Its
// PyTorch form would launch about ten small ops per hop, and its loop ends
// on a device-side test, so every hop would wait for the host; here the
// loop runs inside the block and the host waits once per batch.
//
// Semantics (the JAX program's, not its layout), for query q:
//   - greedy descent over layers start_layer..1: score the current node's
//     live neighbours at the layer, move to the first minimum if it is
//     strictly closer, else drop a layer;
//   - layer 0: a sorted beam of ef (distance, slot, expanded) entries,
//     seeded with the entry node; each hop expands the first unexpanded
//     entry (the frontier's first minimum), scores its neighbours that are
//     live, not yet visited and not an earlier duplicate in the same
//     adjacency row (the first-occurrence guard), marks them visited in a
//     packed uint32 bitmask (word i holds slots 32i..32i+31), and keeps
//     the ef best of the beam followed by the new candidates, stably (a
//     tie keeps the earlier entry, as jnp.argsort does); it ends when no
//     unexpanded entry has a finite distance;
//   - with a slot mask, a second sorted list of ef entries (the result
//     track) admits only the fresh candidates whose slot passes the mask;
//     navigation stays unmasked;
//   - the first k entries (of the result track when masked) come out:
//     ranking distance finalised (euclidean: sqrt(max(d, 0))), +inf and
//     slot -1 where missing.
// Ranking distances: euclidean sum (x - q)^2 (not the norm expansion), dot
// -x.q, cosine 1 - clip(x.q / (|x| |q|), -1, 1) with a zero denominator
// read as 1; all in IEEE f32, one warp per neighbour row (each lane a
// strided slice of d, then a butterfly reduction).
//
// What bounds it on an H100: bytes, and the latency of a chain of
// dependent gathers. Each hop reads up to m_max0 rows of d f32 scattered
// across the table (3 KB each at d=768), and hop i+1 cannot start before
// hop i has merged. The bound counted by the caller is the rows the run's
// hops actually gathered over the card's memory rate.
//
// What the design does about it: one block of 256 threads per query, so
// 132 SMs each hold several queries' chains in flight at once and hide
// one another's gather latency; 8 warps score 8 neighbour rows at a time
// with 16-byte loads; the beam, its merge buffers and the candidates live
// in shared memory (a few KB at ef=200), the visited bitmask in device
// memory (N/8 bytes per query, zeroed by its block at the start). The
// merge is a rank merge: each candidate's rank among the candidates plus
// the count of beam entries <= it, each beam entry's position plus the
// count of candidates < it; no sort of the beam.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EUCLID = 0, DOT = 1, COSINE = 2;

struct Args {
  const float* vectors;       // (n, d)
  const float* norms;         // (n,)
  const int32_t* neighbors;   // (n, layers, m)
  const uint8_t* valid;       // (n,)
  const float* queries;       // (nq, d)
  const uint8_t* mask;        // (n,) or null
  uint32_t* visited;          // (nq, words)
  float* out_d;               // (nq, k)
  int32_t* out_slot;          // (nq, k)
  long n;
  int d, layers, m, words, entry, start_layer, k, ef;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the ranking distance of row `slot` to the query in shared memory, summed
// by one warp; every lane returns it
template <int MODE>
__device__ float row_dist(const Args& a, const float* q, float qn,
                          int slot, int lane) {
  const float* x = a.vectors + (long)slot * a.d;
  float acc = 0.0f;
  if ((a.d & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (a.d >> 2); i += 32) {
      const float4 xv = __ldg(x4 + i);
      const float4 qv = q4[i];
      if (MODE == EUCLID) {
        const float e0 = xv.x - qv.x, e1 = xv.y - qv.y;
        const float e2 = xv.z - qv.z, e3 = xv.w - qv.w;
        acc = fmaf(e0, e0, acc);
        acc = fmaf(e1, e1, acc);
        acc = fmaf(e2, e2, acc);
        acc = fmaf(e3, e3, acc);
      } else {
        acc = fmaf(xv.x, qv.x, acc);
        acc = fmaf(xv.y, qv.y, acc);
        acc = fmaf(xv.z, qv.z, acc);
        acc = fmaf(xv.w, qv.w, acc);
      }
    }
  } else {
    for (int i = lane; i < a.d; i += 32) {
      const float xv = __ldg(x + i);
      if (MODE == EUCLID) {
        const float e = xv - q[i];
        acc = fmaf(e, e, acc);
      } else {
        acc = fmaf(xv, q[i], acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (MODE == EUCLID) return acc;
  if (MODE == DOT) return -acc;
  const float den = __ldg(a.norms + slot) * qn;
  const float sim = acc / (den == 0.0f ? 1.0f : den);
  return 1.0f - fminf(fmaxf(sim, -1.0f), 1.0f);
}

// cd[j] = distance of candidate j (flag[j] set) or +inf, j < cnt: warp w
// takes candidates w, w + WARPS, ...
template <int MODE>
__device__ void score_candidates(const Args& a, const float* q, float qn,
                                 const int* cid, const int* flag, float* cd,
                                 int cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < cnt; j += WARPS) {
    float v = INFINITY;
    if (flag[j]) v = row_dist<MODE>(a, q, qn, cid[j], lane);
    if (lane == 0) cd[j] = v;
  }
}

// number of entries of the ascending list s[0..len) that are <= v
__device__ __forceinline__ int count_le(const float* s, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Stable merge of the sorted list (sd, si, sx) of ef entries with the m
// candidates (cd, ci, cx) into (td, ti, tx), keeping the first ef; crank[j]
// is candidate j's rank among the candidates (stable). tx/sx may be null
// (the result track carries no expanded flags).
__device__ void merge(const float* sd, const int* si, const uint8_t* sx,
                      const float* cd, const int* ci, const uint8_t* cx,
                      const int* crank, float* td, int* ti, uint8_t* tx,
                      int ef, int m) {
  for (int p = threadIdx.x; p < ef; p += THREADS) {
    const float v = sd[p];
    int less = 0;
    for (int j = 0; j < m; ++j) less += cd[j] < v;
    const int pos = p + less;
    if (pos < ef) {
      td[pos] = v;
      ti[pos] = si[p];
      if (tx) tx[pos] = sx[p];
    }
  }
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const int pos = crank[j] + count_le(sd, ef, cd[j]);
    if (pos < ef) {
      td[pos] = cd[j];
      ti[pos] = ci[j];
      if (tx) tx[pos] = cx[j];
    }
  }
}

// shared memory layout, in 4-byte words unless noted
struct Smem {
  float* q;        // d
  float* bd[2];    // beam distances, double-buffered
  int* bi[2];      // beam slots
  float* rd[2];    // result track
  int* ri[2];
  float* cd;       // candidates: distance
  float* rcd;      // candidates: result-track distance
  int* cid;        // slot (may be -1)
  int* rcid;       // result-track slot
  int* flag;       // scored this hop
  int* crank;      // rank among the candidates
  uint8_t* bx[2];  // beam expanded flags (bytes)
  uint8_t* cx;     // candidates' expanded flags (bytes)
};

__host__ __device__ inline size_t smem_bytes(int d, int ef, int m,
                                             int has_mask) {
  const size_t words = (size_t)d + 4 * ef + (has_mask ? 4 * ef : 0) + 6 * m;
  return words * 4 + 2 * (size_t)ef + m + 16;
}

__device__ Smem carve(unsigned char* base, int d, int ef, int m,
                      int has_mask) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.q = f; f += d;
  s.bd[0] = f; f += ef;
  s.bd[1] = f; f += ef;
  s.bi[0] = reinterpret_cast<int*>(f); f += ef;
  s.bi[1] = reinterpret_cast<int*>(f); f += ef;
  if (has_mask) {
    s.rd[0] = f; f += ef;
    s.rd[1] = f; f += ef;
    s.ri[0] = reinterpret_cast<int*>(f); f += ef;
    s.ri[1] = reinterpret_cast<int*>(f); f += ef;
  } else {
    s.rd[0] = s.rd[1] = nullptr;
    s.ri[0] = s.ri[1] = nullptr;
  }
  s.cd = f; f += m;
  s.rcd = f; f += m;
  s.cid = reinterpret_cast<int*>(f); f += m;
  s.rcid = reinterpret_cast<int*>(f); f += m;
  s.flag = reinterpret_cast<int*>(f); f += m;
  s.crank = reinterpret_cast<int*>(f); f += m;
  uint8_t* b = reinterpret_cast<uint8_t*>(f);
  s.bx[0] = b; b += ef;
  s.bx[1] = b; b += ef;
  s.cx = b;
  return s;
}

template <int MODE, bool MASK>
__global__ void __launch_bounds__(THREADS)
hnsw_search_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS];
  __shared__ int s_cur, s_layer, s_pick;
  __shared__ float s_curd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x;
  const int ef = a.ef, m = a.m;
  Smem s = carve(smem_raw, a.d, ef, m, MASK);
  uint32_t* vis = a.visited + (long)qi * a.words;

  // the query, its norm, a clear bitmask
  float part = 0.0f;
  for (int i = tid; i < a.d; i += THREADS) {
    const float v = a.queries[(long)qi * a.d + i];
    s.q[i] = v;
    part = fmaf(v, v, part);
  }
  for (int i = tid; i < a.words; i += THREADS) vis[i] = 0u;
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float qsq = 0.0f;
  for (int w = 0; w < WARPS; ++w) qsq += red[w];
  const float qn = sqrtf(qsq);

  // -- greedy descent, layers start_layer..1 ------------------------------
  if (warp == 0) {
    const float d0 = row_dist<MODE>(a, s.q, qn, a.entry, lane);
    if (lane == 0) {
      s_cur = a.entry;
      s_curd = d0;
      s_layer = a.start_layer;
    }
  }
  __syncthreads();
  while (s_layer >= 1) {
    const int cur = s_cur, layer = s_layer;
    if (tid < m) {
      const int nb = a.neighbors[((long)cur * a.layers + layer) * m + tid];
      s.cid[tid] = nb;
      s.flag[tid] = nb >= 0 && a.valid[nb];
    }
    __syncthreads();
    score_candidates<MODE>(a, s.q, qn, s.cid, s.flag, s.cd, m);
    __syncthreads();
    if (tid == 0) {
      float best = INFINITY;
      int bj = 0;
      for (int j = 0; j < m; ++j)
        if (s.cd[j] < best) { best = s.cd[j]; bj = j; }
      if (best < s_curd) {
        s_cur = s.cid[bj];
        s_curd = best;
      } else {
        s_layer = layer - 1;
      }
    }
    __syncthreads();
  }

  // -- layer 0: the fixed-ef sorted beam ----------------------------------
  int buf = 0;
  const int ep = s_cur;
  const float ep_d = s_curd;
  const bool ep_elig = MASK && a.mask[ep];
  for (int p = tid; p < ef; p += THREADS) {
    s.bd[0][p] = p == 0 ? ep_d : INFINITY;
    s.bi[0][p] = p == 0 ? ep : -1;
    s.bx[0][p] = 0;
    if (MASK) {
      s.rd[0][p] = (p == 0 && ep_elig) ? ep_d : INFINITY;
      s.ri[0][p] = (p == 0 && ep_elig) ? ep : -1;
    }
  }
  if (tid == 0) vis[ep >> 5] |= 1u << (ep & 31);
  __syncthreads();
  for (;;) {
    float* bd = s.bd[buf];
    int* bi = s.bi[buf];
    uint8_t* bx = s.bx[buf];
    if (tid == 0) s_pick = ef;
    __syncthreads();
    // the first unexpanded entry: the frontier's first minimum, since the
    // beam is sorted
    for (int p = tid; p < ef; p += THREADS)
      if (!bx[p]) { atomicMin(&s_pick, p); break; }
    __syncthreads();
    const int pick = s_pick;
    if (pick >= ef || !(bd[pick] < INFINITY)) break;
    const int cur = bi[pick];
    if (tid < m) {
      const int nb = a.neighbors[(long)cur * a.layers * m + tid];
      s.cid[tid] = nb;
    }
    __syncthreads();
    if (tid == 0) bx[pick] = 1;
    if (tid < m) {
      const int nb = s.cid[tid];
      const int safe = nb < 0 ? 0 : nb;
      const bool seen = (vis[safe >> 5] >> (safe & 31)) & 1u;
      bool dup = false;
      for (int j = 0; j < tid; ++j) dup |= s.cid[j] == nb;
      s.flag[tid] = nb >= 0 && a.valid[safe] && !seen && !dup;
    }
    __syncthreads();
    if (tid < m && s.flag[tid]) {
      const int nb = s.cid[tid];
      atomicOr(vis + (nb >> 5), 1u << (nb & 31));
    }
    score_candidates<MODE>(a, s.q, qn, s.cid, s.flag, s.cd, m);
    __syncthreads();
    if (tid < m) {
      const float v = s.cd[tid];
      int r = 0;
      for (int j = 0; j < m; ++j) {
        const float w = s.cd[j];
        r += (w < v) || (w == v && j < tid);
      }
      s.crank[tid] = r;
      s.cx[tid] = !s.flag[tid];
      if (MASK) {
        const bool elig = s.flag[tid] && a.mask[s.cid[tid]];
        s.rcd[tid] = elig ? v : INFINITY;
        s.rcid[tid] = elig ? s.cid[tid] : -1;
      }
    }
    __syncthreads();
    merge(bd, bi, bx, s.cd, s.cid, s.cx, s.crank, s.bd[buf ^ 1],
          s.bi[buf ^ 1], s.bx[buf ^ 1], ef, m);
    if (MASK) {
      // the result track's candidate ranks: same order rule over rcd
      __syncthreads();
      if (tid < m) {
        const float v = s.rcd[tid];
        int r = 0;
        for (int j = 0; j < m; ++j) {
          const float w = s.rcd[j];
          r += (w < v) || (w == v && j < tid);
        }
        s.crank[tid] = r;
      }
      __syncthreads();
      merge(s.rd[buf], s.ri[buf], nullptr, s.rcd, s.rcid, nullptr, s.crank,
            s.rd[buf ^ 1], s.ri[buf ^ 1], nullptr, ef, m);
    }
    __syncthreads();
    buf ^= 1;
  }

  const float* od = MASK ? s.rd[buf] : s.bd[buf];
  const int* oi = MASK ? s.ri[buf] : s.bi[buf];
  for (int j = tid; j < a.k; j += THREADS) {
    const float v = od[j];
    float outv = v;
    int slot = oi[j];
    if (!(v < INFINITY)) {
      outv = INFINITY;
      slot = -1;
    } else if (MODE == EUCLID) {
      outv = sqrtf(fmaxf(v, 0.0f));
    }
    a.out_d[(long)qi * a.k + j] = outv;
    a.out_slot[(long)qi * a.k + j] = slot;
  }
}

template <int MODE, bool MASK>
int launch(const Args& a, cudaStream_t stream, int nq) {
  const size_t bytes = smem_bytes(a.d, a.ef, a.m, MASK);
  auto fn = hnsw_search_kernel<MODE, MASK>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<nq, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const Args& a, cudaStream_t stream, int nq) {
  return a.mask ? launch<MODE, true>(a, stream, nq)
                : launch<MODE, false>(a, stream, nq);
}

}  // namespace

// Shared memory one block needs: the wrapper checks it against the card's
// per-block limit before launching.
extern "C" long vdb_hnsw_search_smem(int d, int ef, int m, int has_mask) {
  return static_cast<long>(smem_bytes(d, ef, m, has_mask));
}

extern "C" int vdb_hnsw_search(const void* vectors, const void* norms,
                               const void* neighbors, const void* valid,
                               const void* queries, const void* mask,
                               void* visited, void* out_d, void* out_slot,
                               long n, int nq, int d, int layers, int m,
                               int entry, int start_layer, int k, int ef,
                               int mode, void* stream) {
  if (nq <= 0) return 0;
  if (n <= 0 || d <= 0 || m <= 0 || m > THREADS || layers <= 0 || k <= 0 ||
      ef < k || entry < 0 || entry >= n || start_layer >= layers)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.vectors = static_cast<const float*>(vectors);
  a.norms = static_cast<const float*>(norms);
  a.neighbors = static_cast<const int32_t*>(neighbors);
  a.valid = static_cast<const uint8_t*>(valid);
  a.queries = static_cast<const float*>(queries);
  a.mask = static_cast<const uint8_t*>(mask);
  a.visited = static_cast<uint32_t*>(visited);
  a.out_d = static_cast<float*>(out_d);
  a.out_slot = static_cast<int32_t*>(out_slot);
  a.n = n;
  a.d = d;
  a.layers = layers;
  a.m = m;
  a.words = static_cast<int>((n + 31) / 32);
  a.entry = entry;
  a.start_layer = start_layer;
  a.k = k;
  a.ef = ef;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == EUCLID) return launch_mode<EUCLID>(a, s, nq);
  if (mode == DOT) return launch_mode<DOT>(a, s, nq);
  if (mode == COSINE) return launch_mode<COSINE>(a, s, nq);
  return static_cast<int>(cudaErrorInvalidValue);
}
