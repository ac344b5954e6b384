// Exact top-k similarity scans over packed fingerprints, for sm_90a.
//
// Replaces the two Pallas kernels of the exhaustive search path in
// src/repro/kernels/tanimoto_topk.py:
//   * fused_tanimoto_topk  -> tanimoto_topk_cuda (full scan, brute force)
//   * windowed_fused_topk  -> window_topk_cuda   (per-query row window,
//                                                 BitBound+folding stage 1)
//
// Both compute, per query, the exact top-k of metric(c, a, b) over the rows
// they scan, with ties going to the lowest row index, and write -1 / -inf in
// the slots no row fills. The metric is a template parameter; every score is
// one correctly rounded f32 divide (__fdiv_rn) of exact integers, cosine
// adds one correctly rounded sqrt (__fsqrt_rn), so the scores are bit-equal
// to the plain PyTorch version. Build without --use_fast_math.
//
// What bounds it on the H100. At the main path's shape (Q=1024 queries,
// N=2^21 capacity rows, W=32 words) the full scan does Q*N*W = 6.9e10
// AND+POPC pairs. POPC issues at 16 per clock per SM on compute capability
// 9.0, so 132 SMs at 1.98 GHz retire at most 4.2e12 a second: about 16 ms.
// The database is 256 MiB; read once it takes 0.08 ms at 3.35 TB/s, and
// even read once per query from device memory it would take 80 ms. So the
// kernel must keep the DB reads of different queries in L2 and be bound by
// the popcount issue rate.
//
// What the design does about it:
//   * pass 1: grid (query, split). Block x = query is the fastest grid axis,
//     so the resident blocks are ~1000 queries walking the same rows of the
//     same split roughly in step, and their row reads hit L2. Each thread
//     scores whole rows (16-byte loads where W % 4 == 0) against the query
//     held in shared memory, so the inner loop is LOP3 + POPC + IADD.
//   * selection is off the critical path: a row becomes a candidate only if
//     its 64-bit key (score bits << 32 | ~row) beats the block's current
//     k-th best key, and candidates are appended to a shared buffer that is
//     bitonic-sorted only when it fills. After the first step almost no row
//     passes the threshold, so the block spends its time scoring.
//   * pass 2: one block per query merges the splits' k candidates by the
//     same key.
// A block cannot carry a running top-k across the grid as the TPU grid
// does, hence the two passes. Query blocking, cp.async/TMA staging and a
// warp-level top-k are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 1024;                   // rows scored per block step
constexpr int kRowsPerThread = kStep / kThreads;

enum MetricId { kTanimoto = 0, kDice = 1, kCosine = 2, kTversky = 3 };

template <int M>
__device__ __forceinline__ float metric_score(int c, int a, int b, int pa,
                                              int pb) {
  if (M == kTanimoto) {
    const int u = a + b - c;
    return u > 0 ? __fdiv_rn(static_cast<float>(c), static_cast<float>(u))
                 : 0.0f;
  } else if (M == kDice) {
    const int d = a + b;
    return d > 0 ? __fdiv_rn(static_cast<float>(2 * c), static_cast<float>(d))
                 : 0.0f;
  } else if (M == kCosine) {
    const int p = a * b;
    const float r = __fdiv_rn(static_cast<float>(c * c),
                              static_cast<float>(p > 1 ? p : 1));
    return p > 0 ? __fsqrt_rn(r) : 0.0f;
  } else {
    const int num = 256 * c;
    const int den = num + pa * (a - c) + pb * (b - c);
    return den > 0 ? __fdiv_rn(static_cast<float>(num), static_cast<float>(den))
                   : 0.0f;
  }
}

// Larger key = better: score desc, then row asc. Scores are >= +0, so their
// bit patterns order like the floats; a valid key is never 0.
__device__ __forceinline__ unsigned long long make_key(float s, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(s)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<unsigned>(row));
}

// Sort buf[0, P) descending; P is a power of two. Ends synchronised.
__device__ void bitonic_sort_desc(unsigned long long* buf, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = buf[i], y = buf[j];
          const bool desc = (i & size) == 0;
          if (desc ? (x < y) : (x > y)) {
            buf[i] = y;
            buf[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Block-wide running top-k over a stream of keys: buf[0, k) holds the best
// k so far (sorted, 0-padded), appended candidates sit in buf[k, k + cnt).
struct BlockTopK {
  unsigned long long* buf;
  int k;
  int P;
  int* cnt;
  unsigned long long* thresh;

  __device__ void init() {
    for (int i = threadIdx.x; i < P; i += blockDim.x) buf[i] = 0ull;
    if (threadIdx.x == 0) {
      *cnt = 0;
      *thresh = 0ull;
    }
    __syncthreads();
  }

  // Called by every thread with the same n_appended; ends synchronised.
  __device__ void flush(int n_appended) {
    for (int i = k + n_appended + threadIdx.x; i < P; i += blockDim.x)
      buf[i] = 0ull;
    __syncthreads();
    bitonic_sort_desc(buf, P);
    if (threadIdx.x == 0) {
      *cnt = 0;
      *thresh = buf[k - 1];
    }
    __syncthreads();
  }

  // Make room for one step of up to kStep appends. Every thread calls it.
  __device__ void reserve() {
    const int n = *cnt;
    __syncthreads();  // all threads have read cnt before anyone appends
    if (n > P - k - kStep) flush(n);
  }

  __device__ __forceinline__ void offer(unsigned long long key,
                                        unsigned long long th) {
    if (key > th) buf[k + atomicAdd(cnt, 1)] = key;
  }

  __device__ void finish() {
    __syncthreads();
    const int n = *cnt;
    __syncthreads();
    flush(n);
  }
};

__device__ __forceinline__ int row_inter(const uint32_t* __restrict__ row,
                                         const uint32_t* qs, int W, bool vec4) {
  int c = 0;
  if (vec4) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int w = 0; w < (W >> 2); ++w) {
      const uint4 v = __ldg(r4 + w);
      c += __popc(v.x & qs[4 * w]) + __popc(v.y & qs[4 * w + 1]) +
           __popc(v.z & qs[4 * w + 2]) + __popc(v.w & qs[4 * w + 3]);
    }
  } else {
    for (int w = 0; w < W; ++w) c += __popc(__ldg(row + w) & qs[w]);
  }
  return c;
}

// Shared memory layout: keys[P] (8-byte aligned first), then the query.
template <int M>
__device__ void scan_rows(const uint32_t* __restrict__ queries,
                          const uint32_t* __restrict__ db,
                          const int32_t* __restrict__ db_cnt, int W, int k,
                          int P, int pa, int pb, int q, long long lo,
                          long long hi, int splits, int split,
                          unsigned long long* __restrict__ scratch) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_cnt;
  __shared__ unsigned long long s_thresh;
  __shared__ int s_qcnt;
  unsigned long long* buf = smem;
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + P);

  const uint32_t* qrow = queries + static_cast<size_t>(q) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) qs[w] = qrow[w];
  BlockTopK top{buf, k, P, &s_cnt, &s_thresh};
  top.init();  // synchronises, so qs is visible below
  if (threadIdx.x == 0) {
    int a = 0;
    for (int w = 0; w < W; ++w) a += __popc(qs[w]);
    s_qcnt = a;
  }
  __syncthreads();
  const int a = s_qcnt;

  // this split's share of [lo, hi)
  const long long len = hi > lo ? hi - lo : 0;
  const long long per = (len + splits - 1) / splits;
  const long long r0 = lo + per * split;
  const long long r1 = (r0 + per < hi) ? r0 + per : hi;
  const bool vec4 = (W % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(db) % 16 == 0);

  for (long long base = r0; base < r1; base += kStep) {
    top.reserve();
    const unsigned long long th = s_thresh;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long r = base + j * kThreads + threadIdx.x;
      if (r < r1) {
        const int c = row_inter(db + static_cast<size_t>(r) * W, qs, W, vec4);
        const float s = metric_score<M>(c, a, __ldg(db_cnt + r), pa, pb);
        top.offer(make_key(s, static_cast<int>(r)), th);
      }
    }
    __syncthreads();
  }
  top.finish();
  unsigned long long* out =
      scratch + (static_cast<size_t>(q) * splits + split) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = buf[i];
}

template <int M>
__global__ void __launch_bounds__(kThreads)
tanimoto_topk_pass1(const uint32_t* __restrict__ queries,
                    const uint32_t* __restrict__ db,
                    const int32_t* __restrict__ db_cnt, int n, int W, int k,
                    int P, int pa, int pb,
                    unsigned long long* __restrict__ scratch) {
  scan_rows<M>(queries, db, db_cnt, W, k, P, pa, pb, blockIdx.x, 0, n,
               gridDim.y, blockIdx.y, scratch);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
window_topk_pass1(const uint32_t* __restrict__ queries,
                  const uint32_t* __restrict__ db,
                  const int32_t* __restrict__ db_cnt,
                  const int32_t* __restrict__ lo_row,
                  const int32_t* __restrict__ hi_row, int n, int W, int k,
                  int P, int pa, int pb,
                  unsigned long long* __restrict__ scratch) {
  // each block loads its own bounds (the Pallas kernel scalar-prefetched
  // them); rows outside [lo, hi) and past n are never scored
  const int q = blockIdx.x;
  long long lo = lo_row[q], hi = hi_row[q];
  if (lo < 0) lo = 0;
  if (hi > n) hi = n;
  scan_rows<M>(queries, db, db_cnt, W, k, P, pa, pb, q, lo, hi, gridDim.y,
               blockIdx.y, scratch);
}

// One block per query: merge the splits' sorted candidate runs.
__global__ void __launch_bounds__(kThreads)
topk_merge_pass(const unsigned long long* __restrict__ scratch, int splits,
                int k, int P, int32_t* __restrict__ ids,
                float* __restrict__ vals) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_cnt;
  __shared__ unsigned long long s_thresh;
  const int q = blockIdx.x;
  BlockTopK top{smem, k, P, &s_cnt, &s_thresh};
  top.init();
  const unsigned long long* runs =
      scratch + static_cast<size_t>(q) * splits * k;
  const long long total = static_cast<long long>(splits) * k;
  for (long long base = 0; base < total; base += kStep) {
    top.reserve();
    const unsigned long long th = s_thresh;
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      if (i < total) top.offer(runs[i], th);
    }
    __syncthreads();
  }
  top.finish();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned long long key = smem[i];
    const size_t o = static_cast<size_t>(q) * k + i;
    if (key != 0ull) {
      ids[o] = static_cast<int32_t>(0xFFFFFFFFu -
                                    static_cast<uint32_t>(key & 0xFFFFFFFFull));
      vals[o] = __uint_as_float(static_cast<uint32_t>(key >> 32));
    } else {
      ids[o] = -1;
      vals[o] = __uint_as_float(0xff800000u);  // -inf
    }
  }
}

int buffer_len(int k) {
  int P = 1;
  while (P < k + kStep) P <<= 1;
  return P;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// C interface, bound with ctypes. Returns 0 or a cudaError_t code.
//   queries (q_n, w) u32, db (n, w) u32, db_cnt (n,) i32,
//   scratch (q_n, splits, k) u64, ids (q_n, k) i32, vals (q_n, k) f32.
extern "C" int tanimoto_topk_cuda(const void* queries, const void* db,
                                  const void* db_cnt, int q_n, int n, int w,
                                  int k, int metric, int pa, int pb,
                                  int splits, void* scratch, void* ids,
                                  void* vals, void* stream) {
  if (q_n <= 0 || k <= 0 || splits <= 0) return 0;
  const int P = buffer_len(k);
  const size_t smem1 = static_cast<size_t>(P) * 8 + static_cast<size_t>(w) * 4;
  const size_t smem2 = static_cast<size_t>(P) * 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(q_n, splits);
  auto* q = static_cast<const uint32_t*>(queries);
  auto* d = static_cast<const uint32_t*>(db);
  auto* c = static_cast<const int32_t*>(db_cnt);
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaSuccess;
#define LAUNCH_FULL(MID)                                                      \
  err = allow_smem(tanimoto_topk_pass1<MID>, smem1);          \
  if (err != cudaSuccess) return static_cast<int>(err);                       \
  tanimoto_topk_pass1<MID><<<grid1, kThreads, smem1, s>>>(q, d, c, n, w, k, P, \
                                                          pa, pb, sc);
  switch (metric) {
    case kTanimoto: LAUNCH_FULL(kTanimoto); break;
    case kDice: LAUNCH_FULL(kDice); break;
    case kCosine: LAUNCH_FULL(kCosine); break;
    case kTversky: LAUNCH_FULL(kTversky); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_FULL
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(topk_merge_pass, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_pass<<<q_n, kThreads, smem2, s>>>(
      sc, splits, k, P, static_cast<int32_t*>(ids), static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

//   as tanimoto_topk_cuda, plus lo_row, hi_row (q_n,) i32: query q scans
//   only rows [lo_row[q], hi_row[q]) that are also < n.
extern "C" int window_topk_cuda(const void* queries, const void* db,
                                const void* db_cnt, const void* lo_row,
                                const void* hi_row, int q_n, int n, int w,
                                int k, int metric, int pa, int pb, int splits,
                                void* scratch, void* ids, void* vals,
                                void* stream) {
  if (q_n <= 0 || k <= 0 || splits <= 0) return 0;
  const int P = buffer_len(k);
  const size_t smem1 = static_cast<size_t>(P) * 8 + static_cast<size_t>(w) * 4;
  const size_t smem2 = static_cast<size_t>(P) * 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(q_n, splits);
  auto* q = static_cast<const uint32_t*>(queries);
  auto* d = static_cast<const uint32_t*>(db);
  auto* c = static_cast<const int32_t*>(db_cnt);
  auto* lo = static_cast<const int32_t*>(lo_row);
  auto* hi = static_cast<const int32_t*>(hi_row);
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaSuccess;
#define LAUNCH_WIN(MID)                                                      \
  err = allow_smem(window_topk_pass1<MID>, smem1);           \
  if (err != cudaSuccess) return static_cast<int>(err);                      \
  window_topk_pass1<MID><<<grid1, kThreads, smem1, s>>>(q, d, c, lo, hi, n, w, \
                                                        k, P, pa, pb, sc);
  switch (metric) {
    case kTanimoto: LAUNCH_WIN(kTanimoto); break;
    case kDice: LAUNCH_WIN(kDice); break;
    case kCosine: LAUNCH_WIN(kCosine); break;
    case kTversky: LAUNCH_WIN(kTversky); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_WIN
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(topk_merge_pass, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_pass<<<q_n, kThreads, smem2, s>>>(
      sc, splits, k, P, static_cast<int32_t*>(ids), static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}
