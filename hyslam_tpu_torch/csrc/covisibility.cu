// Kernel K2: the map's covisibility counts, over its live associations.
//
// Replaces no TPU kernel. The JAX package computes these counts with XLA ops
// (hyslam_tpu/core/mapstate.py:482, refresh_covisibility): a [K, L] incidence
// matrix of every keyframe against every landmark slot, multiplied by its
// transpose on the MXU. The port's plain version
// (core/mapstate.py:refresh_covisibility_plain) did the same in float32 on
// the card: at the KITTI cell's arena (K 1024, L 786,432) a 3.2 GB matrix and
// a 1.65 TFLOP product, ~38 ms a call, three calls a keyframe, and the mapper
// blocked behind them. Its work grows with the arena's capacity; the answer
// depends only on the live associations.
//
// What it computes, exactly as the plain version: covis[k1, k2] = the number
// of landmarks l that both keyframes name on the keyframe side, where a name
// lm_id[k, f] >= 0 counts if kp_valid[k, f] holds, keyframe k is valid and
// not bad, and landmark l (the name clamped to L - 1, as the plain version
// clamps it) is valid and not bad. A keyframe that names l twice counts once;
// the diagonal is 0; int32.
//
// What bounds it on the card: the bytes of the associations. It reads lm_id
// and kp_valid ([K, F], 5 bytes an entry: 10.5 MB at K 1024, F 2048), the
// masks of the keyframes and of the landmarks named, and writes the [K, K]
// counts (4 MB at K 1024): ~5 us at 3.35 TB/s. The design keeps every pass
// proportional to the associations or to L, never to K x L:
//
// 1. count: one thread an association adds 1 to its landmark's count
//    (integer atomics).
// 2. alloc: each landmark takes a segment of that many entries in one
//    buffer of K x F entries. A warp adds its 32 counts by shuffles and takes
//    its segments with one atomic, so segments lie in whatever order warps
//    arrive: nothing downstream depends on where a segment lies.
// 3. fill: each association writes its keyframe into its landmark's segment.
// 4. pairs: a landmark of at most kLightMax names, one thread: it sorts its
//    segment in place (insertion sort), skips repeats, and adds 1 to
//    covis[a, b] for every pair a < b of distinct keyframes (integer
//    atomics). A landmark with more names goes on a list for step 5.
// 5. heavy: one block a listed landmark: a bitmap of K bits in shared memory
//    removes the repeats, warp 0 writes the distinct keyframes back in
//    ascending order, and the block's warps share the pairs, a row each.
//    Exact for any number of names (up to K x F). The thread's sort would
//    be exact too, but quadratic in the names: the benchmark's maps hold a
//    few hundred landmarks past 32 names, some named thousands of times by
//    a few dozen keyframes, and those carry most of the live names.
// 6. mirror: covis[b, a] = covis[a, b] for a < b.
//
// Every count is a sum of integer 1s, so the order in which atomics land
// changes no bit: two launches give the same counts, and those of the plain
// float32 product (whose sums are exact below 2^24). Scratch: (3 L + 2 + K F)
// int32 from the caller, no [K, L] tensor and no float product.
//
// Interface: plain C, bound with ctypes. Inputs contiguous: lm_id [K, F]
// int32, kp_valid [K, F], kf_valid [K], kf_bad [K], lm_valid [L], lm_bad [L]
// bytes (torch.bool storage); scratch of hyslam_covisibility_scratch_ints
// int32; output covis [K, K] int32, overwritten whole.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLightMax = 32;       // names a landmark's own thread sorts and pairs
constexpr int kHeavyBlocks = 132;   // blocks that share the listed landmarks
constexpr int kMaxBitmapBytes = 32 * 1024;   // K <= 262,144 (48 KB of shared memory in all)
constexpr unsigned kAllLanes = 0xffffffffu;

struct Assoc {
  const int* lm_id;
  const unsigned char* kp_valid;
  const unsigned char* kf_valid;
  const unsigned char* kf_bad;
  const unsigned char* lm_valid;
  const unsigned char* lm_bad;
  int K, F, L;
};

// The landmark association i = k * F + f names where it counts, else -1.
__device__ __forceinline__ int live_landmark(const Assoc& a, int64_t i, int k) {
  int l = a.lm_id[i];
  if (l < 0 || !a.kp_valid[i] || !a.kf_valid[k] || a.kf_bad[k]) return -1;
  l = min(l, a.L - 1);
  return (a.lm_valid[l] && !a.lm_bad[l]) ? l : -1;
}

__global__ void count_kernel(Assoc a, int* count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.K * a.F) return;
  const int l = live_landmark(a, i, (int)(i / a.F));
  if (l >= 0) atomicAdd(count + l, 1);
}

// Segment starts from the counts; leaves every count at 0 for fill's cursor.
__global__ void alloc_kernel(int* count, int* base, int* total, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int c = l < L ? count[l] : 0;
  int x = c;                                   // inclusive sum over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, x, d);
    if (lane >= d) x += y;
  }
  int start = 0;
  if (lane == 31 && x > 0) start = atomicAdd(total, x);
  start = __shfl_sync(kAllLanes, start, 31);
  if (l < L) {
    base[l] = start + x - c;
    count[l] = 0;
  }
}

__global__ void fill_kernel(Assoc a, int* count, const int* base, int* names) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.K * a.F) return;
  const int k = (int)(i / a.F);
  const int l = live_landmark(a, i, k);
  if (l >= 0) names[base[l] + atomicAdd(count + l, 1)] = k;
}

__global__ void pairs_kernel(const int* count, const int* base, int* names, int L, int K,
                             int* covis, int* heavy, int* n_heavy) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int n = count[l];
  if (n < 2) return;
  if (n > kLightMax) {
    heavy[atomicAdd(n_heavy, 1)] = l;
    return;
  }
  int* s = names + base[l];
  for (int i = 1; i < n; ++i) {                // insertion sort, ascending
    const int v = s[i];
    int j = i;
    for (; j > 0 && s[j - 1] > v; --j) s[j] = s[j - 1];
    s[j] = v;
  }
  for (int i = 0; i < n; ++i) {
    if (i > 0 && s[i] == s[i - 1]) continue;   // a repeat of the keyframe before
    int* row = covis + (int64_t)s[i] * K;
    for (int j = i + 1; j < n; ++j)
      if (s[j] != s[j - 1]) atomicAdd(row + s[j], 1);
  }
}

__global__ void heavy_kernel(const int* count, const int* base, int* names,
                             const int* heavy, const int* n_heavy, int K, int* covis) {
  extern __shared__ unsigned bits[];
  __shared__ int n_distinct;
  const int W = (K + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int nh = *n_heavy;
  for (int h = blockIdx.x; h < nh; h += gridDim.x) {
    const int l = heavy[h];
    const int n = count[l];
    int* s = names + base[l];
    for (int w = threadIdx.x; w < W; w += blockDim.x) bits[w] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      atomicOr(bits + (s[i] >> 5), 1u << (s[i] & 31));
    __syncthreads();
    if (warp == 0) {                           // the set bits, ascending, into s
      int run = 0;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        unsigned b = w < W ? bits[w] : 0u;
        const int c = __popc(b);
        int x = c;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kAllLanes, x, d);
          if (lane >= d) x += y;
        }
        int at = run + x - c;
        for (; b; b &= b - 1) s[at++] = w * 32 + __ffs(b) - 1;
        run += __shfl_sync(kAllLanes, x, 31);
      }
      if (lane == 0) n_distinct = run;
    }
    __syncthreads();
    const int m = n_distinct;
    for (int i = warp; i < m; i += n_warps) {
      int* row = covis + (int64_t)s[i] * K;
      for (int j = i + 1 + lane; j < m; j += 32) atomicAdd(row + s[j], 1);
    }
    __syncthreads();                           // bits and n_distinct are reused
  }
}

__global__ void mirror_kernel(int* covis, int K) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)K * K) return;
  const int r = (int)(i / K), c = (int)(i % K);
  if (r > c) covis[i] = covis[(int64_t)c * K + r];
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// int32 entries of scratch: count [L] and the two counters, base [L],
// the list of heavy landmarks [L], the names [K * F]
extern "C" long long hyslam_covisibility_scratch_ints(int K, int F, int L) {
  return 3LL * L + 2 + (long long)K * F;
}

extern "C" int hyslam_covisibility(const int* lm_id, const unsigned char* kp_valid,
                                   const unsigned char* kf_valid, const unsigned char* kf_bad,
                                   const unsigned char* lm_valid, const unsigned char* lm_bad,
                                   int K, int F, int L, int* scratch, int* covis, void* stream) {
  const size_t bitmap_bytes = (size_t)((K + 31) / 32) * sizeof(unsigned);
  if (K <= 0 || F <= 0 || L <= 0 || bitmap_bytes > kMaxBitmapBytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* count = scratch;
  int* total = scratch + L;
  int* n_heavy = total + 1;
  int* base = n_heavy + 1;
  int* heavy = base + L;
  int* names = heavy + L;
  const Assoc a{lm_id, kp_valid, kf_valid, kf_bad, lm_valid, lm_bad, K, F, L};
  const int64_t n_assoc = (int64_t)K * F;
  cudaError_t e = cudaMemsetAsync(covis, 0, (size_t)K * K * sizeof(int), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, (size_t)(L + 2) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<blocks(n_assoc), kThreads, 0, s>>>(a, count);
  alloc_kernel<<<blocks(L), kThreads, 0, s>>>(count, base, total, L);
  fill_kernel<<<blocks(n_assoc), kThreads, 0, s>>>(a, count, base, names);
  pairs_kernel<<<blocks(L), kThreads, 0, s>>>(count, base, names, L, K, covis, heavy, n_heavy);
  heavy_kernel<<<kHeavyBlocks, kThreads, bitmap_bytes, s>>>(count, base, names, heavy, n_heavy,
                                                            K, covis);
  mirror_kernel<<<blocks((int64_t)K * K), kThreads, 0, s>>>(covis, K);
  return (int)cudaGetLastError();
}
