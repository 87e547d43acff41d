// Kernel K3: the landmarks' statistics (viewing direction, scale-invariance
// range, representative descriptor), over their live observations.
//
// Replaces no TPU kernel. The JAX package computes these statistics with XLA
// ops (hyslam_tpu/core/mapstate.py:534, update_landmark_stats) over every
// landmark slot and every pair of observation slots. The port's plain
// version (core/mapstate.py:update_landmark_stats_plain) did the same on the
// card: at the KITTI cell's arena (L 786,432, O 8) the [L, O, O, 8] Hamming
// distances go through a 64-bit SWAR bit count, 402.7M elements and 3.2 GB
// an intermediate, ~35 ms a call, three calls a keyframe, and the mapper
// blocked behind them. Most rows have no valid observation, and those keep
// their values.
//
// What it computes, as the plain version: for a row l with a valid
// observation, over its valid slots o (keyframe obs_kf and feature obs_feat,
// each clamped into its arena as the plain version clamps them):
// - normal = the mean of the unit vectors from each camera centre
//   (-R^T t of Tcw) to pos[l], each divided by max(|v|, 1e-9);
// - max_dist = mean(|v|) * mean(1.2^level), min_dist = max_dist * 1.2^-8
//   (the float32 constant the caller passes);
// - desc = the descriptor of the valid slot with the least total Hamming
//   distance to the valid slots, the lowest slot on ties, as torch.argmin.
// A row with no valid observation keeps its four values.
//
// Equality with the plain version: the descriptor is bit-equal (integer
// distances, the same tie rule). The floats agree to rounding: the kernel
// adds over the slots in a butterfly order, where the plain version adds in
// slot order, and nvcc fuses multiply-adds in the centre and the norm. The
// chip phase holds them to |a - b| <= 1e-6 + 1e-5 |b| (PERF.md has the
// readings). Two launches give the same bits: no atomics, every sum in one
// fixed order.
//
// What bounds it on the card: bytes. Every row's obs_valid is read (L x O
// bytes), and every output row is written once, a live row's computed and
// any other row's copied from its old values (52 bytes a row in, 52 out:
// 6.3 + 82 MB at L 786,432, ~26 us at 3.35 TB/s). A live row also gathers
// each valid slot's pose (48 bytes), level and descriptor (36 bytes). The
// design:
// - G lanes a row (G = O rounded up to 4, 8, 16 or 32), lane o slot o, so a
//   warp holds 32 / G rows and every gather is one lane's. A row's lanes
//   read its valid bits by one ballot and leave together where none is set.
// - The sums over the slots are xor butterflies over the G lanes: every lane
//   ends with the same bits.
// - Lane o takes the O descriptors by shuffles and counts its distances with
//   __popc in registers; no [O, O] table exists. The argmin is a butterfly
//   min over (total << 5 | o), which keeps the lowest slot among equal
//   totals.
//
// Interface: plain C, bound with ctypes. Inputs contiguous: obs_kf, obs_feat
// [L, O] int32, obs_valid [L, O] bytes (torch.bool storage), Tcw [K, 4, 4]
// f32, pos [L, 3] f32, level [K, F] int32, kf_desc [K, F, 8] int32, and the
// old normal [L, 3] f32, desc [L, 8] int32, min_dist, max_dist [L] f32.
// Outputs: new tensors of those four shapes, written whole.
// Build without --use_fast_math: division, sqrtf and powf stay IEEE.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWords = 13;      // normal 3, desc 8, min_dist, max_dist

struct Obs {
  const int* obs_kf;
  const int* obs_feat;
  const unsigned char* obs_valid;
  const float* Tcw;
  const float* pos;
  const int* level;
  const int* kf_desc;
  int K, F, L, O;
  float inv_scale_range;
};

struct Row {
  const float* normal;
  const int* desc;
  const float* min_dist;
  const float* max_dist;
};

struct Out {
  float* normal;
  int* desc;
  float* min_dist;
  float* max_dist;
};

template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) x += __shfl_xor_sync(mask, x, m, G);
  return x;
}

template <int G>
__global__ void __launch_bounds__(kThreads) stats_kernel(Obs in, Row old, Out out) {
  const int lane = threadIdx.x & 31;
  const int o = lane % G;
  const int group = lane / G;
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (group * G);
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (row >= in.L) return;                    // a row's lanes leave together
  const int64_t so = row * in.O + o;
  const bool v = o < in.O && in.obs_valid[so];
  const unsigned vbits = (__ballot_sync(mask, v) & mask) >> (group * G);

  if (vbits == 0u) {                          // no valid observation: keep the row
    for (int w = o; w < kRowWords; w += G) {
      if (w < 3) out.normal[row * 3 + w] = old.normal[row * 3 + w];
      else if (w < 11) out.desc[row * 8 + w - 3] = old.desc[row * 8 + w - 3];
      else if (w == 11) out.min_dist[row] = old.min_dist[row];
      else out.max_dist[row] = old.max_dist[row];
    }
    return;
  }

  float ux = 0.f, uy = 0.f, uz = 0.f, dist = 0.f, scale = 0.f;
  int d[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (v) {
    const int k = min(max(in.obs_kf[so], 0), in.K - 1);
    const int f = min(max(in.obs_feat[so], 0), in.F - 1);
    const float* T = in.Tcw + (int64_t)k * 16;
    const float t0 = T[3], t1 = T[7], t2 = T[11];
    const float cx = -(T[0] * t0 + T[4] * t1 + T[8] * t2);
    const float cy = -(T[1] * t0 + T[5] * t1 + T[9] * t2);
    const float cz = -(T[2] * t0 + T[6] * t1 + T[10] * t2);
    const float vx = in.pos[row * 3] - cx;
    const float vy = in.pos[row * 3 + 1] - cy;
    const float vz = in.pos[row * 3 + 2] - cz;
    dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float n = fmaxf(dist, 1e-9f);
    ux = vx / n;
    uy = vy / n;
    uz = vz / n;
    const int64_t kf = (int64_t)k * in.F + f;
    scale = powf(1.2f, (float)in.level[kf]);
    const int* src = in.kf_desc + kf * 8;
#pragma unroll
    for (int w = 0; w < 8; ++w) d[w] = src[w];
  }
  ux = group_sum<G>(ux, mask);
  uy = group_sum<G>(uy, mask);
  uz = group_sum<G>(uz, mask);
  dist = group_sum<G>(dist, mask);
  scale = group_sum<G>(scale, mask);

  // the medoid: lane o's total distance to the valid slots
  int tot = 0;
  for (int q = 0; q < in.O; ++q) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += __popc(d[w] ^ __shfl_sync(mask, d[w], q, G));
    if ((vbits >> q) & 1u) tot += s;
  }
  int key = v ? (tot << 5) | o : INT_MAX;
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) key = min(key, __shfl_xor_sync(mask, key, m, G));
  const int best = key & 31;

  if (o == best) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out.desc[row * 8 + w] = d[w];
  }
  if (o == 0) {
    const float wsum = (float)__popc(vbits);
    out.normal[row * 3] = ux / wsum;
    out.normal[row * 3 + 1] = uy / wsum;
    out.normal[row * 3 + 2] = uz / wsum;
    const float max_d = (dist / wsum) * (scale / wsum);
    out.max_dist[row] = max_d;
    out.min_dist[row] = max_d * in.inv_scale_range;
  }
}

template <int G>
int launch(const Obs& in, const Row& old, const Out& out, cudaStream_t s) {
  const int64_t threads = (int64_t)in.L * G;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  stats_kernel<G><<<grid, kThreads, 0, s>>>(in, old, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hyslam_landmark_stats(const int* obs_kf, const int* obs_feat,
                                     const unsigned char* obs_valid, const float* Tcw,
                                     const float* pos, const int* level, const int* kf_desc,
                                     const float* normal0, const int* desc0,
                                     const float* min_dist0, const float* max_dist0, int K,
                                     int F, int L, int O, float inv_scale_range, float* normal,
                                     int* desc, float* min_dist, float* max_dist, void* stream) {
  if (K <= 0 || F <= 0 || L <= 0 || O <= 0 || O > 32) return (int)cudaErrorInvalidValue;
  const Obs in{obs_kf, obs_feat, obs_valid, Tcw, pos, level, kf_desc, K, F, L, O,
               inv_scale_range};
  const Row old{normal0, desc0, min_dist0, max_dist0};
  const Out out{normal, desc, min_dist, max_dist};
  const cudaStream_t s = (cudaStream_t)stream;
  if (O <= 4) return launch<4>(in, old, out, s);
  if (O <= 8) return launch<8>(in, old, out, s);
  if (O <= 16) return launch<16>(in, old, out, s);
  return launch<32>(in, old, out, s);
}
