// Kernel K1: the whole pose-only Levenberg-Marquardt schedule in one launch.
//
// Replaces the TPU kernel of hyslam_tpu/ops/pose_opt_pallas.py
// (pose_optimization_pallas, body _make_kernel with _chol6_solve,
// _so3_exp_scalars, _se3_exp_scalars and _compose), and follows that body's
// arithmetic: 4 rounds x 10 iterations, Huber weights in rounds 0-1
// (delta^2 = 5.991 mono, 7.815 stereo), points with z <= 0.05 as hard
// outliers, 6x6 normal equations from 21 + 6 weighted reductions damped by
// lambda * max(diag, 1e-6), an unrolled Cholesky solve with a 1e-12 floor,
// SE3 exp and left-compose, accept if cost' < cost and the step is finite,
// lambda x0.5 on accept and x4 on reject clipped to [1e-9, 1e6], and chi2
// outlier reclassification after each round.
//
// What bounds it on the card: latency. One problem moves about 36 KB and does
// a few MFLOP, but its 40 iterations are a chain of 81 dependent block
// reductions (two per iteration, and the final inlier count) with a serial
// 6x6 solve between them, all on one SM. The design keeps every
// observation in shared memory for the whole schedule (9 floats x N <= 1024,
// 36 KB, under the 48 KB static limit), so no iteration touches device
// memory, and reduces with warp shuffles plus one shared-memory pass. The
// later fix is batching: grid.x = B already runs one problem per block, so
// the tracker's three solves per frame can share one launch across SMs.
//
// Interface: plain C, bound with ctypes. Inputs are float32, contiguous, in
// the public layout T0 [B,4,4], X [B,N,3], uv [B,N,2], ur/is2/valid/stereo
// [B,N] (masks as 0/1 floats). Outputs: Tout [B,4,4] f32, inl [B,N] bytes
// (0/1, a torch.bool buffer), ninl [B] int32. Build without --use_fast_math:
// sinf, sqrtf and division stay IEEE, for parity with the plain version.

#include <cuda_runtime.h>
#include <cfloat>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxObs = 1024;
constexpr int kSums = 28;  // 21 H (upper triangle) + 6 g + cost
constexpr float kChi2Mono = 5.991f;    // hyslam_tpu/solver/robust.py
constexpr float kChi2Stereo = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Obs {
  float X0, X1, X2, u, v, ur, is2, valid, st;
};

struct Terms {
  float px, py, pz, iz, iz2, ru, rv, rr, c2;
};

__device__ __forceinline__ Terms residual_terms(const Cam& c, const float* R,
                                                const float* t, const Obs& o) {
  Terms r;
  r.px = R[0] * o.X0 + R[1] * o.X1 + R[2] * o.X2 + t[0];
  r.py = R[3] * o.X0 + R[4] * o.X1 + R[5] * o.X2 + t[1];
  r.pz = R[6] * o.X0 + R[7] * o.X1 + R[8] * o.X2 + t[2];
  const float zs = fabsf(r.pz) < 1e-9f ? 1e-9f : r.pz;
  r.iz = 1.0f / zs;
  r.iz2 = r.iz * r.iz;
  r.ru = c.fx * r.px * r.iz + c.cx - o.u;
  r.rv = c.fy * r.py * r.iz + c.cy - o.v;
  r.rr = o.st > 0.0f ? c.fx * r.px * r.iz + c.cx - c.bf * r.iz - o.ur : 0.0f;
  r.c2 = o.is2 * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
  r.c2 = r.pz > 0.05f ? r.c2 : 1e9f;
  return r;
}

__device__ __forceinline__ Obs load_obs(const float (*s)[kMaxObs], int n) {
  return Obs{s[0][n], s[1][n], s[2][n], s[3][n], s[4][n], s[5][n], s[6][n], s[7][n], s[8][n]};
}

__device__ __forceinline__ float huber(float c2, float th, bool use_huber) {
  if (!use_huber || c2 <= th) return 1.0f;
  return sqrtf(th / fmaxf(c2, 1e-12f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Unrolled 6x6 Cholesky solve (H symmetric, full), as _chol6_solve.
__device__ void chol6_solve(const float H[6][6], const float b[6], float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    for (int j = i + 1; j < 6; ++j) {
      float sj = H[j][i];
      for (int k = 0; k < i; ++k) sj = sj - L[j][k] * L[i][k];
      L[j][i] = sj / L[i][i];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// SE3 exp of xi = (omega, upsilon) into R (9, row-major) and t (3), as
// _so3_exp_scalars + _se3_exp_scalars (Taylor switch at theta = 0.5).
__device__ void se3_exp(const float xi[6], float R[9], float t[3]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float v0 = xi[3], v1 = xi[4], v2 = xi[5];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = t2 < 0.25f;
  const float st2 = small ? 1.0f : t2;
  const float th = sqrtf(st2);
  const float t4 = t2 * t2;
  const float A = small ? 1.0f - t2 / 6.0f + t4 / 120.0f : sinf(th) / th;
  const float sh = sinf(0.5f * th);
  const float B = small ? 0.5f - t2 / 24.0f + t4 / 720.0f : 2.0f * sh * sh / st2;
  const float C = small ? 1.0f / 6.0f - t2 / 120.0f + t4 / 5040.0f : (1.0f - A) / st2;
  R[0] = 1.0f + B * (-w2 * w2 - w1 * w1);
  R[1] = -A * w2 + B * w0 * w1;
  R[2] = A * w1 + B * w0 * w2;
  R[3] = A * w2 + B * w0 * w1;
  R[4] = 1.0f + B * (-w2 * w2 - w0 * w0);
  R[5] = -A * w0 + B * w1 * w2;
  R[6] = -A * w1 + B * w0 * w2;
  R[7] = A * w0 + B * w1 * w2;
  R[8] = 1.0f + B * (-w1 * w1 - w0 * w0);
  const float cx = w1 * v2 - w2 * v1;
  const float cy = w2 * v0 - w0 * v2;
  const float cz = w0 * v1 - w1 * v0;
  const float c2x = w1 * cz - w2 * cy;
  const float c2y = w2 * cx - w0 * cz;
  const float c2z = w0 * cy - w1 * cx;
  t[0] = v0 + B * cx + C * c2x;
  t[1] = v1 + B * cy + C * c2y;
  t[2] = v2 + B * cz + C * c2z;
}

// (Ra, ta) o (Rb, tb): R = Ra Rb, t = Ra tb + ta, as _compose.
__device__ void compose(const float* Ra, const float* ta, const float* Rb,
                        const float* tb, float* R, float* t) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Ra[3 * i + 0] * Rb[0 + j] + Ra[3 * i + 1] * Rb[3 + j] +
                     Ra[3 * i + 2] * Rb[6 + j];
    t[i] = Ra[3 * i + 0] * tb[0] + Ra[3 * i + 1] * tb[1] + Ra[3 * i + 2] * tb[2] + ta[i];
  }
}

__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                const float* __restrict__ uv, const float* __restrict__ ur,
                const float* __restrict__ is2, const float* __restrict__ valid,
                const float* __restrict__ stereo, int N, Cam cam, int n_rounds,
                int iters, float* __restrict__ Tout, unsigned char* __restrict__ inl,
                int* __restrict__ ninl) {
  __shared__ float s_obs[9][kMaxObs];     // X0 X1 X2 u v ur is2 valid st
  __shared__ unsigned char s_active[kMaxObs];
  __shared__ float s_red[kWarps][kSums];
  __shared__ float s_pose[12];            // R (9) + t (3), the current pose
  __shared__ float s_cand[12];            // the step's candidate pose

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int n = tid; n < N; n += kThreads) {
    const size_t o = (size_t)b * N + n;
    s_obs[0][n] = X[3 * o + 0];
    s_obs[1][n] = X[3 * o + 1];
    s_obs[2][n] = X[3 * o + 2];
    s_obs[3][n] = uv[2 * o + 0];
    s_obs[4][n] = uv[2 * o + 1];
    s_obs[5][n] = ur[o];
    s_obs[6][n] = is2[o];
    s_obs[7][n] = valid[o];
    s_obs[8][n] = stereo[o];
    s_active[n] = valid[o] > 0.0f;
  }
  if (tid < 12) {
    const int i = tid < 9 ? tid / 3 : tid - 9;
    const int j = tid < 9 ? tid % 3 : 3;
    s_pose[tid] = T0[(size_t)b * 16 + 4 * i + j];
  }
  __syncthreads();

  // Thread 0 owns the LM scalars; the others only read poses from shared.
  float lam = 1e-3f, cost = 0.0f;
  bool finite = true;

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool use_huber = rnd < 2;
    lam = 1e-3f;
    for (int it = 0; it < iters; ++it) {
      // pass 1: H (upper triangle), g and cost at the current pose
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const Obs o = load_obs(s_obs, n);
        const Terms r = residual_terms(cam, s_pose, s_pose + 9, o);
        const float th = o.st > 0.0f ? kChi2Stereo : kChi2Mono;
        const float w = o.is2 * huber(r.c2, th, use_huber) * (float)s_active[n];
        // d resid / d (omega, upsilon); dp/ddelta = [-hat(p) | I]
        const float au = cam.fx * r.iz, av = cam.fy * r.iz;
        const float bu = cam.fx * r.px * r.iz2, bv = cam.fy * r.py * r.iz2;
        const float br = (cam.fx * r.px - cam.bf) * r.iz2;
        const float stm = o.st > 0.0f ? 1.0f : 0.0f;
        const float Ju[6] = {-bu * r.py, au * r.pz + bu * r.px, -au * r.py, au, 0.0f, -bu};
        const float Jv[6] = {-av * r.pz - bv * r.py, bv * r.px, av * r.px, 0.0f, av, -bv};
        const float Jr[6] = {-br * r.py * stm, (au * r.pz + br * r.px) * stm,
                             -au * r.py * stm, au * stm, 0.0f, -br * stm};
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j) acc[k++] += w * (Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jr[i] * Jr[j]);
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += w * -(Ju[i] * r.ru + Jv[i] * r.rv + Jr[i] * r.rr);
        acc[27] += w * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        const float v = warp_sum(acc[k]);
        if (lane == 0) s_red[warp][k] = v;
      }
      __syncthreads();

      // serial step on thread 0: damped solve, exp, compose
      if (tid == 0) {
        float tot[kSums];
        for (int k = 0; k < kSums; ++k) {
          float s = 0.0f;
          for (int w = 0; w < kWarps; ++w) s += s_red[w][k];
          tot[k] = s;
        }
        float H[6][6], g[6], dx[6];
        int k = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = i; j < 6; ++j) {
            H[i][j] = tot[k];
            H[j][i] = tot[k];
            ++k;
          }
        for (int i = 0; i < 6; ++i) {
          g[i] = tot[21 + i];
          H[i][i] = H[i][i] + lam * fmaxf(H[i][i], 1e-6f);
        }
        cost = tot[27];
        chol6_solve(H, g, dx);
        finite = true;
        for (int i = 0; i < 6; ++i) finite = finite && fabsf(dx[i]) <= FLT_MAX;
        float Rd[9], td[3];
        se3_exp(dx, Rd, td);
        compose(Rd, td, s_pose, s_pose + 9, s_cand, s_cand + 9);
      }
      __syncthreads();

      // pass 2: cost at the candidate pose
      float c = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const Obs o = load_obs(s_obs, n);
        const Terms r = residual_terms(cam, s_cand, s_cand + 9, o);
        const float th = o.st > 0.0f ? kChi2Stereo : kChi2Mono;
        const float w = o.is2 * huber(r.c2, th, use_huber) * (float)s_active[n];
        c += w * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
      }
      c = warp_sum(c);
      if (lane == 0) s_red[warp][0] = c;
      __syncthreads();

      if (tid == 0) {
        float cost2 = 0.0f;
        for (int w = 0; w < kWarps; ++w) cost2 += s_red[w][0];
        const bool accept = (cost2 < cost) && finite;
        if (accept)
          for (int i = 0; i < 12; ++i) s_pose[i] = s_cand[i];
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
      }
      __syncthreads();
    }
    // reclassify: outliers are excluded from the next round
    for (int n = tid; n < N; n += kThreads) {
      const Obs o = load_obs(s_obs, n);
      const Terms r = residual_terms(cam, s_pose, s_pose + 9, o);
      const float th = o.st > 0.0f ? kChi2Stereo : kChi2Mono;
      s_active[n] = (o.valid > 0.0f) && (r.c2 <= th);
    }
    __syncthreads();
  }

  // final inlier mask and count
  float cnt = 0.0f;
  for (int n = tid; n < N; n += kThreads) {
    const Obs o = load_obs(s_obs, n);
    const Terms r = residual_terms(cam, s_pose, s_pose + 9, o);
    const float th = o.st > 0.0f ? kChi2Stereo : kChi2Mono;
    const bool is_in = (o.valid > 0.0f) && (r.c2 <= th);
    inl[(size_t)b * N + n] = is_in ? 1 : 0;
    cnt += is_in ? 1.0f : 0.0f;
  }
  cnt = warp_sum(cnt);
  if (lane == 0) s_red[warp][0] = cnt;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += s_red[w][0];
    ninl[b] = (int)total;
    float* T = Tout + (size_t)b * 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) T[4 * i + j] = s_pose[3 * i + j];
      T[4 * i + 3] = s_pose[9 + i];
    }
    T[12] = 0.0f;
    T[13] = 0.0f;
    T[14] = 0.0f;
    T[15] = 1.0f;
  }
}

}  // namespace

extern "C" int hyslam_pose_opt(const float* T0, const float* X, const float* uv,
                               const float* ur, const float* is2, const float* valid,
                               const float* stereo, int B, int N, float fx, float fy,
                               float cx, float cy, float bf, int n_rounds, int iters,
                               float* Tout, unsigned char* inl, int* ninl,
                               void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxObs || n_rounds < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Cam cam{fx, fy, cx, cy, bf};
  pose_opt_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      T0, X, uv, ur, is2, valid, stereo, N, cam, n_rounds, iters, Tout, inl, ninl);
  return (int)cudaGetLastError();
}

extern "C" const char* hyslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
