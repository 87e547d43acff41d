// Kernel K1: the whole pose-only Levenberg-Marquardt schedule in one launch.
//
// Replaces the TPU kernel of hyslam_tpu/ops/pose_opt_pallas.py
// (pose_optimization_pallas, body _make_kernel with _chol6_solve,
// _so3_exp_scalars, _se3_exp_scalars and _compose), and computes what that
// body computes: 4 rounds x 10 iterations, Huber weights in rounds 0-1
// (delta^2 = 5.991 mono, 7.815 stereo), points with z <= 0.05 as hard
// outliers, 6x6 normal equations from 21 + 6 + 1 weighted sums damped by
// lambda * max(diag, 1e-6), an unrolled 6x6 solve with Cholesky's 1e-12
// floor on the pivots, SE3 exp and left-compose, accept if cost' < cost and
// the step is finite, lambda x0.5 on accept and x4 on reject clipped to
// [1e-9, 1e6], and chi2 outlier reclassification after each round.
//
// What bounds it on the card. Not bytes and not operations: one problem
// moves 36 KB (11 ns at 3.35 TB/s) and does 5 to 13 MFLOP as the share of
// valid rows goes (under 0.2 us at 67 TFLOP/s float32 over 132 SMs). The
// floor is a chain. Every LM step needs the 28 sums of the step before, so
// a schedule is n_rounds * (iters + 1) dependent rounds of "pass over the
// observations, block reduction, 6x6 solve", 44 for the default schedule,
// on the one SM that holds the problem. The design shortens each link of
// that chain:
//
// - One pass an iteration. H, g and the cost are summed at the *candidate*
//   pose, in one pass and one block reduction. If the step is accepted those
//   28 sums are the next iteration's system; if it is rejected the old sums
//   are still the system at the unchanged pose and only lambda changes. One
//   extra pass opens each round, where the active set and the Huber switch
//   change. The accept/reject sequence is that of the two-pass schedule
//   (solver/pose_opt.py:pose_optimization_fused_schedule is this schedule in
//   plain PyTorch).
// - Observations stay in registers for the whole schedule (8 floats and
//   three flags each, 4 a thread at 256 threads, loaded 16 bytes at a time
//   where the pointers and N allow); shared memory holds only the reduction
//   scratch.
// - A warp reduces its 28 partial sums by recursive halving: 31 shuffles
//   leave the total of sum k in lane k (a butterfly per sum would take 140).
//   Lane k then adds column k over the warps, in warp order. No atomics:
//   every sum has a fixed order, so a problem gives the same bits every run.
// - No serial section on one thread at the end of a 224-add reduction, and
//   no broadcast. Every warp adds the columns, lane k column k, and then
//   tests the step and runs the damped solve, exp and compose itself, on all
//   its lanes alike, from the same totals in the same order, so every thread
//   arrives at the same candidate: one __syncthreads() an iteration (the
//   scratch is double-buffered), the accept test in one section with the
//   next solve. The solve is root-free (one reciprocal a column, to one
//   ulp, none in the substitutions), and the exp's series branch, which
//   every LM step takes, has no square root, sine or division.
// - Measured against it and not kept (PERF.md has the readings): warp 0
//   alone solving and handing the candidate on through shared memory (two
//   barriers an iteration; within 2% of the redundant solve, slower once
//   the solve was made short), and other block sizes (512 x 2 ties 256 x 4,
//   128 x 8 is slower, 1024 x 1 spills at its 64 registers).
// - The final pass writes the inlier mask, its count and the per-observation
//   chi2, so the caller needs no second evaluation.
//
// - Problems of more than 1024 observations (N <= 4096: a monocular camera
//   at 3000 features, whose frames have one row a feature slot). The
//   kernel is a template on the number of 1024-row chunks, C = ceil(N /
//   1024). Chunk 0 stays in registers as above, so C = 1 compiles to the
//   kernel of N <= 1024 unchanged; chunks 1..C-1 sit in dynamic shared
//   memory as structure-of-arrays (7 floats and a flag byte a row, 29 KB a
//   chunk, 87 KB at N = 4096, past the default 48 KB by
//   cudaFuncSetAttribute), slot (c - 1) * 1024 + i * 256 + thread, so that
//   a warp reads 32 consecutive words. A thread walks its rows chunk by
//   chunk in a fixed order, so every sum still has one order. Registers
//   for all 16 rows a thread (16 x 11 values) would spill.
//
// Not used: a thread block cluster over one problem (a cluster barrier costs
// more than __syncthreads(), and a pass is already 4 observations a thread),
// tensor cores and TMA (36 KB of scalar geometry gives them nothing to do).
// The batch axis stays: grid.x = B runs one problem a block, so independent
// problems (relocalization candidates) share a launch across SMs.
//
// Interface: plain C, bound with ctypes. Inputs are contiguous, in the
// public layout T0 [B,4,4], X [B,N,3], uv [B,N,2], ur/is2 [B,N] float32,
// valid/stereo [B,N] bytes (torch.bool storage); rows that are not valid
// hold finite values. Outputs: Tout [B,4,4] f32,
// inl [B,N] bytes (a torch.bool buffer), ninl [B] int32, chi2 [B,N] f32.
// Build without --use_fast_math: sinf, sqrtf and division stay IEEE, for
// parity with the plain version (but for the solve's six pivot reciprocals,
// rcp_1ulp below).

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kObs = 4;                    // observations a thread a chunk
constexpr int kChunkRows = kThreads * kObs;  // rows of one chunk: 1024
constexpr int kMaxChunks = 4;
constexpr int kMaxObs = kMaxChunks * kChunkRows;  // 4096
// a row in shared memory: X0 X1 X2 u v ur is2 as floats, one flag byte
constexpr int kSmemRowBytes = 7 * 4 + 1;
constexpr unsigned char kValid = 1, kStereo = 2, kActive = 4;
constexpr int kSums = 28;                  // 21 H (upper triangle) + 6 g + cost
constexpr int kCost = 27;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;        // hyslam_tpu/solver/robust.py
constexpr float kChi2Stereo = 7.815f;
// which entries of the Jacobian rows (u, v, right-u) are not identically
// zero, bit i for column i: their products are left out of H and g
constexpr unsigned kNzU = 0x2f, kNzV = 0x37, kNzR = 0x2f;

static_assert(kChunkRows == 1024, "chunk 0 is the register-resident problem of N <= 1024");

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Obs {
  float X0, X1, X2, u, v, ur, is2, th;   // th: the chi2 threshold of its kind
  bool valid, st, active;
};

struct Terms {
  float px, py, pz, iz, iz2, ru, rv, rr, c2;
};

// `live` false puts the point at depth 1: an observation that takes no part
// in a sum (weight 0) then has finite terms wherever the pose puts it.
__device__ __forceinline__ Terms residual_terms(const Cam& c, const float (&R)[9],
                                                const float (&t)[3], const Obs& o,
                                                bool live = true) {
  Terms r;
  r.px = R[0] * o.X0 + R[1] * o.X1 + R[2] * o.X2 + t[0];
  r.py = R[3] * o.X0 + R[4] * o.X1 + R[5] * o.X2 + t[1];
  r.pz = R[6] * o.X0 + R[7] * o.X1 + R[8] * o.X2 + t[2];
  const float zs = !live ? 1.0f : fabsf(r.pz) < 1e-9f ? 1e-9f : r.pz;
  r.iz = 1.0f / zs;
  r.iz2 = r.iz * r.iz;
  r.ru = c.fx * r.px * r.iz + c.cx - o.u;
  r.rv = c.fy * r.py * r.iz + c.cy - o.v;
  r.rr = o.st ? c.fx * r.px * r.iz + c.cx - c.bf * r.iz - o.ur : 0.0f;
  r.c2 = o.is2 * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
  r.c2 = r.pz > 0.05f ? r.c2 : 1e9f;
  return r;
}

__device__ __forceinline__ float huber(float c2, float th, bool use_huber) {
  const float h = sqrtf(th / fmaxf(c2, 1e-12f));
  return use_huber && c2 > th ? h : 1.0f;
}

// One pass over kObs rows: their part of the 28 sums at pose (R, t), added
// to acc[0..27] (the caller zeroes acc first; acc[28..31] stay zero for
// the reduction). Straight-line code:
// an inactive observation is weighted 0, not branched around, so that the
// compiler can interleave a thread's observations. So, as in the plain
// version, a row that is not valid must still hold finite numbers: 0 * NaN
// would reach every sum.
__device__ __forceinline__ void accumulate(const Cam& cam, const float (&R)[9],
                                           const float (&t)[3], const Obs (&obs)[kObs],
                                           bool use_huber, float (&acc)[32]) {
#pragma unroll
  for (int n = 0; n < kObs; ++n) {
    const Obs& o = obs[n];
    const Terms r = residual_terms(cam, R, t, o, o.active);
    const float w = o.active ? o.is2 * huber(r.c2, o.th, use_huber) : 0.0f;
    // d resid / d (omega, upsilon); dp/ddelta = [-hat(p) | I]
    const float au = cam.fx * r.iz, av = cam.fy * r.iz;
    const float bu = cam.fx * r.px * r.iz2, bv = cam.fy * r.py * r.iz2;
    const float br = (cam.fx * r.px - cam.bf) * r.iz2;
    const float Ju[6] = {-bu * r.py, au * r.pz + bu * r.px, -au * r.py, au, 0.0f, -bu};
    const float Jv[6] = {-av * r.pz - bv * r.py, bv * r.px, av * r.px, 0.0f, av, -bv};
    const float Jr[6] = {o.st ? -br * r.py : 0.0f, o.st ? au * r.pz + br * r.px : 0.0f,
                         o.st ? -au * r.py : 0.0f, o.st ? au : 0.0f, 0.0f,
                         o.st ? -br : 0.0f};
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        float s = 0.0f;
        if ((kNzU >> i & 1u) && (kNzU >> j & 1u)) s += Ju[i] * Ju[j];
        if ((kNzV >> i & 1u) && (kNzV >> j & 1u)) s += Jv[i] * Jv[j];
        if ((kNzR >> i & 1u) && (kNzR >> j & 1u)) s += Jr[i] * Jr[j];
        acc[k] += w * s;
        ++k;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = 0.0f;
      if (kNzU >> i & 1u) s += Ju[i] * r.ru;
      if (kNzV >> i & 1u) s += Jv[i] * r.rv;
      if (kNzR >> i & 1u) s += Jr[i] * r.rr;
      acc[21 + i] += w * -s;
    }
    acc[kCost] += w * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
  }
}

// One step of the recursive halving below: a lane hands kHalf of the
// 2 * kHalf values it still carries to the lane kHalf away and adds what it
// gets to those it keeps. (A template, so that the trip count is a constant
// wherever the loop is unrolled: a v[i + half] left with a run-time index
// would put the whole array into local memory.)
template <int kHalf>
__device__ __forceinline__ void halving_step(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kAllLanes, send, kHalf);
  }
}

// Sum v[k] over the warp for all 32 k: 16 + 8 + 4 + 2 + 1 shuffles, and
// lane k returns total k.
__device__ __forceinline__ float warp_totals(float (&v)[32], int lane) {
  halving_step<16>(v, lane);
  halving_step<8>(v, lane);
  halving_step<4>(v, lane);
  halving_step<2>(v, lane);
  halving_step<1>(v, lane);
  return v[0];
}

// Sum acc[k] over the block: lane k of every warp returns total k, the
// warps' totals added in warp order. One barrier; the scratch is
// double-buffered, so the next call may write while a slow warp still reads
// this one's.
__device__ __forceinline__ float block_totals(float (&acc)[32], float (*s_red)[kWarps][32],
                                              int& buf, int lane, int warp) {
  s_red[buf][warp][lane] = warp_totals(acc, lane);
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_red[buf][w][lane];
  buf ^= 1;
  return total;
}

// Loads rows n0 .. n0 + kObs - 1 of problem `row` (the offset b * N). With
// vec4 (N % 4 == 0, pointers aligned) the kObs rows are all inside N or all
// outside, and load as 16-byte words. Rows past N hold a valid point at
// depth 1 and take part in nothing.
__device__ __forceinline__ void load_obs(const float* __restrict__ X,
                                         const float* __restrict__ uv,
                                         const float* __restrict__ ur,
                                         const float* __restrict__ is2,
                                         const unsigned char* __restrict__ valid,
                                         const unsigned char* __restrict__ stereo,
                                         size_t row, int n0, int N, bool vec4,
                                         Obs (&obs)[kObs]) {
  if (vec4 && n0 < N) {
    const float4* Xv = reinterpret_cast<const float4*>(X + 3 * (row + n0));
    const float4* uvv = reinterpret_cast<const float4*>(uv + 2 * (row + n0));
    const float4 x0 = Xv[0], x1 = Xv[1], x2 = Xv[2];
    const float4 u0 = uvv[0], u1 = uvv[1];
    const float4 r4 = *reinterpret_cast<const float4*>(ur + row + n0);
    const float4 s4 = *reinterpret_cast<const float4*>(is2 + row + n0);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(valid + row + n0);
    const uchar4 t4 = *reinterpret_cast<const uchar4*>(stereo + row + n0);
    const float xs[12] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w,
                          x2.x, x2.y, x2.z, x2.w};
    const float us[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
    const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
    const unsigned char vs[4] = {v4.x, v4.y, v4.z, v4.w};
    const unsigned char ts[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int i = 0; i < kObs; ++i) {
      obs[i].X0 = xs[3 * i + 0];
      obs[i].X1 = xs[3 * i + 1];
      obs[i].X2 = xs[3 * i + 2];
      obs[i].u = us[2 * i + 0];
      obs[i].v = us[2 * i + 1];
      obs[i].ur = rs[i];
      obs[i].is2 = ss[i];
      obs[i].valid = vs[i] != 0;
      obs[i].st = ts[i] != 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kObs; ++i) {
      const int n = n0 + i;
      const bool in = n < N;
      const size_t o = row + (in ? n : 0);
      obs[i].X0 = in ? X[3 * o + 0] : 0.0f;
      obs[i].X1 = in ? X[3 * o + 1] : 0.0f;
      obs[i].X2 = in ? X[3 * o + 2] : 1.0f;
      obs[i].u = in ? uv[2 * o + 0] : 0.0f;
      obs[i].v = in ? uv[2 * o + 1] : 0.0f;
      obs[i].ur = in ? ur[o] : 0.0f;
      obs[i].is2 = in ? is2[o] : 0.0f;
      obs[i].valid = in && valid[o] != 0;
      obs[i].st = in && stereo[o] != 0;
    }
  }
#pragma unroll
  for (int i = 0; i < kObs; ++i) {
    obs[i].th = obs[i].st ? kChi2Stereo : kChi2Mono;
    obs[i].active = obs[i].valid;
  }
}

// The rows of chunks 1..C-1 in dynamic shared memory, structure of arrays:
// row i of this thread in chunk c (c >= 1) sits at slot
// (c - 1) * kChunkRows + i * kThreads + threadIdx.x.
struct SmemRows {
  float *X0, *X1, *X2, *u, *v, *ur, *is2;
  unsigned char* flags;
};

__device__ __forceinline__ SmemRows smem_rows(unsigned char* base, int n_rows) {
  float* f = reinterpret_cast<float*>(base);
  return SmemRows{f,          f + n_rows,     f + 2 * n_rows, f + 3 * n_rows,
                  f + 4 * n_rows, f + 5 * n_rows, f + 6 * n_rows,
                  base + 7 * sizeof(float) * n_rows};
}

__device__ __forceinline__ void store_rows(const SmemRows& s, int c, int tid,
                                           const Obs (&obs)[kObs]) {
#pragma unroll
  for (int i = 0; i < kObs; ++i) {
    const int k = (c - 1) * kChunkRows + i * kThreads + tid;
    s.X0[k] = obs[i].X0;
    s.X1[k] = obs[i].X1;
    s.X2[k] = obs[i].X2;
    s.u[k] = obs[i].u;
    s.v[k] = obs[i].v;
    s.ur[k] = obs[i].ur;
    s.is2[k] = obs[i].is2;
    s.flags[k] = (obs[i].valid ? kValid : 0) | (obs[i].st ? kStereo : 0) |
                 (obs[i].active ? kActive : 0);
  }
}

__device__ __forceinline__ void read_rows(const SmemRows& s, int c, int tid,
                                          Obs (&obs)[kObs]) {
#pragma unroll
  for (int i = 0; i < kObs; ++i) {
    const int k = (c - 1) * kChunkRows + i * kThreads + tid;
    const unsigned char f = s.flags[k];
    obs[i].X0 = s.X0[k];
    obs[i].X1 = s.X1[k];
    obs[i].X2 = s.X2[k];
    obs[i].u = s.u[k];
    obs[i].v = s.v[k];
    obs[i].ur = s.ur[k];
    obs[i].is2 = s.is2[k];
    obs[i].valid = (f & kValid) != 0;
    obs[i].st = (f & kStereo) != 0;
    obs[i].active = (f & kActive) != 0;
    obs[i].th = obs[i].st ? kChi2Stereo : kChi2Mono;
  }
}

// The final pass over kObs rows: chi2 and the inlier flags at (R, t),
// written to rows n0 .. n0 + kObs - 1 (16-byte words with vec4, as
// load_obs reads them). Returns the rows' inlier count.
__device__ __forceinline__ int write_final(const Cam& cam, const float (&R)[9],
                                           const float (&t)[3], const Obs (&obs)[kObs],
                                           size_t row, int n0, int N, bool vec4,
                                           unsigned char* __restrict__ inl,
                                           float* __restrict__ chi2) {
  float c2s[kObs];
  unsigned char ins[kObs];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kObs; ++i) {
    const Terms r = residual_terms(cam, R, t, obs[i]);
    const bool is_in = obs[i].valid && (r.c2 <= obs[i].th);
    c2s[i] = r.c2;
    ins[i] = is_in ? 1 : 0;
    cnt += is_in ? 1 : 0;
  }
  if (vec4) {
    if (n0 < N) {
      *reinterpret_cast<float4*>(chi2 + row + n0) =
          make_float4(c2s[0], c2s[1], c2s[2], c2s[3]);
      *reinterpret_cast<uchar4*>(inl + row + n0) =
          make_uchar4(ins[0], ins[1], ins[2], ins[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kObs; ++i) {
      if (n0 + i < N) {
        chi2[row + n0 + i] = c2s[i];
        inl[row + n0 + i] = ins[i];
      }
    }
  }
  return cnt;
}

__device__ __forceinline__ float next_lambda(float lam, bool accept) {
  return fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
}

// 1 / x to within one unit in the last place (rcp.approx), for the pivots
// below: they sit in a dependent chain, where the IEEE reciprocal's range
// check and Newton step cost half as much again as the rest of a column.
// The one place where this file is not IEEE.
__device__ __forceinline__ float rcp_1ulp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Solves H x = b for a symmetric 6x6 H as _chol6_solve does in exact
// arithmetic, in the root-free form H = M D M^T: D_i is the square of that
// Cholesky's diagonal, with the same 1e-12 floor, and M its unit lower
// factor. The dependent chain is one reciprocal a column where Cholesky has
// a square root and a division, and the two substitutions divide by nothing.
__device__ __forceinline__ void ldl6_solve(const float (&H)[6][6], const float (&b)[6],
                                           float (&x)[6]) {
  float M[6][6], c[6][6], invD[6];   // c[j][i] = M[j][i] * D_i
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - c[i][k] * M[i][k];
    invD[i] = rcp_1ulp(fmaxf(s, 1e-12f));
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float sj = H[j][i];
#pragma unroll
      for (int k = 0; k < i; ++k) sj = sj - c[j][k] * M[i][k];
      c[j][i] = sj;
      M[j][i] = sj * invD[i];
    }
  }
  float z[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - M[i][k] * z[k];
    z[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = z[i] * invD[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - M[k][i] * x[k];
    x[i] = s;
  }
}

// SE3 exp of xi = (omega, upsilon) into R (9, row-major) and t (3), as
// _so3_exp_scalars + _se3_exp_scalars (Taylor switch at theta = 0.5). The
// reference selects between the two forms; here the switch is a branch,
// the same in every thread, so an LM step (always far below 0.5 rad) pays
// for no square root, sine or division. The series divides by constants as
// XLA does, by multiplying with the float32 reciprocal.
__device__ __forceinline__ void se3_exp(const float (&xi)[6], float (&R)[9], float (&t)[3]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float v0 = xi[3], v1 = xi[4], v2 = xi[5];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  float A, B, C;
  if (t2 < 0.25f) {
    const float t4 = t2 * t2;
    A = 1.0f - t2 * (1.0f / 6.0f) + t4 * (1.0f / 120.0f);
    B = 0.5f - t2 * (1.0f / 24.0f) + t4 * (1.0f / 720.0f);
    C = 1.0f / 6.0f - t2 * (1.0f / 120.0f) + t4 * (1.0f / 5040.0f);
  } else {
    const float th = sqrtf(t2);
    const float sh = sinf(0.5f * th);
    A = sinf(th) / th;
    B = 2.0f * sh * sh / t2;
    C = (1.0f - A) / t2;
  }
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
__device__ __forceinline__ void compose(const float (&Ra)[9], const float (&ta)[3],
                                        const float (&Rb)[9], const float (&tb)[3],
                                        float (&R)[9], float (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Ra[3 * i + 0] * Rb[0 + j] + Ra[3 * i + 1] * Rb[3 + j] +
                     Ra[3 * i + 2] * Rb[6 + j];
    t[i] = Ra[3 * i + 0] * tb[0] + Ra[3 * i + 1] * tb[1] + Ra[3 * i + 2] * tb[2] + ta[i];
  }
}

// One LM step from the 28 totals `sys` at pose (R, t): the damped solve, exp
// and compose into the candidate (cR, ct). Returns whether the step is finite.
__device__ __forceinline__ bool lm_step(const float (&sys)[kSums], float lam,
                                        const float (&R)[9], const float (&t)[3],
                                        float (&cR)[9], float (&ct)[3]) {
  float H[6][6], g[6], dx[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      H[i][j] = sys[k];
      H[j][i] = sys[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    g[i] = sys[21 + i];
    H[i][i] = H[i][i] + lam * fmaxf(H[i][i], 1e-6f);
  }
  ldl6_solve(H, g, dx);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && fabsf(dx[i]) <= FLT_MAX;
  float Rd[9], td[3];
  se3_exp(dx, Rd, td);
  compose(Rd, td, R, t, cR, ct);
  return finite;
}

// kChunks = ceil(N / 1024): chunk 0 in registers, the others in dynamic
// shared memory ((kChunks - 1) * kChunkRows * kSmemRowBytes bytes).
template <int kChunks>
__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                const float* __restrict__ uv, const float* __restrict__ ur,
                const float* __restrict__ is2, const unsigned char* __restrict__ valid,
                const unsigned char* __restrict__ stereo, int N, int vec, Cam cam,
                int n_rounds, int iters, float* __restrict__ Tout,
                unsigned char* __restrict__ inl, int* __restrict__ ninl,
                float* __restrict__ chi2) {
  __shared__ float s_red[2][kWarps][32];
  __shared__ int s_count[kWarps];
  extern __shared__ __align__(16) unsigned char s_rows[];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = tid * kObs;               // this thread's first row of a chunk
  const size_t row = (size_t)b * N;
  const bool vec4 = vec != 0;
  const SmemRows smem = smem_rows(s_rows, (kChunks - 1) * kChunkRows);

  Obs obs[kObs];                           // chunk 0
  load_obs(X, uv, ur, is2, valid, stereo, row, n0, N, vec4, obs);
#pragma unroll 1
  for (int c = 1; c < kChunks; ++c) {
    Obs more[kObs];
    load_obs(X, uv, ur, is2, valid, stereo, row, c * kChunkRows + n0, N, vec4, more);
    store_rows(smem, c, tid, more);
  }
  // every thread reads back only its own slots: no barrier needed here

  // Every thread carries the pose and the LM state (system, lambda).
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = T0[(size_t)b * 16 + 4 * i + j];
    t[i] = T0[(size_t)b * 16 + 4 * i + 3];
  }
  float sys[kSums] = {};  // the 28 totals at (R, t)
  float acc[32];
  int buf = 0;

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool use_huber = rnd < 2;
    float lam = 1e-3f;
    // it = -1 opens the round: the pass at the current pose, taken as it is
    for (int it = -1; it < iters; ++it) {
      const bool opening = it < 0;
      float cR[9], ct[3];
      bool finite = true;
      if (opening) {
#pragma unroll
        for (int i = 0; i < 9; ++i) cR[i] = R[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) ct[i] = t[i];
      } else {
        finite = lm_step(sys, lam, R, t, cR, ct);
      }
      // the one pass: H, g and cost at the candidate, chunk by chunk
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
      accumulate(cam, cR, ct, obs, use_huber, acc);
#pragma unroll 1
      for (int c = 1; c < kChunks; ++c) {
        Obs more[kObs];
        read_rows(smem, c, tid, more);
        accumulate(cam, cR, ct, more, use_huber, acc);
      }
      const float mine = block_totals(acc, s_red, buf, lane, warp);
      const float cost2 = __shfl_sync(kAllLanes, mine, kCost);
      const bool accept = opening || ((cost2 < sys[kCost]) && finite);
      if (accept) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) sys[k] = __shfl_sync(kAllLanes, mine, k);
#pragma unroll
        for (int i = 0; i < 9; ++i) R[i] = cR[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) t[i] = ct[i];
      }
      if (!opening) lam = next_lambda(lam, accept);
    }
    // reclassify: outliers are excluded from the next round
#pragma unroll
    for (int i = 0; i < kObs; ++i) {
      const Terms r = residual_terms(cam, R, t, obs[i]);
      obs[i].active = obs[i].valid && (r.c2 <= obs[i].th);
    }
#pragma unroll 1
    for (int c = 1; c < kChunks; ++c) {
      Obs more[kObs];
      read_rows(smem, c, tid, more);
#pragma unroll
      for (int i = 0; i < kObs; ++i) {
        const Terms r = residual_terms(cam, R, t, more[i]);
        const bool act = more[i].valid && (r.c2 <= more[i].th);
        const int k = (c - 1) * kChunkRows + i * kThreads + tid;
        smem.flags[k] = (smem.flags[k] & ~kActive) | (act ? kActive : 0);
      }
    }
  }

  // final pass: chi2, inlier mask and count at the result
  int cnt = write_final(cam, R, t, obs, row, n0, N, vec4, inl, chi2);
#pragma unroll 1
  for (int c = 1; c < kChunks; ++c) {
    Obs more[kObs];
    read_rows(smem, c, tid, more);
    cnt += write_final(cam, R, t, more, row, c * kChunkRows + n0, N, vec4, inl, chi2);
  }
  cnt = __reduce_add_sync(kAllLanes, cnt);
  if (lane == 0) s_count[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_count[w];
    ninl[b] = total;
    float* T = Tout + (size_t)b * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T[4 * i + j] = R[3 * i + j];
      T[4 * i + 3] = t[i];
    }
    T[12] = 0.0f;
    T[13] = 0.0f;
    T[14] = 0.0f;
    T[15] = 1.0f;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kChunks>
int launch(dim3 grid, cudaStream_t stream, const float* T0, const float* X,
           const float* uv, const float* ur, const float* is2,
           const unsigned char* valid, const unsigned char* stereo, int N, int vec,
           Cam cam, int n_rounds, int iters, float* Tout, unsigned char* inl,
           int* ninl, float* chi2) {
  const int smem = (kChunks - 1) * kChunkRows * kSmemRowBytes;
  if (kChunks > 1) {
    // past the default 48 KB a block must opt in (per device: set every call)
    const cudaError_t e = cudaFuncSetAttribute(
        pose_opt_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  pose_opt_kernel<kChunks><<<grid, kThreads, smem, stream>>>(
      T0, X, uv, ur, is2, valid, stereo, N, vec, cam, n_rounds, iters, Tout, inl, ninl,
      chi2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hyslam_pose_opt(const float* T0, const float* X, const float* uv,
                               const float* ur, const float* is2,
                               const unsigned char* valid, const unsigned char* stereo,
                               int B, int N, float fx, float fy, float cx, float cy,
                               float bf, int n_rounds, int iters, float* Tout,
                               unsigned char* inl, int* ninl, float* chi2,
                               void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxObs || n_rounds < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Cam cam{fx, fy, cx, cy, bf};
  const int vec = N % 4 == 0 && aligned(X, 16) && aligned(uv, 16) && aligned(ur, 16) &&
                  aligned(is2, 16) && aligned(chi2, 16) && aligned(valid, 4) &&
                  aligned(stereo, 4) && aligned(inl, 4);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B);
  switch ((N + kChunkRows - 1) / kChunkRows) {
    case 1:
      return launch<1>(grid, s, T0, X, uv, ur, is2, valid, stereo, N, vec, cam, n_rounds,
                       iters, Tout, inl, ninl, chi2);
    case 2:
      return launch<2>(grid, s, T0, X, uv, ur, is2, valid, stereo, N, vec, cam, n_rounds,
                       iters, Tout, inl, ninl, chi2);
    case 3:
      return launch<3>(grid, s, T0, X, uv, ur, is2, valid, stereo, N, vec, cam, n_rounds,
                       iters, Tout, inl, ninl, chi2);
    default:
      return launch<4>(grid, s, T0, X, uv, ur, is2, valid, stereo, N, vec, cam, n_rounds,
                       iters, Tout, inl, ninl, chi2);
  }
}

extern "C" const char* hyslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
