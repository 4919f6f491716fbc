// Kernel K3: the whole motion-only Levenberg-Marquardt pose optimization in
// one launch (rounds x iters LM steps, Huber kernel in rounds 1-2, chi2
// inlier re-classification between rounds).
//
// Replaces the Pallas TPU kernel `pose_opt_lm` / `_pose_lm_kernel` (with
// `_chol6_scalar`, `_exp_se3_scalar`) in coslam_tpu/ops/pallas_kernels.py.
// Plain version: `pose_opt_lm_plain` in coslam_tpu_torch/ops/cuda_kernels.py.
//
// What bounds it on the H100: latency, not arithmetic or bytes.  The work is
// ~40 sequential LM steps, each a pass over N = 1024 observations (~100
// flops each) followed by a 6x6 solve; the inputs are 24 KB.  Driven from
// the host, every step is a chain of small launches and a device-to-host
// sync for the accept/reject decision.  Here one thread block runs the
// entire solve: each step, the threads evaluate residuals and Jacobians for
// a strided share of the points and block-reduce the 21 H entries, 6 b
// entries and the cost (warp shuffles, then shared memory); thread 0 does
// the unrolled Cholesky and the SE3 exponential in f32 and publishes the
// trial pose through shared memory; a second pass reduces the trial cost;
// thread 0 accepts or rejects.  No intermediate touches device memory
// except the per-point inlier flags, which each thread owns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int NRED = 28;   // 21 upper-triangular H + 6 b + cost

template <int K>
__device__ void block_sum(float (&v)[K], float* s_warp, float* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_warp[warp * K + k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float x = 0.f;
    for (int wi = 0; wi < NW; ++wi) x += s_warp[wi * K + threadIdx.x];
    s_out[threadIdx.x] = x;
  }
  __syncthreads();
}

struct Obs {
  float pcx, pcy, pcz, iz, ru, rv, chi2;
  bool behind;
};

__device__ __forceinline__ Obs residual(const float* P, float X, float Y,
                                        float Z, float U, float V, float isg,
                                        float fx, float fy, float cx,
                                        float cy) {
  Obs o;
  o.pcx = P[0] * X + P[1] * Y + P[2] * Z + P[3];
  o.pcy = P[4] * X + P[5] * Y + P[6] * Z + P[7];
  o.pcz = P[8] * X + P[9] * Y + P[10] * Z + P[11];
  const float zs = fabsf(o.pcz) < 1e-6f ? 1e-6f : o.pcz;
  o.iz = 1.0f / zs;
  o.ru = fx * o.pcx * o.iz + cx - U;
  o.rv = fy * o.pcy * o.iz + cy - V;
  o.behind = o.pcz <= 0.05f;
  o.chi2 = (o.ru * o.ru + o.rv * o.rv) * isg;
  return o;
}

__device__ __forceinline__ float robust_cost(float chi2, bool robust,
                                             float delta) {
  const float e = sqrtf(fmaxf(chi2, 1e-12f));
  return (robust && e > delta) ? delta * (2.0f * e - delta) : chi2;
}

// Unrolled Cholesky solve of a 6x6 SPD system (H full, symmetric).
__device__ void chol_solve6(const float (&H)[6][6], const float (&b)[6],
                            float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// SE3 exponential of [rho, phi]; returns R (3x3) and t (3).
__device__ void exp_se3(const float (&dx)[6], float (&R)[3][3],
                        float (&t)[3]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(t2 + 1e-12f);
  const bool small = t2 < 1e-8f;
  const float A = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / (t2 + 1e-12f);
  const float C = small ? 1.0f / 6.0f - t2 / 120.0f : (1.0f - A) / (t2 + 1e-12f);
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  const float W2[3][3] = {{-(wy * wy + wz * wz), wx * wy, wx * wz},
                          {wx * wy, -(wx * wx + wz * wz), wy * wz},
                          {wx * wz, wy * wz, -(wx * wx + wy * wy)}};
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = (i == j) ? 1.0f : 0.0f;
      R[i][j] = I + A * W[i][j] + B * W2[i][j];
      V[i][j] = I + B * W[i][j] + C * W2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
}

__global__ void __launch_bounds__(NT) pose_opt_lm_kernel(
    const float* __restrict__ X, const float* __restrict__ uv,
    const float* __restrict__ isg, const float* __restrict__ T_in, int n,
    float fx, float fy, float cx, float cy, int rounds, int iters,
    float chi2_th, float* __restrict__ T_out, uint8_t* __restrict__ inl) {
  __shared__ float s_P[12], s_Pn[12];
  __shared__ float s_warp[NW * NRED];
  __shared__ float s_red[NRED];
  __shared__ float s_lam;

  const int tid = threadIdx.x;
  const float delta = sqrtf(chi2_th);
  if (tid < 12) s_P[tid] = T_in[tid];
  for (int i = tid; i < n; i += NT) inl[i] = isg[i] > 0.0f;
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool robust = rnd < 2;
    if (tid == 0) s_lam = 1e-3f;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      // pass 1: normal equations and cost at the current pose
      float acc[NRED];
#pragma unroll
      for (int k = 0; k < NRED; ++k) acc[k] = 0.f;
      for (int i = tid; i < n; i += NT) {
        const float w0 = isg[i];
        const Obs o = residual(s_P, X[3 * i], X[3 * i + 1], X[3 * i + 2],
                               uv[2 * i], uv[2 * i + 1], w0, fx, fy, cx, cy);
        const bool ok = inl[i] && !o.behind;
        if (!ok) continue;
        const float e = sqrtf(fmaxf(o.chi2, 1e-12f));
        const float w_rob = (robust && e > delta) ? delta / e : 1.0f;
        const float w = w0 * w_rob;
        acc[27] += robust_cost(o.chi2, robust, delta);
        const float iz2 = o.iz * o.iz;
        const float Ju[6] = {fx * o.iz, 0.f, -fx * o.pcx * iz2,
                             -fx * o.pcx * o.pcy * iz2,
                             fx * (1.0f + o.pcx * o.pcx * iz2),
                             -fx * o.pcy * o.iz};
        const float Jv[6] = {0.f, fy * o.iz, -fy * o.pcy * iz2,
                             -fy * (1.0f + o.pcy * o.pcy * iz2),
                             fy * o.pcx * o.pcy * iz2, fy * o.pcx * o.iz};
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int c = a; c < 6; ++c)
            acc[k++] += w * (Ju[a] * Ju[c] + Jv[a] * Jv[c]);
          acc[21 + a] += w * (Ju[a] * o.ru + Jv[a] * o.rv);
        }
      }
      block_sum<NRED>(acc, s_warp, s_red);

      if (tid == 0) {
        const float lam = s_lam;
        float H[6][6], b[6], x[6];
        int k = 0;
        for (int a = 0; a < 6; ++a) {
          for (int c = a; c < 6; ++c) {
            H[a][c] = s_red[k];
            H[c][a] = s_red[k];
            ++k;
          }
          b[a] = s_red[21 + a];
        }
        for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] * (1.0f + lam) + 1e-9f;
        chol_solve6(H, b, x);
        for (int a = 0; a < 6; ++a) x[a] = -x[a];
        float Rd[3][3], td[3];
        exp_se3(x, Rd, td);
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 4; ++c) {
            float s = Rd[r][0] * s_P[c] + Rd[r][1] * s_P[4 + c] +
                      Rd[r][2] * s_P[8 + c];
            if (c == 3) s += td[r];
            s_Pn[r * 4 + c] = s;
          }
      }
      __syncthreads();

      // pass 2: cost at the trial pose
      float cn[1] = {0.f};
      for (int i = tid; i < n; i += NT) {
        const Obs o = residual(s_Pn, X[3 * i], X[3 * i + 1], X[3 * i + 2],
                               uv[2 * i], uv[2 * i + 1], isg[i], fx, fy, cx,
                               cy);
        if (inl[i] && !o.behind) cn[0] += robust_cost(o.chi2, robust, delta);
      }
      const float cost = s_red[27];
      __syncthreads();   // every thread has read s_red[27]
      block_sum<1>(cn, s_warp, s_red);
      if (tid == 0) {
        const bool improved = s_red[0] < cost;
        if (improved)
          for (int k = 0; k < 12; ++k) s_P[k] = s_Pn[k];
        const float lam = improved ? s_lam * 0.5f : s_lam * 4.0f;
        s_lam = fminf(fmaxf(lam, 1e-6f), 1e3f);
      }
      __syncthreads();
    }
    // chi2 re-classification between rounds (Optimizer.cc:370-444)
    for (int i = tid; i < n; i += NT) {
      const float w0 = isg[i];
      const Obs o = residual(s_P, X[3 * i], X[3 * i + 1], X[3 * i + 2],
                             uv[2 * i], uv[2 * i + 1], w0, fx, fy, cx, cy);
      inl[i] = (w0 > 0.0f) && !o.behind && (o.chi2 < chi2_th);
    }
    __syncthreads();
  }
  if (tid < 16) T_out[tid] = tid < 12 ? s_P[tid] : (tid == 15 ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int coslam_pose_opt_lm(const float* X, const float* uv,
                                  const float* isg, const float* T_in, int n,
                                  float fx, float fy, float cx, float cy,
                                  int rounds, int iters, float chi2_th,
                                  float* T_out, uint8_t* inl,
                                  void* stream) {
  pose_opt_lm_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      X, uv, isg, T_in, n, fx, fy, cx, cy, rounds, iters, chi2_th, T_out,
      inl);
  return static_cast<int>(cudaGetLastError());
}
