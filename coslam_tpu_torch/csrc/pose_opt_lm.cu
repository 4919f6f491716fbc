// Kernel K3: the whole motion-only Levenberg-Marquardt pose optimization in
// one launch (rounds x iters LM steps on one SE3 pose, Huber kernel in
// rounds 0-1, chi2 inlier re-classification after each round).
//
// Replaces the Pallas TPU kernel `pose_opt_lm` / `_pose_lm_kernel` (with
// `_chol6_scalar`, `_exp_se3_scalar`) in coslam_tpu/ops/pallas_kernels.py.
// Plain version: `pose_opt_lm_plain` in coslam_tpu_torch/ops/cuda_kernels.py.
//
// What bounds it on the H100: the length of a serial chain, not bytes (the
// inputs are 24 KB) and not the card's arithmetic rate (~10 MFLOP).  The 40
// LM steps depend on each other, each is a pass over the observations, a
// block-wide reduction of 28 sums and a 6x6 solve, and the pass itself
// (~110 instructions a point) has to fit on the one SM that holds the
// block.  The design keeps everything that is not arithmetic off that
// chain:
//
//   * Observations live in registers.  Up to NT * PPT points, each thread
//     loads its points' X, uv and information once, keeps the inlier flags
//     in registers and writes them once at the end.  Only observations that
//     carry information are kept, packed to the front: of the 1024 slots
//     tracking hands over a few hundred hold a match, and the pass then
//     costs what they cost, not what 1024 would.  Larger N takes the same
//     kernel with a strided loop over device memory (REG = false).
//   * One pass per LM step.  The pass at the trial pose accumulates the
//     normal equations and the cost together.  An accepted step makes them
//     the next step's H, b and cost; a rejected step leaves the pose, and so
//     the H, b and cost already held, unchanged.  A pass at the current pose
//     is needed only at the start of a round, where the robust flag and the
//     inlier set change; it also does the re-classification that closes the
//     round before.  rounds * (iters + 1) passes instead of 2 * rounds *
//     iters, with the same sequence of values.
//   * The 28 sums are reduced across a warp by a transposing butterfly: each
//     of its five rounds halves the values a lane carries, 16 + 8 + 4 + 2 +
//     1 = 31 shuffles, and lane k ends with the warp's sum of value k.  One
//     partial per warp and value goes to shared memory, one barrier, and
//     lane k of every warp adds the warps' partials of value k in the same
//     order.  The partials are double-buffered, so a step has this one
//     barrier.
//   * No thread is special.  Every lane fetches H, b and the cost from its
//     warp's lanes by shuffles and runs the Cholesky solve, the SE3
//     exponential, the pose product and the accept test itself; all reach
//     bit-identical results, so nothing is published and nothing waits.
//
// Arithmetic: f32 throughout, with the fast forms where the serial chain
// runs through them: one `rsqrtf` per Cholesky pivot (the pivot is needed
// only as a reciprocal, and the substitutions multiply by it) instead of an
// IEEE sqrtf and a division, `rsqrtf` for the Huber weight, `__fdividef` for
// the inverse depth, and power series for the exponential's coefficients.
// Each is good to 2 ulp; the pose stays within 1e-5 of the plain version's,
// which divides and takes roots in IEEE form (the bar is 1e-3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 256 threads x 4 points: every warp repeats the solve, so more warps cost
// scheduler slots on the chain, and fewer leave the pass too little in flight.
constexpr int NT = 256;          // threads of the one block
constexpr int PPT = 4;           // points a thread keeps in registers
constexpr int NW = NT / 32;
constexpr int NRED = 28;         // 21 upper-triangular H + 6 b + cost
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy;
};

// Adds one observation's terms at pose P to acc (zeros in acc[28..31]).
// With `reclassify` the inlier flag is first set anew from chi2 at P.
__device__ __forceinline__ void add_point(
    const float (&P)[12], float X, float Y, float Z, float U, float V,
    float w0, bool& inl, bool reclassify, bool robust, float delta,
    float chi2_th, const Cam& cam, float (&acc)[32]) {
  const float pcx = P[0] * X + P[1] * Y + P[2] * Z + P[3];
  const float pcy = P[4] * X + P[5] * Y + P[6] * Z + P[7];
  const float pcz = P[8] * X + P[9] * Y + P[10] * Z + P[11];
  const float zs = fabsf(pcz) < 1e-6f ? 1e-6f : pcz;
  const float iz = __fdividef(1.0f, zs);
  const float ru = cam.fx * pcx * iz + cam.cx - U;
  const float rv = cam.fy * pcy * iz + cam.cy - V;
  const bool behind = pcz <= 0.05f;
  const float chi2 = (ru * ru + rv * rv) * w0;
  if (reclassify) inl = (w0 > 0.0f) && !behind && (chi2 < chi2_th);
  if (!inl || behind) return;
  const float c2 = fmaxf(chi2, 1e-12f);
  const float ie = rsqrtf(c2);          // 1 / e, e = sqrt(chi2)
  const float e = c2 * ie;
  const bool over = robust && e > delta;
  const float w = over ? w0 * (delta * ie) : w0;
  acc[27] += over ? delta * (2.0f * e - delta) : chi2;
  const float iz2 = iz * iz;
  // Jacobian rows w.r.t. a left se3 perturbation [rho, phi]; Ju[1] and
  // Jv[0] are zero
  const float Ju[6] = {cam.fx * iz, 0.f, -cam.fx * pcx * iz2,
                       -cam.fx * pcx * pcy * iz2,
                       cam.fx * (1.0f + pcx * pcx * iz2), -cam.fx * pcy * iz};
  const float Jv[6] = {0.f, cam.fy * iz, -cam.fy * pcy * iz2,
                       -cam.fy * (1.0f + pcy * pcy * iz2),
                       cam.fy * pcx * pcy * iz2, cam.fy * pcx * iz};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wu = w * Ju[a], wv = w * Jv[a];
#pragma unroll
    for (int c = a; c < 6; ++c) {
      acc[k] = fmaf(wu, Ju[c], fmaf(wv, Jv[c], acc[k]));
      ++k;
    }
    acc[21 + a] = fmaf(wu, ru, fmaf(wv, rv, acc[21 + a]));
  }
}

// One round of the transposing butterfly: lanes whose bit HALF is clear keep
// v[0..HALF), the others v[HALF..2 HALF), and each adds its partner's copy.
template <int HALF>
__device__ __forceinline__ void butterfly_round(float (&v)[32], int lane) {
  const bool up = (lane & HALF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[i + HALF] : v[i];
    const float send = up ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(FULL, send, HALF);
  }
}

// Transposing butterfly: on return lane k holds the warp's sum of v[k].
// Every index is a compile-time constant, so v stays in registers.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  butterfly_round<16>(v, lane);
  butterfly_round<8>(v, lane);
  butterfly_round<4>(v, lane);
  butterfly_round<2>(v, lane);
  butterfly_round<1>(v, lane);
  return v[0];
}

// Solves (H with damped diagonal) x = b by an unrolled Cholesky and returns
// the trial pose Pn = exp(-x) * P.  hb: 21 upper-triangular H, then 6 b.
__device__ __forceinline__ void trial_pose(const float (&hb)[27], float lam,
                                           const float (&P)[12],
                                           float (&Pn)[12]) {
  float H[6][6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) {
      H[a][c] = hb[k];
      H[c][a] = hb[k];
      ++k;
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] * (1.0f + lam) + 1e-9f;

  // L's diagonal is needed only through its reciprocal
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    inv[j] = rsqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t -= L[i][q] * L[j][q];
      L[i][j] = t * inv[j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = hb[21 + i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * x[q];
    x[i] = s * inv[i];
  }

  // SE3 exponential of dx = -x = [rho, phi]
  const float r0 = -x[0], r1 = -x[1], r2 = -x[2];
  const float wx = -x[3], wy = -x[4], wz = -x[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  // A = sin(th) / th, B = (1 - cos(th)) / th^2, C = (1 - A) / th^2.  An LM
  // step turns by far less than half a radian, where the series to th^8
  // are exact to f32 rounding and free of the closed forms' cancellation;
  // beyond it the closed forms take over.
  float A, B, C;
  if (t2 < 0.25f) {
    A = fmaf(t2, fmaf(t2, fmaf(t2, fmaf(t2, 1.0f / 362880.0f,
        -1.0f / 5040.0f), 1.0f / 120.0f), -1.0f / 6.0f), 1.0f);
    B = fmaf(t2, fmaf(t2, fmaf(t2, fmaf(t2, 1.0f / 3628800.0f,
        -1.0f / 40320.0f), 1.0f / 720.0f), -1.0f / 24.0f), 0.5f);
    C = fmaf(t2, fmaf(t2, fmaf(t2, fmaf(t2, 1.0f / 39916800.0f,
        -1.0f / 362880.0f), 1.0f / 5040.0f), -1.0f / 120.0f), 1.0f / 6.0f);
  } else {
    const float th = sqrtf(t2);
    A = sinf(th) / th;
    B = (1.0f - cosf(th)) / t2;
    C = (1.0f - A) / t2;
  }
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  const float W2[3][3] = {{-(wy * wy + wz * wz), wx * wy, wx * wz},
                          {wx * wy, -(wx * wx + wz * wz), wy * wz},
                          {wx * wz, wy * wz, -(wx * wx + wy * wy)}};
  float R[3][3], Vm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = (i == j) ? 1.0f : 0.0f;
      R[i][j] = I + A * W[i][j] + B * W2[i][j];
      Vm[i][j] = I + B * W[i][j] + C * W2[i][j];
    }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float td = Vm[r][0] * r0 + Vm[r][1] * r1 + Vm[r][2] * r2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = R[r][0] * P[c] + R[r][1] * P[4 + c] + R[r][2] * P[8 + c];
      if (c == 3) s += td;
      Pn[r * 4 + c] = s;
    }
  }
}

template <bool REG>
__global__ void __launch_bounds__(NT) pose_opt_lm_kernel(
    const float* __restrict__ X, const float* __restrict__ uv,
    const float* __restrict__ isg, const float* __restrict__ T_in, int n,
    Cam cam, int rounds, int iters, float chi2_th,
    float* __restrict__ T_out, uint8_t* __restrict__ inl) {
  __shared__ float s_part[2][NW][32];
  __shared__ float s_obs[6][NT * PPT];   // staging for the packing (REG)
  __shared__ int s_at[NT * PPT];
  __shared__ int s_cnt[PPT * NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float delta = sqrtf(chi2_th);

  // This thread's observations and inlier flags.  The register path keeps
  // only observations that carry information (isg > 0), packed to the front
  // in their order: tracking hands over 1024 slots of which a few hundred
  // hold a match, and a warp whose slots are all empty skips them.
  float oX[PPT], oY[PPT], oZ[PPT], oU[PPT], oV[PPT], oW[PPT];
  bool oIn[PPT];
  int oAt[PPT];                  // where the observation came from, or -1
  int n_live = n;
  if (REG) {
    unsigned have[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * NT;
      const bool live = i < n && isg[i] > 0.0f;
      if (i < n && !live) inl[i] = 0;
      have[j] = __ballot_sync(FULL, live);
      if (lane == 0) s_cnt[j * NW + warp] = __popc(have[j]);
    }
    __syncthreads();
    // packed position: observations before this one, slot by slot and warp
    // by warp
    int before[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) before[j] = 0;
    n_live = 0;
#pragma unroll
    for (int k = 0; k < PPT * NW; ++k) {
      const int c = s_cnt[k];
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        if (k < j * NW + warp) before[j] += c;
      n_live += c;
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * NT;
      if (have[j] >> lane & 1u) {
        const int p = before[j] + __popc(have[j] & ((1u << lane) - 1u));
        s_obs[0][p] = X[3 * i];
        s_obs[1][p] = X[3 * i + 1];
        s_obs[2][p] = X[3 * i + 2];
        s_obs[3][p] = uv[2 * i];
        s_obs[4][p] = uv[2 * i + 1];
        s_obs[5][p] = isg[i];
        s_at[p] = i;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * NT;
      const bool live = p < n_live;
      oX[j] = live ? s_obs[0][p] : 0.f;
      oY[j] = live ? s_obs[1][p] : 0.f;
      oZ[j] = live ? s_obs[2][p] : 1.f;
      oU[j] = live ? s_obs[3][p] : 0.f;
      oV[j] = live ? s_obs[4][p] : 0.f;
      oW[j] = live ? s_obs[5][p] : 0.f;
      oAt[j] = live ? s_at[p] : -1;
      oIn[j] = live;
    }
  } else {
    for (int i = tid; i < n; i += NT) inl[i] = isg[i] > 0.0f;
  }

  float P[12], Pt[12], hb[27];
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = T_in[k];
  float cost = 0.f, lam = 1e-3f;
  int step = 0;

  // One more pass than rounds * (iters + 1): the last one only closes the
  // last round (re-classification at the final pose, no sums).
  for (int rnd = 0; rnd <= rounds; ++rnd) {
    const bool robust = rnd < 2;
    const bool last = rnd == rounds;
    lam = 1e-3f;
    const int passes = last ? 1 : iters + 1;
    for (int it = 0; it < passes; ++it) {
      const bool fresh = it == 0;       // pass at the current pose
      if (fresh) {
#pragma unroll
        for (int k = 0; k < 12; ++k) Pt[k] = P[k];
      }
      const bool reclassify = fresh && rnd > 0;

      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      if (REG) {
#pragma unroll
        for (int j = 0; j < PPT; ++j)
          if (j * NT + warp * 32 < n_live)       // the same for a whole warp
            add_point(Pt, oX[j], oY[j], oZ[j], oU[j], oV[j], oW[j], oIn[j],
                      reclassify, robust, delta, chi2_th, cam, acc);
      } else {
        for (int i = tid; i < n; i += NT) {
          bool in = inl[i] != 0;
          add_point(Pt, X[3 * i], X[3 * i + 1], X[3 * i + 2], uv[2 * i],
                    uv[2 * i + 1], isg[i], in, reclassify, robust, delta,
                    chi2_th, cam, acc);
          if (reclassify) inl[i] = in;
        }
      }
      if (last) break;

      // block-wide sums: lane k of every warp ends with the total of value k
      const int buf = step & 1;
      ++step;
      s_part[buf][warp][lane] = warp_transpose_sum(acc);
      __syncthreads();
      float pw[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) pw[w] = s_part[buf][w][lane];
      static_assert(NW == 8, "the tree below adds eight partials");
      const float tot = ((pw[0] + pw[1]) + (pw[2] + pw[3])) +
                        ((pw[4] + pw[5]) + (pw[6] + pw[7]));

      const float cost_t = __shfl_sync(FULL, tot, 27);
      const bool improved = fresh || cost_t < cost;
      if (improved) {
#pragma unroll
        for (int k = 0; k < 27; ++k) hb[k] = __shfl_sync(FULL, tot, k);
        cost = cost_t;
#pragma unroll
        for (int k = 0; k < 12; ++k) P[k] = Pt[k];
      }
      if (!fresh) lam = fminf(fmaxf(improved ? lam * 0.5f : lam * 4.0f,
                                    1e-6f), 1e3f);
      if (it + 1 < passes) trial_pose(hb, lam, P, Pt);
    }
  }

  if (REG) {
#pragma unroll
    for (int j = 0; j < PPT; ++j)
      if (oAt[j] >= 0) inl[oAt[j]] = oIn[j];
  }
  if (tid < 16) T_out[tid] = tid < 12 ? P[tid] : (tid == 15 ? 1.0f : 0.0f);
}

}  // namespace

// Largest N the register path takes; above it the kernel loops over device
// memory.
extern "C" int coslam_pose_opt_lm_register_limit() { return NT * PPT; }

extern "C" int coslam_pose_opt_lm(const float* X, const float* uv,
                                  const float* isg, const float* T_in, int n,
                                  float fx, float fy, float cx, float cy,
                                  int rounds, int iters, float chi2_th,
                                  float* T_out, uint8_t* inl,
                                  void* stream) {
  const Cam cam{fx, fy, cx, cy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= NT * PPT)
    pose_opt_lm_kernel<true><<<1, NT, 0, s>>>(X, uv, isg, T_in, n, cam,
                                              rounds, iters, chi2_th, T_out,
                                              inl);
  else
    pose_opt_lm_kernel<false><<<1, NT, 0, s>>>(X, uv, isg, T_in, n, cam,
                                               rounds, iters, chi2_th, T_out,
                                               inl);
  return static_cast<int>(cudaGetLastError());
}
