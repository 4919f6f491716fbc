// Kernel K4: the Levenberg-Marquardt polish of a Sim3 S21 over matched
// landmark pairs in one launch (5 LM steps, the mutual chi2 prune, 10 more
// steps, the final gate; Huber at chi2_th on both projection directions).
//
// Replaces no TPU kernel: coslam_tpu/ops/sim3.py's `refine_sim3` is plain
// JAX that XLA fuses.  In eager PyTorch the same loop is ~1000 small
// launches a polish (the Jacobian, two einsums, a solve, the trial residual,
// the masked accept, the damping update, 15 times), 73-85 ms of host
// dispatch at the end of every loop-closing RANSAC, for work the card does
// in microseconds; this kernel is that polish as one launch.  Plain
// version: `refine_sim3_plain` in coslam_tpu_torch/ops/sim3.py, whose
// arithmetic it follows step for step.
//
// What bounds it on the H100: the length of a serial chain, not bytes (the
// inputs are 41 KB at 1024 slots) and not the card's arithmetic rate (~1
// MFLOP for 215 pairs).  The 15 LM steps depend on each other; each is a
// pass over the pairs, a block-wide reduction of 37 sums and a 7x7 solve.
// The design is K3's (csrc/pose_opt_lm.cu), adapted:
//
//   * The pairs live in registers.  Up to NT * PPT slots (the 1024 that the
//     loop closer hands over at 1000 features), each thread loads its pairs
//     once.  Only pairs marked valid are kept, packed to the front in their
//     order; a warp whose packed slots are all empty skips the pass's
//     arithmetic.  A RANSAC that failed hands over a few pairs, and the pass
//     then costs what they cost.  Larger N (2048 slots at 2000 features)
//     takes the same kernel with a strided loop over device memory
//     (REG = false), the prune's mask kept in the inlier output.
//   * One pass per LM step.  The plain version linearises at the current
//     Sim3, solves, and evaluates the trial's cost with the current Huber
//     weights.  Here the pass at the trial Sim3 accumulates, together, that
//     cost and the normal equations and cost at the trial with its own
//     weights: an accepted step makes them the next step's, a rejected step
//     keeps those held (the plain version recomputes the same numbers at the
//     same Sim3).  Each pair keeps its current weight in a register (the
//     strided path recomputes it from the current Sim3).  A pass at the
//     current Sim3 is needed only where a round starts, since the prune
//     changes the pairs' weights; the prune's gate is evaluated in that pass.
//     1 + 5 + 1 + 10 passes with a reduction, and one more for the final
//     gate: 18 instead of 2 * 15 + 2.
//   * The 37 sums (28 upper-triangular H, 7 g, the trial's cost under the
//     current weights and under its own) are reduced across a warp by K3's
//     transposing butterfly, 32 values in five rounds (31 shuffles) and the
//     other 8 in three rounds and two plain ones (9 shuffles); one partial
//     per warp and value to shared memory, double-buffered, one barrier a
//     step.
//   * No thread is special.  Every lane fetches the sums by shuffles and
//     runs the damping, the 7x7 Cholesky solve, the SO3 exponential, the
//     trial Sim3 and the accept test itself; all reach bit-identical
//     results, so nothing is published and nothing waits.
//
// Arithmetic: f32 throughout, as the plain version.  Reductions run in
// another order, and the fast forms sit where the serial chain runs through
// them: `rsqrtf` per Cholesky pivot and for the Huber weight, `__fdividef`
// for the inverse depths, a multiplication by 1/s for the inverse map, and
// power series for the exponential's coefficients below half a radian.
// Each is good to 2 ulp.  Pairs not marked valid carry no weight and are not
// read past their flag (the plain version multiplies their terms by zero,
// the same wherever those terms are finite).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 256 threads x 4 pairs, as K3: every warp repeats the solve, so more warps
// cost scheduler slots on the chain, and fewer leave the pass too little in
// flight.
constexpr int NT = 256;
constexpr int PPT = 4;
constexpr int NW = NT / 32;
constexpr int NRED = 40;            // 28 H + 7 g + 2 costs, 32 + 8 lanes
constexpr int G0 = 28;              // first g
constexpr int C_OWN = 35;           // cost under the pass's own weights
constexpr int C_CUR = 36;           // cost under the current weights
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy;
};

// A Sim3 with what every pair's terms need of it.
struct Sim3 {
  float s, R[9], t[3];
};

struct Pair {
  float x1[3], x2[3], u1, v1, u2, v2;
};

__device__ __forceinline__ Pair load_pair(const float* __restrict__ x1,
                                          const float* __restrict__ x2,
                                          const float* __restrict__ uv1,
                                          const float* __restrict__ uv2,
                                          int i) {
  Pair p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.x1[k] = x1[3 * i + k];
    p.x2[k] = x2[3 * i + k];
  }
  p.u1 = uv1[2 * i];
  p.v1 = uv1[2 * i + 1];
  p.u2 = uv2[2 * i];
  p.v2 = uv2[2 * i + 1];
  return p;
}

// Residuals [r1u, r1v, r2u, r2v] of one pair at S (x1 mapped back through
// S^-1 into image 1, x1 through S into image 2); with JAC also the 4 x 7
// Jacobian rows w.r.t. (omega, nu, sigma) at delta = 0, the closed form of
// `sim3_residuals_jac`: with a = s R x1, q = x2 - t, P a projection row and
// c = R P, the rows are [a x P | P | sig P.a] in image 2 and
// [(c x q) / s | -c / s | -live P.x1_pred] in image 1.
template <bool JAC>
__device__ __forceinline__ void pair_terms(const Sim3& S, float isc,
                                           float sig, float live,
                                           const Cam& cam, const Pair& p,
                                           float (&r)[4], float (&J)[4][7]) {
  const float* R = S.R;
  const float ax = S.s * (R[0] * p.x1[0] + R[1] * p.x1[1] + R[2] * p.x1[2]);
  const float ay = S.s * (R[3] * p.x1[0] + R[4] * p.x1[1] + R[5] * p.x1[2]);
  const float az = S.s * (R[6] * p.x1[0] + R[7] * p.x1[1] + R[8] * p.x1[2]);
  const float X2 = ax + S.t[0], Y2 = ay + S.t[1], Z2 = az + S.t[2];
  const float qx = p.x2[0] - S.t[0], qy = p.x2[1] - S.t[1],
              qz = p.x2[2] - S.t[2];
  const float X1 = (R[0] * qx + R[3] * qy + R[6] * qz) * isc;
  const float Y1 = (R[1] * qx + R[4] * qy + R[7] * qz) * isc;
  const float Z1 = (R[2] * qx + R[5] * qy + R[8] * qz) * isc;
  const bool cl1 = fabsf(Z1) < 1e-6f, cl2 = fabsf(Z2) < 1e-6f;
  const float iz1 = __fdividef(1.0f, cl1 ? 1e-6f : Z1);
  const float iz2 = __fdividef(1.0f, cl2 ? 1e-6f : Z2);
  r[0] = X1 * iz1 * cam.fx + cam.cx - p.u1;
  r[1] = Y1 * iz1 * cam.fy + cam.cy - p.v1;
  r[2] = X2 * iz2 * cam.fx + cam.cx - p.u2;
  r[3] = Y2 * iz2 * cam.fy + cam.cy - p.v2;
  if (!JAC) return;

  // a depth clamped by the projection carries no tangent
  const float dz1 = cl1 ? 0.0f : iz1 * iz1, dz2 = cl2 ? 0.0f : iz2 * iz2;
  // image 1: P = (fx iz, 0, -fx X iz^2) and (0, fy iz, -fy Y iz^2)
  {
    const float P[2][3] = {{cam.fx * iz1, 0.0f, -cam.fx * X1 * dz1},
                           {0.0f, cam.fy * iz1, -cam.fy * Y1 * dz1}};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float* Pr = P[row];
      const float c0 = R[0] * Pr[0] + R[1] * Pr[1] + R[2] * Pr[2];
      const float c1 = R[3] * Pr[0] + R[4] * Pr[1] + R[5] * Pr[2];
      const float c2 = R[6] * Pr[0] + R[7] * Pr[1] + R[8] * Pr[2];
      float* Jr = J[row];
      Jr[0] = (c1 * qz - c2 * qy) * isc;
      Jr[1] = (c2 * qx - c0 * qz) * isc;
      Jr[2] = (c0 * qy - c1 * qx) * isc;
      Jr[3] = -c0 * isc;
      Jr[4] = -c1 * isc;
      Jr[5] = -c2 * isc;
      Jr[6] = -live * (Pr[0] * X1 + Pr[1] * Y1 + Pr[2] * Z1);
    }
  }
  // image 2
  {
    const float P[2][3] = {{cam.fx * iz2, 0.0f, -cam.fx * X2 * dz2},
                           {0.0f, cam.fy * iz2, -cam.fy * Y2 * dz2}};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float* Pr = P[row];
      float* Jr = J[2 + row];
      Jr[0] = ay * Pr[2] - az * Pr[1];
      Jr[1] = az * Pr[0] - ax * Pr[2];
      Jr[2] = ax * Pr[1] - ay * Pr[0];
      Jr[3] = Pr[0];
      Jr[4] = Pr[1];
      Jr[5] = Pr[2];
      Jr[6] = sig * (Pr[0] * ax + Pr[1] * ay + Pr[2] * az);
    }
  }
}

__device__ __forceinline__ float sq2(float a, float b) {
  return a * a + b * b;
}

// The Huber weight at chi2_th on a pair's squared error, times its weight.
__device__ __forceinline__ float huber(float chi2, float chi2_th,
                                       float sqrt_th, float w_in) {
  return chi2 > chi2_th ? w_in * (sqrt_th * rsqrtf(fmaxf(chi2, 1e-12f)))
                        : w_in;
}

// Adds w J^T J (upper triangle) and w J^T r of one pair to acc.
__device__ __forceinline__ void accumulate(const float (&J)[4][7],
                                           const float (&r)[4], float w,
                                           float (&acc)[NRED]) {
#pragma unroll
  for (int row = 0; row < 4; ++row) {
    int k = 0;
#pragma unroll
    for (int a = 0; a < 7; ++a) {
      const float wa = w * J[row][a];
#pragma unroll
      for (int c = a; c < 7; ++c) {
        acc[k] = fmaf(wa, J[row][c], acc[k]);
        ++k;
      }
      acc[G0 + a] = fmaf(wa, r[row], acc[G0 + a]);
    }
  }
}

// One round of the transposing butterfly on v[OFF, OFF + 2 HALF): lanes
// whose bit XOR is set keep the upper half, the others the lower, and each
// adds its partner's copy.
template <int OFF, int HALF, int XOR>
__device__ __forceinline__ void butterfly_round(float (&v)[NRED], int lane) {
  const bool up = (lane & XOR) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[OFF + i + HALF] : v[OFF + i];
    const float send = up ? v[OFF + i] : v[OFF + i + HALF];
    v[OFF + i] = keep + __shfl_xor_sync(FULL, send, XOR);
  }
}

// Warp sums: on return v[0] of lane k holds the warp's sum of value k, and
// v[32] of lanes 4m..4m+3 the sum of value 32 + m.
__device__ __forceinline__ void warp_sums(float (&v)[NRED], int lane) {
  butterfly_round<0, 16, 16>(v, lane);
  butterfly_round<0, 8, 8>(v, lane);
  butterfly_round<0, 4, 4>(v, lane);
  butterfly_round<0, 2, 2>(v, lane);
  butterfly_round<0, 1, 1>(v, lane);
  butterfly_round<32, 4, 16>(v, lane);
  butterfly_round<32, 2, 8>(v, lane);
  butterfly_round<32, 1, 4>(v, lane);
  v[32] += __shfl_xor_sync(FULL, v[32], 2);
  v[32] += __shfl_xor_sync(FULL, v[32], 1);
}

// The damped step from the sums hb (28 upper-triangular H, then 7 g) and
// the trial Sim3 it leads to: d = -(H + lam diag(max(diag H, 1e-6))
// + 1e-9 I)^-1 g, sigma's row and column replaced by the identity's under
// fix_scale; R <- exp(omega) R, t <- t + nu, s <- s exp(sigma).
__device__ __forceinline__ void trial_sim3(const float (&hb)[35], float lam,
                                           bool fix_scale, const Sim3& S,
                                           Sim3& T) {
  float H[7][7], g[7];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 7; ++a)
#pragma unroll
    for (int c = a; c < 7; ++c) {
      H[a][c] = hb[k];
      H[c][a] = hb[k];
      ++k;
    }
#pragma unroll
  for (int a = 0; a < 7; ++a) {
    H[a][a] = H[a][a] + lam * fmaxf(H[a][a], 1e-6f);
    g[a] = hb[G0 + a];
  }
  if (fix_scale) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      H[6][a] = 0.0f;
      H[a][6] = 0.0f;
    }
    H[6][6] = 1.0f;
    g[6] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < 7; ++a) H[a][a] += 1e-9f;

  // Cholesky; L's diagonal is needed only through its reciprocal
  float L[7][7], inv[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    inv[j] = rsqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < 7; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t -= L[i][q] * L[j][q];
      L[i][j] = t * inv[j];
    }
  }
  float y[7], x[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float s = g[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 7; ++q) s -= L[q][i] * x[q];
    x[i] = s * inv[i];
  }

  // exp(omega), omega = -x[0:3]: A = sin(th) / th, B = (1 - cos(th)) / th^2.
  // An LM step turns by far less than half a radian, where the series to
  // th^8 are exact to f32 rounding and free of the closed forms'
  // cancellation; beyond it the closed forms take over.
  const float wx = -x[0], wy = -x[1], wz = -x[2];
  const float t2 = wx * wx + wy * wy + wz * wz;
  float A, B;
  if (t2 < 0.25f) {
    A = fmaf(t2, fmaf(t2, fmaf(t2, fmaf(t2, 1.0f / 362880.0f,
        -1.0f / 5040.0f), 1.0f / 120.0f), -1.0f / 6.0f), 1.0f);
    B = fmaf(t2, fmaf(t2, fmaf(t2, fmaf(t2, 1.0f / 3628800.0f,
        -1.0f / 40320.0f), 1.0f / 720.0f), -1.0f / 24.0f), 0.5f);
  } else {
    const float th = sqrtf(t2);
    A = sinf(th) / th;
    B = (1.0f - cosf(th)) / t2;
  }
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  const float W2[3][3] = {{-(wy * wy + wz * wz), wx * wy, wx * wz},
                          {wx * wy, -(wx * wx + wz * wz), wy * wz},
                          {wx * wz, wy * wz, -(wx * wx + wy * wy)}};
  float D[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      D[i][j] = ((i == j) ? 1.0f : 0.0f) + A * W[i][j] + B * W2[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      T.R[3 * i + j] = D[i][0] * S.R[j] + D[i][1] * S.R[3 + j] +
                       D[i][2] * S.R[6 + j];
    T.t[i] = S.t[i] - x[3 + i];
  }
  T.s = fix_scale ? S.s : S.s * expf(-x[6]);
}

// Per-Sim3 constants of the pass: 1 / max(s, 1e-9), sigma's switch, and
// whether the inverse map's scale carries a tangent.
__device__ __forceinline__ void sim3_consts(const Sim3& S, bool fix_scale,
                                            float& isc, float& sig,
                                            float& live) {
  isc = 1.0f / fmaxf(S.s, 1e-9f);
  sig = fix_scale ? 0.0f : 1.0f;
  live = (S.s > 1e-9f) ? sig : 0.0f;
}

template <bool REG>
__global__ void __launch_bounds__(NT) sim3_refine_lm_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ uv1, const float* __restrict__ uv2,
    const uint8_t* __restrict__ valid, const float* __restrict__ s0,
    const float* __restrict__ R0, const float* __restrict__ t0, int n,
    Cam cam, int fix_scale_i, float chi2_th, int iters1, int iters2,
    float* __restrict__ s_out, float* __restrict__ R_out,
    float* __restrict__ t_out, uint8_t* __restrict__ inl) {
  __shared__ float s_part[2][NW][NRED];
  __shared__ int s_at[NT * PPT];          // packing (REG)
  __shared__ int s_cnt[PPT * NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool fix_scale = fix_scale_i != 0;
  const float sqrt_th = sqrtf(chi2_th);

  // This thread's pairs.  The register path keeps only the valid ones,
  // packed to the front in their order.
  Pair pr[PPT];
  float w_in[PPT], w_cur[PPT], w_new[PPT];
  int at[PPT];                  // where the pair came from, or -1
  int n_live = n;
  if (REG) {
    unsigned have[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * NT;
      const bool live = i < n && valid[i] != 0;
      if (i < n && !live) inl[i] = 0;
      have[j] = __ballot_sync(FULL, live);
      if (lane == 0) s_cnt[j * NW + warp] = __popc(have[j]);
    }
    __syncthreads();
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
    for (int j = 0; j < PPT; ++j)
      if (have[j] >> lane & 1u)
        s_at[before[j] + __popc(have[j] & ((1u << lane) - 1u))] =
            tid + j * NT;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * NT;
      at[j] = p < n_live ? s_at[p] : -1;
      if (at[j] >= 0) {
        pr[j] = load_pair(x1, x2, uv1, uv2, at[j]);
      } else {
        pr[j] = Pair{{0.f, 0.f, 1.f}, {0.f, 0.f, 1.f}, 0.f, 0.f, 0.f, 0.f};
      }
      w_in[j] = at[j] >= 0 ? 1.0f : 0.0f;
      w_cur[j] = 0.0f;
      w_new[j] = 0.0f;
    }
  } else {
    for (int i = tid; i < n; i += NT) inl[i] = valid[i] != 0;
  }

  Sim3 S;
  S.s = s0[0];
#pragma unroll
  for (int k = 0; k < 9; ++k) S.R[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) S.t[k] = t0[k];
  Sim3 T = S;

  float hb[35];
  float cost = 0.0f, lam = 1e-3f;
  int step = 0;

  // Passes: per round one at the current Sim3 (in round 2 with the prune's
  // gate first), then one per LM step at its trial; the last pass is the
  // final gate and has no sums.
  for (int rnd = 0; rnd <= 2; ++rnd) {
    const bool last = rnd == 2;
    const int iters = rnd == 0 ? iters1 : iters2;
    const int passes = last ? 1 : iters + 1;
    lam = 1e-3f;
    for (int it = 0; it < passes; ++it) {
      const bool fresh = it == 0;
      const bool gate = fresh && rnd > 0;    // the prune, or the final gate
      const Sim3 P = fresh ? S : T;
      float isc, sig, live;
      sim3_consts(P, fix_scale, isc, sig, live);
      float cisc = isc, csig = sig, clive = live;
      if (!REG && !fresh) sim3_consts(S, fix_scale, cisc, csig, clive);

      float acc[NRED];
#pragma unroll
      for (int k = 0; k < NRED; ++k) acc[k] = 0.0f;
      float r[4], J[4][7];

      if (REG) {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          if (j * NT + warp * 32 >= n_live) continue;  // the whole warp
          if (at[j] < 0) continue;
          if (last) {
            pair_terms<false>(P, isc, sig, live, cam, pr[j], r, J);
            inl[at[j]] = sq2(r[0], r[1]) < chi2_th &&
                         sq2(r[2], r[3]) < chi2_th;
            continue;
          }
          pair_terms<true>(P, isc, sig, live, cam, pr[j], r, J);
          if (gate)
            w_in[j] = (sq2(r[0], r[1]) < chi2_th &&
                       sq2(r[2], r[3]) < chi2_th) ? 1.0f : 0.0f;
          if (w_in[j] == 0.0f) {
            w_new[j] = 0.0f;
            continue;
          }
          const float chi2 = sq2(r[0], r[1]) + sq2(r[2], r[3]);
          const float w = huber(chi2, chi2_th, sqrt_th, w_in[j]);
          w_new[j] = w;
          accumulate(J, r, w, acc);
          acc[C_OWN] = fmaf(w, chi2, acc[C_OWN]);
          acc[C_CUR] = fmaf(w_cur[j], chi2, acc[C_CUR]);
        }
      } else {
        for (int i = tid; i < n; i += NT) {
          if (!valid[i]) continue;
          const Pair p = load_pair(x1, x2, uv1, uv2, i);
          if (last) {
            pair_terms<false>(P, isc, sig, live, cam, p, r, J);
            inl[i] = sq2(r[0], r[1]) < chi2_th && sq2(r[2], r[3]) < chi2_th;
            continue;
          }
          pair_terms<true>(P, isc, sig, live, cam, p, r, J);
          float wi;
          if (gate) {
            const bool in = sq2(r[0], r[1]) < chi2_th &&
                            sq2(r[2], r[3]) < chi2_th;
            inl[i] = in;
            wi = in ? 1.0f : 0.0f;
          } else {
            wi = inl[i] != 0 ? 1.0f : 0.0f;
          }
          if (wi == 0.0f) continue;
          const float chi2 = sq2(r[0], r[1]) + sq2(r[2], r[3]);
          const float w = huber(chi2, chi2_th, sqrt_th, wi);
          accumulate(J, r, w, acc);
          acc[C_OWN] = fmaf(w, chi2, acc[C_OWN]);
          if (!fresh) {
            // the pair's weight at the current Sim3
            float rc[4], Jc[4][7];
            pair_terms<false>(S, cisc, csig, clive, cam, p, rc, Jc);
            const float cc = sq2(rc[0], rc[1]) + sq2(rc[2], rc[3]);
            acc[C_CUR] = fmaf(huber(cc, chi2_th, sqrt_th, wi), chi2,
                              acc[C_CUR]);
          }
        }
      }
      if (last) break;

      // block-wide sums: lane k of every warp ends with the total of value
      // k (k < 32) and of value 32 + (k & 7)
      const int buf = step & 1;
      ++step;
      warp_sums(acc, lane);
      s_part[buf][warp][lane] = acc[0];
      if ((lane & 3) == 0) s_part[buf][warp][32 + (lane >> 2)] = acc[32];
      __syncthreads();
      float pa[NW], pb[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        pa[w] = s_part[buf][w][lane];
        pb[w] = s_part[buf][w][32 + (lane & 7)];
      }
      static_assert(NW == 8, "the trees below add eight partials");
      const float ta = ((pa[0] + pa[1]) + (pa[2] + pa[3])) +
                       ((pa[4] + pa[5]) + (pa[6] + pa[7]));
      const float tb = ((pb[0] + pb[1]) + (pb[2] + pb[3])) +
                       ((pb[4] + pb[5]) + (pb[6] + pb[7]));

      const float c_own = __shfl_sync(FULL, tb, C_OWN - 32);
      const float c_cur = __shfl_sync(FULL, tb, C_CUR - 32);
      const bool accept = fresh || c_cur < cost;
      if (accept) {
#pragma unroll
        for (int k = 0; k < 32; ++k) hb[k] = __shfl_sync(FULL, ta, k);
#pragma unroll
        for (int k = 32; k < 35; ++k) hb[k] = __shfl_sync(FULL, tb, k - 32);
        cost = c_own;
        if (!fresh) S = T;
        if (REG) {
#pragma unroll
          for (int j = 0; j < PPT; ++j) w_cur[j] = w_new[j];
        }
      }
      if (!fresh)
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-6f), 1e4f);
      if (it + 1 < passes) trial_sim3(hb, lam, fix_scale, S, T);
    }
  }

  if (tid == 0) s_out[0] = S.s;
  if (tid < 9) R_out[tid] = S.R[tid];
  if (tid < 3) t_out[tid] = S.t[tid];
}

}  // namespace

// Largest N the register path takes; above it the kernel loops over device
// memory.
extern "C" int coslam_sim3_refine_lm_register_limit() { return NT * PPT; }

extern "C" int coslam_sim3_refine_lm(
    const float* x1, const float* x2, const float* uv1, const float* uv2,
    const uint8_t* valid, const float* s0, const float* R0, const float* t0,
    int n, float fx, float fy, float cx, float cy, int fix_scale,
    float chi2_th, int iters1, int iters2, float* s_out, float* R_out,
    float* t_out, uint8_t* inl, void* stream) {
  const Cam cam{fx, fy, cx, cy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= NT * PPT)
    sim3_refine_lm_kernel<true><<<1, NT, 0, s>>>(
        x1, x2, uv1, uv2, valid, s0, R0, t0, n, cam, fix_scale, chi2_th,
        iters1, iters2, s_out, R_out, t_out, inl);
  else
    sim3_refine_lm_kernel<false><<<1, NT, 0, s>>>(
        x1, x2, uv1, uv2, valid, s0, R0, t0, n, cam, fix_scale, chi2_th,
        iters1, iters2, s_out, R_out, t_out, inl);
  return static_cast<int>(cudaGetLastError());
}
