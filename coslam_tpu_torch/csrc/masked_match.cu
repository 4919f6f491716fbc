// Kernel K2: gated Hamming matcher — for each query descriptor, the best and
// second-best Hamming distance and the index of the best, over the targets
// that pass the spatial window (both radii), validity and octave gates.
//
// Replaces the Pallas TPU kernel `masked_match` / `_match_kernel` in
// coslam_tpu/ops/pallas_kernels.py.  Plain version: `masked_match_plain` in
// coslam_tpu_torch/ops/cuda_kernels.py.
//
// What bounds it on the H100: integer issue rate.  A pair costs 8 XOR +
// 8 popcount + adds plus ~12 gate instructions; the local-map search is
// 32768 x 1024 pairs in each direction (~1.5 G instructions per pass),
// while its inputs are < 2 MB.  The TPU kernel turned the distance into a
// +/-1 bf16 MXU contraction; on Hopper `__popc(a ^ b)` is the native form.
// The design: one thread per query, its 8 descriptor words, window and
// octave in registers; targets stream through shared memory in tiles of
// 256 (descriptors, uv, r2_t, octave, valid), read as broadcasts.  Neither
// the (N, M) distance nor the mask matrix is ever built.  When there are
// too few queries to fill the card (the reverse local-map pass has 1024
// queries over 32768 targets), the target range is split into segments
// across blockIdx.y and a second kernel merges the per-segment results in
// segment order.
//
// Tie order is the reference's: targets are visited in increasing index
// and the update is
//   if d < best: second = best; best = d; idx = j  elif d < second: second = d
// so best/second/idx agree bit for bit with pallas_kernels.py:195-205.  The
// window test uses __fmul_rn/__fadd_rn so that no FMA contraction changes
// which targets sit inside the radius.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 128;        // queries (threads) per block
constexpr int TILE = 256;      // targets per shared-memory tile
constexpr int INF_I32 = 1 << 20;

__global__ void masked_match_kernel(
    const int* __restrict__ desc_q, const float* __restrict__ uv_q,
    const float* __restrict__ r2_q, const uint8_t* __restrict__ valid_q,
    const float* __restrict__ level_q,
    const int* __restrict__ desc_t, const float* __restrict__ uv_t,
    const uint8_t* __restrict__ valid_t, const float* __restrict__ r2_t,
    const float* __restrict__ level_t,
    int n, int m, int seg_len, int use_level, float level_lo,
    float level_hi, int* __restrict__ best_out,
    int* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ int s_desc[TILE * 8];
  __shared__ float s_u[TILE], s_v[TILE], s_r2[TILE], s_l[TILE];
  __shared__ uint8_t s_ok[TILE];

  const int q = blockIdx.x * QB + threadIdx.x;
  const int seg = blockIdx.y;
  const int m0 = seg * seg_len;
  const int m1 = min(m, m0 + seg_len);

  unsigned int dq[8];
  float uq = 0.f, vq = 0.f, r2 = 0.f, lq = 0.f;
  bool active = false;
  if (q < n) {
#pragma unroll
    for (int k = 0; k < 8; ++k) dq[k] = static_cast<unsigned int>(desc_q[q * 8 + k]);
    uq = uv_q[2 * q];
    vq = uv_q[2 * q + 1];
    r2 = r2_q[q];
    lq = level_q[q];
    active = valid_q[q] != 0;
  }

  int best = INF_I32, second = INF_I32, idx = -1;
  for (int base = m0; base < m1; base += TILE) {
    const int cnt = min(TILE, m1 - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 8; k += QB)
      s_desc[k] = desc_t[base * 8 + k];
    for (int k = threadIdx.x; k < cnt; k += QB) {
      s_u[k] = uv_t[2 * (base + k)];
      s_v[k] = uv_t[2 * (base + k) + 1];
      s_r2[k] = r2_t[base + k];
      s_l[k] = level_t[base + k];
      s_ok[k] = valid_t[base + k];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < cnt; ++k) {
      if (!s_ok[k]) continue;
      const float d0 = uq - s_u[k];
      const float d1 = vq - s_v[k];
      const float d2 = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
      if (!(d2 <= r2 && d2 <= s_r2[k])) continue;
      if (use_level) {
        const float dl = s_l[k] - lq;
        if (!(dl >= level_lo && dl <= level_hi)) continue;
      }
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        d += __popc(dq[w] ^ static_cast<unsigned int>(s_desc[k * 8 + w]));
      if (d < best) {
        second = best;
        best = d;
        idx = base + k;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (q < n) {
    best_out[seg * n + q] = best;
    second_out[seg * n + q] = second;
    idx_out[seg * n + q] = idx;
  }
}

// Fold per-segment (best, second, idx) in segment order — the same update
// the TPU kernel applies across its target blocks.
__global__ void masked_match_merge_kernel(
    const int* __restrict__ pbest, const int* __restrict__ psecond,
    const int* __restrict__ pidx, int n_seg, int n,
    int* __restrict__ best_out, int* __restrict__ second_out,
    int* __restrict__ idx_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int best = INF_I32, second = INF_I32, idx = -1;
  for (int s = 0; s < n_seg; ++s) {
    const int b = pbest[s * n + q];
    if (b < best) {
      second = min(best, psecond[s * n + q]);
      best = b;
      idx = pidx[s * n + q];
    } else {
      second = min(second, b);
    }
  }
  best_out[q] = best;
  second_out[q] = second;
  idx_out[q] = idx;
}

}  // namespace

// Number of target segments the launch will use for an (n, m) problem; the
// caller allocates 3 * n_seg * n ints of scratch when it is above 1.
extern "C" int coslam_masked_match_segments(int n, int m) {
  const int q_blocks = (n + QB - 1) / QB;
  const int tiles = (m + TILE - 1) / TILE;
  const int want = (264 + q_blocks - 1) / q_blocks;   // ~2 blocks per SM
  return max(1, min(want, tiles));
}

extern "C" int coslam_masked_match(
    const int* desc_q, const float* uv_q, const float* r2_q,
    const uint8_t* valid_q, const float* level_q, const int* desc_t,
    const float* uv_t, const uint8_t* valid_t, const float* r2_t,
    const float* level_t, int n, int m, int use_level, float level_lo,
    float level_hi, int* best, int* second, int* idx, int* scratch,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int n_seg = coslam_masked_match_segments(n, m);
  const int tiles = (m + TILE - 1) / TILE;
  const int seg_len = ((tiles + n_seg - 1) / n_seg) * TILE;
  const dim3 grid((n + QB - 1) / QB, n_seg);
  int* pb = n_seg > 1 ? scratch : best;
  int* ps = n_seg > 1 ? scratch + n_seg * n : second;
  int* pi = n_seg > 1 ? scratch + 2 * n_seg * n : idx;
  masked_match_kernel<<<grid, QB, 0, stream>>>(
      desc_q, uv_q, r2_q, valid_q, level_q, desc_t, uv_t, valid_t, r2_t,
      level_t, n, m, seg_len, use_level, level_lo, level_hi, pb, ps, pi);
  if (n_seg > 1) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    masked_match_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        pb, ps, pi, n_seg, n, best, second, idx);
  }
  return static_cast<int>(cudaGetLastError());
}
