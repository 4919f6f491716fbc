// Kernel K1: FAST-9/16 corner score + 3x3 non-maximum suppression.
//
// Replaces the Pallas TPU kernel `fast_score_nms` / `_fast_kernel` in
// coslam_tpu/ops/pallas_kernels.py.  Plain version: nms3(fast_score(img))
// in coslam_tpu_torch/ops/fast.py.
//
// What bounds it on the H100: memory traffic.  Per pixel the algorithm
// reads 16 circle samples and does ~300 min/max/sub operations; an unfused
// formulation writes 16 shifted copies plus the score map through device
// memory.  Here each block stages a (BY + 2*HALO) x (BX + 2*HALO) image tile
// in shared memory once (HALO = 3 px circle radius + 1 px NMS), computes the
// score for its tile plus a 1-px ring into shared memory, and writes only
// the NMS'd output: one read and one write of the image per level.  The
// arithmetic (~300 ops/px, ~0.1 GOP for the 8-level 640x480 pyramid) is far
// below the card's rate, so the kernel is launch- and latency-bound at
// these image sizes.
//
// Borders: the reference wraps at the image border (jnp.roll); this kernel
// clamps reads there and pads the NMS window with -inf.  Only pixels >= 4 px
// inside the image agree, which is all the extractor keeps (edge_threshold
// = 19 px border mask).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int HALO = 4;
constexpr int TW = BX + 2 * HALO;   // image tile width
constexpr int TH = BY + 2 * HALO;   // image tile height
constexpr int SW = BX + 2;          // score tile (tile + 1-px ring)
constexpr int SH = BY + 2;

// Bresenham circle of radius 3, (dy, dx) clockwise from 12 o'clock — the
// same order as fast.CIRCLE, so arc starts enumerate identically.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_nms_kernel(const float* __restrict__ img,
                                      float* __restrict__ out,
                                      int h, int w) {
  __shared__ float tile[TH][TW];
  __shared__ float score[SH][SW];

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int nthreads = BX * BY;

  for (int i = tid; i < TH * TW; i += nthreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = min(max(y0 + ty - HALO, 0), h - 1);
    const int gx = min(max(x0 + tx - HALO, 0), w - 1);
    tile[ty][tx] = img[gy * w + gx];
  }
  __syncthreads();

  // score of the pixel at tile coords (sy + 3, sx + 3) for the output tile
  // plus a 1-px ring; outside the image the NMS window sees -inf
  for (int i = tid; i < SH * SW; i += nthreads) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = -CUDART_INF_F;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int cy = sy + HALO - 1, cx = sx + HALO - 1;
      const float c = tile[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = tile[cy + kCircleDy[k]][cx + kCircleDx[k]] - c;
      // brighter arc: min of d over 9; darker arc: min of (c - circ) over 9
      // = -(max of d), exact since a - b == -(b - a) in IEEE arithmetic
#pragma unroll
      for (int start = 0; start < 16; ++start) {
        float mn = d[start], mx = d[start];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          const float v = d[(start + j) & 15];
          mn = fminf(mn, v);
          mx = fmaxf(mx, v);
        }
        s = fmaxf(s, fmaxf(mn, -mx));
      }
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy < h && gx < w) {
    const float s = score[threadIdx.y + 1][threadIdx.x + 1];
    float pooled = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        pooled = fmaxf(pooled, score[threadIdx.y + dy][threadIdx.x + dx]);
    out[gy * w + gx] = (s >= pooled) ? s : 0.0f;
  }
}

}  // namespace

extern "C" int coslam_fast_score_nms(const float* img, float* out, int h,
                                     int w, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  fast_score_nms_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
