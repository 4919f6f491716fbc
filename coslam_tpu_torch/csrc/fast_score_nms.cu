// Kernel K1: FAST-9/16 corner score + 3x3 non-maximum suppression + border
// mask, for every level of an image pyramid in one launch.
//
// Replaces the Pallas TPU kernel `fast_score_nms` / `_fast_kernel` in
// coslam_tpu/ops/pallas_kernels.py together with the `* border_mask` that
// follows it in the extractor.  Plain version: nms3(fast_score(img)) *
// border_mask in coslam_tpu_torch/ops/fast.py and ops/cuda_kernels.py.
//
// What bounds it on the H100: instruction rate (~80 min / max a score), and
// before that launch latency.  A pyramid of a 640x480 frame is 0.95 M pixels
// in 8 levels whose smallest fills under one wave of blocks, so a launch per
// level costs more in latency and idle SMs than in work.  The design:
//   * one launch: the levels are separate tensors, so the kernel takes a
//     by-value table of up to 8 (pointer, shape, first tile) entries and a
//     flat grid over the tiles of all levels; a block finds its level by
//     comparing blockIdx.x with the first-tile counts;
//   * the border mask inside: the tile grid of a level starts at the
//     margin, tiles that lie wholly in the margin write zeros and compute
//     nothing, and the scores of the 1-px ring around the kept region are
//     still computed, because the NMS runs before the mask;
//   * a block stages a 22x70 image tile in shared memory once and scores a
//     16x64 region with 256 threads, four pixels in a column each (lanes on
//     neighbouring columns: every shared-memory access is conflict-free, and
//     the four pixels share ring samples), then writes the 14x62 NMS'd
//     outputs: all lanes are live in the one scoring round;
//   * min and max run at half the f32 rate on this card and are nearly
//     all of a score's work, so their count is what matters.  Rounding is
//     monotone: min over an arc of fl(ring - c) is fl(min of the arc - c),
//     so the extrema are taken on the pixels themselves, once for both
//     signs of the difference, and the subtraction comes last.  The pixels
//     are staged as order-preserving integer keys, and Hopper's three-input
//     integer min / max makes an arc's extremum from 3 windows of 3: 2
//     instructions per arc start (the plain version's log-step windows 2,
//     4, 8, 9 take 4 two-input ones and the direct form 8), all in
//     registers with compile-time offsets.  Min and max are exact in any
//     association, so the result is bit-equal to the plain version's.
// Level rows are not 16-byte aligned (widths 640, 533, 444, ...), so the
// staging uses plain coalesced 4-byte loads, not TMA or vector loads.
//
// Borders: the reference wraps at the image border (jnp.roll); this kernel
// clamps reads there and pads the NMS window with -inf.  Pixels >= 4 px
// inside the image agree, which with a margin >= 4 is every non-zero pixel.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int PIX = 4;               // score pixels per thread, in a column
constexpr int SW = 64;               // score region of a block
constexpr int SH = 4 * PIX;
constexpr int NTHREADS = SW * SH / PIX;
constexpr int OW = SW - 2;           // outputs of a block
constexpr int OH = SH - 2;
constexpr int HALO = 4;              // 3 px circle radius + 1 px NMS
constexpr int TW = OW + 2 * HALO;    // staged image tile
constexpr int TH = OH + 2 * HALO;

struct Level {
  const float* img;
  float* out;
  int h, w;
  int tile0;      // index of the level's first tile in the grid
  int tiles_x;    // tiles per tile row
};

struct Pyramid {
  Level lv[MAX_LEVELS];
  int n_levels;
  int margin;     // border width that is written as zero
  int lead_x;     // tile columns that lie before the margin's end
  int lead_y;     // tile rows likewise
};

// Bresenham circle of radius 3, (k, dy, dx) clockwise from 12 o'clock — the
// same order as fast.CIRCLE, so arc starts enumerate identically.
#define COSLAM_RING(F)                                                      \
  F(0, -3, 0) F(1, -3, 1) F(2, -2, 2) F(3, -1, 3) F(4, 0, 3) F(5, 1, 3)     \
  F(6, 2, 2) F(7, 3, 1) F(8, 3, 0) F(9, 3, -1) F(10, 2, -2) F(11, 1, -3)    \
  F(12, 0, -3) F(13, -1, -3) F(14, -2, -2) F(15, -3, -1)

// Order-preserving integer key of a float's bits (and back: the map is its
// own inverse): signed comparison of keys is float comparison of values.
__device__ __forceinline__ int key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int pixel_key(float x) {
  return key(__float_as_int(x));
}
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(key(k));
}

template <bool kMin>
__device__ __forceinline__ int pick3(int a, int b, int c) {
  return kMin ? __vimin3_s32(a, b, c) : __vimax3_s32(a, b, c);
}

// kMin: max over the 16 arc starts of the minimum of r over the 9-long arc;
// !kMin: min over the arc starts of the arc's maximum.  Windows of 3, then 3
// windows make an arc: 2 three-input operations an arc start.
template <bool kMin>
__device__ __forceinline__ int best_arc(const int (&r)[16]) {
  int a[16], b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    a[k] = pick3<kMin>(r[k], r[(k + 1) & 15], r[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    b[k] = pick3<kMin>(a[k], a[(k + 3) & 15], a[(k + 6) & 15]);
#pragma unroll
  for (int k = 0; k < 5; ++k)
    a[k] = pick3<!kMin>(b[3 * k], b[3 * k + 1], b[3 * k + 2]);
  return pick3<!kMin>(a[0], pick3<!kMin>(a[1], a[2], a[3]),
                      pick3<!kMin>(a[4], b[15], b[15]));
}

__global__ void __launch_bounds__(NTHREADS, 5)
fast_score_nms_kernel(const __grid_constant__ Pyramid P) {
  __shared__ int tile[TH * TW];     // keys of the staged pixels
  __shared__ float score[SH * SW];

  int l = 0;
  while (l + 1 < P.n_levels && (int)blockIdx.x >= P.lv[l + 1].tile0) ++l;
  const float* __restrict__ img = P.lv[l].img;
  float* __restrict__ out = P.lv[l].out;
  const int h = P.lv[l].h, w = P.lv[l].w, mg = P.margin;
  const int t = (int)blockIdx.x - P.lv[l].tile0;
  const int tiles_x = P.lv[l].tiles_x;
  // first output pixel of the tile; negative where a leading tile hangs over
  const int x0 = mg + (t % tiles_x - P.lead_x) * OW;
  const int y0 = mg + (t / tiles_x - P.lead_y) * OH;
  const int tid = threadIdx.x;

  if (x0 + OW <= mg || x0 >= w - mg || y0 + OH <= mg || y0 >= h - mg) {
    // wholly in the margin
    for (int i = tid; i < OH * OW; i += NTHREADS) {
      const int gy = y0 + i / OW, gx = x0 + i % OW;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) out[gy * w + gx] = 0.0f;
    }
    return;
  }

  {
    // a thread keeps its column: SW columns by NTHREADS / SW rows a pass,
    // then the TW - SW columns left over in one more
    const int col = tid % SW;
    const int gx = min(max(x0 - HALO + col, 0), w - 1);
    for (int r = tid / SW; r < TH; r += NTHREADS / SW)
      tile[r * TW + col] =
          pixel_key(img[min(max(y0 - HALO + r, 0), h - 1) * w + gx]);
    static_assert((TW - SW) * TH <= NTHREADS, "leftover columns in one pass");
    if (tid < (TW - SW) * TH) {
      const int r = tid / (TW - SW), c = SW + tid % (TW - SW);
      tile[r * TW + c] =
          pixel_key(img[min(max(y0 - HALO + r, 0), h - 1) * w
                        + min(max(x0 - HALO + c, 0), w - 1)]);
    }
  }
  __syncthreads();

  // score pixel (sy, sx) is image pixel (y0 - 1 + sy, x0 - 1 + sx) and tile
  // pixel (sy + HALO - 1, sx + HALO - 1); the thread scores rows sy0 .. + PIX
  const int sx = tid % SW;
  const int sy0 = (tid / SW) * PIX;
  const int gx = x0 - 1 + sx;
  float s[PIX];
  const int* p = &tile[(sy0 + HALO - 1) * TW + sx + HALO - 1];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const float c = key_value(p[q * TW]);
    int r[16];
#define COSLAM_LOAD(k, dy, dx) r[k] = p[(q + (dy)) * TW + (dx)];
    COSLAM_RING(COSLAM_LOAD)
#undef COSLAM_LOAD
    // x -> fl(x - c) never decreases and x -> fl(c - x) never increases, so
    // the extrema over arcs commute with the differences: brighter arcs
    // fl(max of the arcs' min - c), darker arcs fl(c - min of the arcs' max)
    const float v = fmaxf(key_value(best_arc<true>(r)) - c,
                          c - key_value(best_arc<false>(r)));
    const int gy = y0 - 1 + sy0 + q;
    s[q] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? v : -CUDART_INF_F;
    score[(sy0 + q) * SW + sx] = s[q];
  }
  __syncthreads();

  if (sx == 0 || sx == SW - 1) return;
  // row maxima over the three columns, rows sy0 - 1 .. sy0 + PIX
  float rowmax[PIX + 2];
#pragma unroll
  for (int r = 0; r < PIX + 2; ++r) {
    // a clamped row only feeds score rows 0 and SH - 1, which write nothing
    const int sy = min(max(sy0 - 1 + r, 0), SH - 1);
    const float* srow = &score[sy * SW + sx];
    rowmax[r] = fmaxf(fmaxf(srow[-1], srow[0]), srow[1]);
  }
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int sy = sy0 + q;
    const int gy = y0 - 1 + sy;
    if (sy == 0 || sy == SH - 1 || gy >= h || gx >= w) continue;
    const float pooled = fmaxf(fmaxf(rowmax[q], rowmax[q + 1]), rowmax[q + 2]);
    const bool kept = gy >= mg && gy < h - mg && gx >= mg && gx < w - mg;
    out[gy * w + gx] = (kept && s[q] >= pooled) ? s[q] : 0.0f;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Scores every level in one launch.  imgs / outs: n_levels device pointers
// to contiguous (hs[l], ws[l]) float32 images; outs[l] receives the NMS'd
// score with a border of `margin` pixels set to zero.
extern "C" int coslam_fast_score_nms_pyramid(const void* const* imgs,
                                             void* const* outs, const int* hs,
                                             const int* ws, int n_levels,
                                             int margin, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || margin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid P;
  P.n_levels = n_levels;
  P.margin = margin;
  P.lead_x = ceil_div(margin, OW);
  P.lead_y = ceil_div(margin, OH);
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    // tile columns cover [margin - lead_x * OW, w), rows likewise
    const int tx = P.lead_x + ceil_div(ws[l] > margin ? ws[l] - margin : 0, OW);
    const int ty = P.lead_y + ceil_div(hs[l] > margin ? hs[l] - margin : 0, OH);
    P.lv[l] = Level{static_cast<const float*>(imgs[l]),
                    static_cast<float*>(outs[l]), hs[l], ws[l], tiles, tx};
    tiles += tx * ty;
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) P.lv[l] = P.lv[0];
  fast_score_nms_kernel<<<tiles, NTHREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
