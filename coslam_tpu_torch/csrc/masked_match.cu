// Kernel K2: gated Hamming matcher.  For each query descriptor, the best and
// second-best Hamming distance and the index of the best, over the targets
// that pass validity, the spatial window (both squared radii) and the octave
// gate.
//
// Replaces the Pallas TPU kernel `masked_match` / `_match_kernel` in
// coslam_tpu/ops/pallas_kernels.py.  Plain version: `masked_match_plain` in
// coslam_tpu_torch/ops/cuda_kernels.py.
//
// What bounds it on the H100: the instruction rate on the gate, not bytes (the
// inputs are under 2 MB) and not the distances.  About 99% of the pairs fail
// the window, so a pair is, in the mean, a handful of float instructions
// and the load that feeds them; the 256-bit distance is needed for the few
// that pass.  That is also why the tensor cores are not the tool: the
// one-bit `mma` forms compute every pair's distance, and all but a percent
// of them would be thrown away by the gate.  The TPU kernel made the
// distance a +/-1 bf16 MXU product; here `__popc(a ^ b)` on the passing
// pairs is the native form.  And the tables are mostly empty: a map of 32768
// point slots holds a few hundred points, so most of what could be scanned
// holds nothing.  What the design does:
//
//   * A query's descriptor, location, radius and octave live in registers;
//     targets stream through shared memory in tiles of 128.  A target's gate
//     is one 16-byte record {u, v, r2, octave}, read with one load; an
//     invalid target's r2 is stored as -1, so `d2 <= r2` fails and validity
//     needs no load or branch of its own (NaN coordinates fail every
//     comparison, as in the reference).  The descriptor is two 16-byte
//     loads.
//   * Eight targets are gated per loop step without a branch into a bit
//     mask; the set bits are then handled in increasing index.  Neither the
//     (N, M) distance nor the mask matrix is ever built.
//   * Nothing is touched that holds nothing.  A block first reads the
//     validity bytes of its tiles (16 a thread) into a bit mask and stages
//     and scans only tiles with a valid target.  A warp whose queries are
//     all invalid skips every scan, and a block whose queries are all
//     invalid writes its sentinels and returns before it reads a tile.
//   * Enough threads for the card whatever the shape.  With many queries a
//     thread owns a query (SPLIT = 1).  With few (the reverse pass of the
//     mutual check has 1024) eight neighbouring lanes share a query, each
//     taking every eighth target of a step, and fold their results by
//     shuffles (SPLIT = 8).  On top of that the target tiles are dealt to
//     blockIdx.y round-robin (segment s takes tiles s, s + S, s + 2S, ...),
//     so a table whose valid entries sit at its head still spreads over the
//     segments; there are enough segments for four blocks (32 warps) on
//     every SM, and never more than that needs, so the last block of a
//     query block to finish (a ticket counter in device memory) folds at
//     most a few segments.  There is no second launch.
//   * The next tile is on its way while this one is scanned: descriptors by
//     `cp.async` straight into the other shared-memory buffer, the gate
//     fields through registers (they are packed, and validity folded in, on
//     the way).  One barrier a tile.
//
// Results are those of a scan in increasing target index with
//   if d < best: second = best; best = d; idx = j  elif d < second: second = d
// (pallas_kernels.py:195-205): best is the minimum, idx the lowest index
// that attains it, second the second-smallest distance counted with
// multiplicity.  Each of these is independent of how the targets are dealt
// to lanes and segments, so every fold takes the lower index on equal best.
// The window test uses __fmul_rn / __fadd_rn so that no FMA contraction
// moves a target across the radius.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int TILE = 128;      // targets per shared-memory tile
constexpr int GATE = 8;        // targets gated per loop step
constexpr int CHUNK = 32;      // tiles per validity mask
constexpr int INF_I32 = 1 << 20;
constexpr float NO_RADIUS = 1e18f;   // the reference's "no window" radius
constexpr unsigned FULL = 0xffffffffu;

static_assert(NT == 2 * TILE, "one 16-byte descriptor half per thread");
static_assert(NT == CHUNK * (TILE / 16), "16 validity bytes per thread");

struct Side {                  // one side's arrays; optional ones may be null
  const uint4* desc;           // (n, 8) int32 as two uint4 per row
  const float2* uv;
  const float* r2;             // null: no radius on this side
  const uint8_t* valid;        // 16-byte aligned
  const float* level;          // null: octave 0
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One more target, visited in increasing index.
__device__ __forceinline__ void update(int d, int j, int& best, int& second,
                                       int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = j;
  } else if (d < second) {
    second = d;
  }
}

// Folds the result over another set of targets into (best, second, idx).
__device__ __forceinline__ void merge(int& best, int& second, int& idx,
                                      int b, int s, int i) {
  if (b < best) {
    second = min(best, s);
    best = b;
    idx = i;
  } else {
    if (b == best) idx = min(idx, i);    // both -1 where nothing matched
    second = min(second, b);
  }
}

// Folds the results of the SPLIT neighbouring lanes that share a query;
// every one of them ends with the whole.
template <int SPLIT>
__device__ __forceinline__ void merge_lanes(int& best, int& second,
                                            int& idx) {
#pragma unroll
  for (int off = 1; off < SPLIT; off *= 2) {
    const int b = __shfl_xor_sync(FULL, best, off);
    const int s = __shfl_xor_sync(FULL, second, off);
    const int i = __shfl_xor_sync(FULL, idx, off);
    merge(best, second, idx, b, s, i);
  }
}

struct Staged {                // one target's gate fields on their way
  float2 uv;
  float r2, level;
  bool ok;
};

// Starts the copy of tile `tile`'s descriptors into `desc` (one 16-byte half
// per thread) and loads the gate fields of target tile * TILE + threadIdx.x.
template <bool USE_LEVEL>
__device__ __forceinline__ void fetch(const Side& t, int tile, int m,
                                      uint4* desc, Staged& st) {
  const int tid = threadIdx.x;
  const int base = tile * TILE;
  if (base + (tid >> 1) < m) cp_async16(&desc[tid], &t.desc[2 * base + tid]);
  const int j = base + tid;
  st.uv = make_float2(0.f, 0.f);
  st.r2 = NO_RADIUS;
  st.level = 0.f;
  st.ok = false;
  if (tid < TILE && j < m) {
    st.uv = t.uv[j];
    st.ok = t.valid[j] != 0;
    if (t.r2) st.r2 = t.r2[j];
    if (USE_LEVEL && t.level) st.level = t.level[j];
  }
}

// Packs the staged fields into the tile's record; an invalid target gets a
// negative radius, which no squared distance passes.
__device__ __forceinline__ void commit(const Staged& st, float4* rec) {
  if (threadIdx.x < TILE)
    rec[threadIdx.x] = make_float4(st.uv.x, st.uv.y, st.ok ? st.r2 : -1.0f,
                                   st.level);
}

// Bit i of the result: tile seg + (first + i) * n_seg holds a valid target.
// Every thread reads 16 validity bytes; all threads must call.
__device__ __forceinline__ unsigned tiles_with_targets(
    const uint8_t* valid, int m, int tiles, int seg, int first, int n_seg,
    unsigned* s_mask) {
  const int tid = threadIdx.x;
  __syncthreads();             // the mask of the chunk before has been read
  if (tid == 0) *s_mask = 0;
  __syncthreads();
  const int i = tid >> 3;
  const long long tile = seg + static_cast<long long>(first + i) * n_seg;
  if (tile < tiles) {
    const int o = static_cast<int>(tile) * TILE + (tid & 7) * 16;
    bool any = false;
    if (o + 16 <= m) {
      const uint4 v = *reinterpret_cast<const uint4*>(valid + o);
      any = (v.x | v.y | v.z | v.w) != 0;
    } else {
      for (int j = o; j < m; ++j) any |= valid[j] != 0;
    }
    if (any) atomicOr(s_mask, 1u << i);
  }
  __syncthreads();
  return *s_mask;
}

template <int SPLIT, bool USE_LEVEL>
__global__ void __launch_bounds__(NT) masked_match_kernel(
    Side q, Side t, int n, int m, int n_seg, float level_lo, float level_hi,
    int* __restrict__ best_out, int* __restrict__ second_out,
    int* __restrict__ idx_out, int* __restrict__ part,
    int* __restrict__ tickets) {
  constexpr int QPB = NT / SPLIT;          // queries per block
  constexpr int STEP = GATE * SPLIT;       // targets a query takes per step
  static_assert(TILE % STEP == 0, "whole gate steps per tile");
  __shared__ float4 s_rec[2][TILE];
  __shared__ uint4 s_desc[2][TILE * 2];
  __shared__ unsigned s_mask;
  __shared__ int s_is_last;

  const int tid = threadIdx.x;
  const int sub = tid % SPLIT;             // this lane's share of a step
  const int qi = blockIdx.x * QPB + tid / SPLIT;
  const int seg = blockIdx.y;

  const bool active = qi < n && q.valid[qi] != 0;
  if (__syncthreads_or(active) == 0) {
    // no valid query here: the same holds for every segment of this query
    // block, so segment 0 writes the sentinels and no fold is needed
    if (seg == 0 && sub == 0 && qi < n) {
      best_out[qi] = INF_I32;
      second_out[qi] = INF_I32;
      idx_out[qi] = -1;
    }
    return;
  }
  const bool warp_active = __any_sync(FULL, active);

  uint4 dq0 = make_uint4(0, 0, 0, 0), dq1 = dq0;
  float uq = 0.f, vq = 0.f, r2q = -1.0f, lq = 0.f;   // r2q < 0: matches none
  if (active) {
    dq0 = q.desc[2 * qi];
    dq1 = q.desc[2 * qi + 1];
    const float2 p = q.uv[qi];
    uq = p.x;
    vq = p.y;
    r2q = q.r2 ? q.r2[qi] : NO_RADIUS;
    if (USE_LEVEL && q.level) lq = q.level[qi];
  }

  int best = INF_I32, second = INF_I32, idx = -1;
  const int tiles = (m + TILE - 1) / TILE;
  const int my_tiles = seg < tiles ? (tiles - seg + n_seg - 1) / n_seg : 0;
  Staged st;
  for (int first = 0; first < my_tiles; first += CHUNK) {
    unsigned todo = tiles_with_targets(t.valid, m, tiles, seg, first, n_seg,
                                       &s_mask);
    // Staging of a tile is split in two so that a scan can run in between:
    // `fetch` starts the descriptors' cp.async and loads the gate fields
    // into registers, `commit` packs them into the 16-byte records.
    int buf = 0;
    int cur = -1;
    if (todo) {
      cur = seg + (first + __ffs(todo) - 1) * n_seg;
      todo &= todo - 1;
      fetch<USE_LEVEL>(t, cur, m, s_desc[0], st);
      commit(st, s_rec[0]);
      cp_async_wait_all();
      __syncthreads();
    }
    while (cur >= 0) {
      int next = -1;
      if (todo) {
        next = seg + (first + __ffs(todo) - 1) * n_seg;
        todo &= todo - 1;
        fetch<USE_LEVEL>(t, next, m, s_desc[buf ^ 1], st);
      }
      if (warp_active) {
        const float4* rec = s_rec[buf];
        const uint4* dsc = s_desc[buf];
        const int base = cur * TILE;
#pragma unroll 2
        for (int k0 = sub; k0 < TILE; k0 += STEP) {
          unsigned mask = 0;
#pragma unroll
          for (int g = 0; g < GATE; ++g) {
            const float4 r = rec[k0 + g * SPLIT];
            const float d0 = uq - r.x;
            const float d1 = vq - r.y;
            const float d2 = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
            bool ok = (d2 <= r2q) & (d2 <= r.z);
            if (USE_LEVEL) {
              const float dl = r.w - lq;
              ok = ok & (dl >= level_lo) & (dl <= level_hi);
            }
            mask |= static_cast<unsigned>(ok) << g;
          }
          while (mask) {
            const int k = k0 + (__ffs(mask) - 1) * SPLIT;
            mask &= mask - 1;
            const uint4 a = dsc[2 * k];
            const uint4 b = dsc[2 * k + 1];
            const int d = __popc(dq0.x ^ a.x) + __popc(dq0.y ^ a.y) +
                          __popc(dq0.z ^ a.z) + __popc(dq0.w ^ a.w) +
                          __popc(dq1.x ^ b.x) + __popc(dq1.y ^ b.y) +
                          __popc(dq1.z ^ b.z) + __popc(dq1.w ^ b.w);
            update(d, base + k, best, second, idx);
          }
        }
      }
      // the next tile lands and everyone is done with this one
      if (next >= 0) commit(st, s_rec[buf ^ 1]);
      cp_async_wait_all();
      __syncthreads();
      buf ^= 1;
      cur = next;
    }
  }
  merge_lanes<SPLIT>(best, second, idx);

  if (n_seg == 1) {
    if (sub == 0 && qi < n) {
      best_out[qi] = best;
      second_out[qi] = second;
      idx_out[qi] = idx;
    }
    return;
  }

  // Several segments: leave this one's result in device memory; the block
  // that draws the last ticket of its query block folds them all.
  int* pbest = part;
  int* psecond = part + static_cast<size_t>(n_seg) * n;
  int* pidx = part + 2 * static_cast<size_t>(n_seg) * n;
  if (sub == 0 && qi < n) {
    const size_t o = static_cast<size_t>(seg) * n + qi;
    pbest[o] = best;
    psecond[o] = second;
    pidx[o] = idx;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_is_last = atomicAdd(&tickets[blockIdx.x], 1) == n_seg - 1;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();
  // the lanes of a query share the segments; every load is unconditional,
  // so several are in flight
  best = INF_I32;
  second = INF_I32;
  idx = -1;
  if (qi < n) {
#pragma unroll 4
    for (int s = sub; s < n_seg; s += SPLIT) {
      const size_t o = static_cast<size_t>(s) * n + qi;
      merge(best, second, idx, __ldcg(&pbest[o]), __ldcg(&psecond[o]),
            __ldcg(&pidx[o]));
    }
  }
  merge_lanes<SPLIT>(best, second, idx);
  if (sub == 0 && qi < n) {
    best_out[qi] = best;
    second_out[qi] = second;
    idx_out[qi] = idx;
  }
  if (tid == 0) tickets[blockIdx.x] = 0;   // ready for the next launch
}

// Lanes that share a query: eight where the queries alone would not fill
// the card (every block then stages its own copy of the target tiles, which
// is affordable only while there are few query blocks).
int split_for(int n) { return n <= 2048 ? 8 : 1; }

}  // namespace

// Queries a block takes for an (n, m) problem; the caller keeps
// ceil(n / this) ticket counters, zero before the first launch and left zero
// by every launch.
extern "C" int coslam_masked_match_query_block(int n) {
  return NT / split_for(n);
}

// Number of target segments a launch uses for an (n, m) problem.  Above 1
// the caller passes 3 * n_seg * n ints of scratch.
extern "C" int coslam_masked_match_segments(int n, int m) {
  const int qpb = coslam_masked_match_query_block(n);
  const int q_blocks = (n + qpb - 1) / qpb;
  const int tiles = (m + TILE - 1) / TILE;
  if (q_blocks == 0 || tiles == 0) return 1;
  const int want_blocks = 132 * 4;         // 4 blocks = 32 warps on each SM
  const int want = (want_blocks + q_blocks - 1) / q_blocks;
  const int n_seg = max(1, min(want, tiles));
  const int per_seg = (tiles + n_seg - 1) / n_seg;
  return (tiles + per_seg - 1) / per_seg;  // same depth, no idle segment
}

extern "C" int coslam_masked_match(
    const int* desc_q, const float* uv_q, const float* r2_q,
    const uint8_t* valid_q, const float* level_q, const int* desc_t,
    const float* uv_t, const uint8_t* valid_t, const float* r2_t,
    const float* level_t, int n, int m, int use_level, float level_lo,
    float level_hi, int* best, int* second, int* idx, int* part,
    int* tickets, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Side q{reinterpret_cast<const uint4*>(desc_q),
               reinterpret_cast<const float2*>(uv_q), r2_q, valid_q, level_q};
  const Side t{reinterpret_cast<const uint4*>(desc_t),
               reinterpret_cast<const float2*>(uv_t), r2_t, valid_t, level_t};
  const int n_seg = coslam_masked_match_segments(n, m);
  const int qpb = coslam_masked_match_query_block(n);
  const dim3 grid((n + qpb - 1) / qpb, n_seg);
#define COSLAM_LAUNCH(SPLIT, LEVEL)                                         \
  masked_match_kernel<SPLIT, LEVEL><<<grid, NT, 0, stream>>>(               \
      q, t, n, m, n_seg, level_lo, level_hi, best, second, idx, part, tickets)
  if (split_for(n) == 8) {
    if (use_level) COSLAM_LAUNCH(8, true); else COSLAM_LAUNCH(8, false);
  } else {
    if (use_level) COSLAM_LAUNCH(1, true); else COSLAM_LAUNCH(1, false);
  }
#undef COSLAM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
