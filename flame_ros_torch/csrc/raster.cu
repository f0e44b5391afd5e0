// Triangle-id rasterization kernels for Hopper (sm_90a), plain C ABI.
//
// Every kernel computes the triangle-id buffer [H, W] int32 of the
// engine's per-frame raster: for each pixel, the LOWEST original id of a
// valid triangle whose three CCW edge functions are all >= -1e-3, or -1
// where no triangle covers the pixel. The wrappers, the plain PyTorch
// versions and the build live in flame_ros_torch/ops/raster_cuda.py.
//
// raster_v4 replaces the TPU kernel rasterize_tri_ids_pallas_v4 /
// _kernel_v4 (flame_ros_tpu/ops/raster_pallas.py:350-482). The wrapper
// sorts triangles on the device by (class, ymin) and builds the sorted
// slab C [11, T] (9 edge coefficients, validity, original id). A tile of
// `row_tile` image rows needs exactly the short triangles at sorted
// positions [lo_pos, hi_pos) plus the long ones at [n_short, n_live). The
// TPU kernel gathers those into a slab of static size (384 + 128 columns)
// and falls back to v2 when a frame needs more; here each block walks both
// ranges whatever their length, so v4 has no budget and no fallback.
//
// raster_v2 replaces rasterize_tri_ids_pallas / _kernel
// (flame_ros_tpu/ops/raster_pallas.py:27-147). Each block walks its
// tile's contiguous triangle range [lo * tri_block, hi * tri_block) in
// original order, so a pixel's first hit is its answer.
//
// raster_v3 replaces rasterize_tri_ids_pallas_v3 / _kernel_v3
// (flame_ros_tpu/ops/raster_pallas.py:180-315). The wrapper sorts as for
// v4, in blocks of tri_block columns. A tile needs the short blocks from
// lo_blk (nblk_s of them) and the shared long blocks from long_lo (n_lblk
// of them); the TPU kernel walks at most s_blocks + l_blocks of them as a
// grid axis of static length and falls back to v2 when a frame needs
// more. Here each block walks all of them, so v3 has no budget and no
// fallback either. Its blocks can hold invalid (class-2) columns, which
// the cull drops; a column in both a short and a long block is tested
// twice, which the minimum does not see.
//
// All three share one design (raster_tile below):
// - Staging: candidates stream through shared memory in chunks of CH,
//   double-buffered with cp.async (chunk k + 1 is in flight while chunk k
//   is tested); coefficient r of candidate k sits at row r, column k, so
//   reads are conflict-free per lane and broadcasts per candidate.
// - Culling, never deciding coverage: when a chunk lands, each candidate
//   is tested once against the block's pixel rectangle, and the survivors
//   are compacted in order (warp ballot + prefix popcount). In the test
//   loop each warp tests 32 survivors at a time against its own 2 x 64
//   pixel span, one per lane, and walks the ballot's bits in ascending
//   order: a warp-uniform loop over the candidates that may touch it.
//   A candidate is rejected only when the box of the pixels that the f32
//   inside test can accept for it (region_box, computed once per
//   candidate as it is staged) misses the rectangle. That box is the
//   triangle cut out by its edge lines moved out by 1e-3 and a rounding
//   guard, so it holds for slivers and near-degenerate triangles too,
//   whose -1e-3 band can reach pixels far outside their bounding box.
//   Testing each edge at the rectangle's corner that maximizes it as
//   well (the other separating axes of a triangle and a rectangle) was
//   measured slower: it rejects little that the box does not.
// - Pixels: a thread owns PIX consecutive pixels of one row; a warp owns
//   2 rows x 64 pixels; a block owns the tile. The per-row part of an
//   edge function is computed once per candidate per thread.
// - Two switches, independent of each other: the reduction (v4 and v3
//   keep the minimum original id, in any candidate order; v2's ids
//   ascend, so it takes the first hit and stops once every pixel of the
//   block has one) and the edge evaluation order (below). v3 is v4's
//   reduction with v2's order.
//
// What bounds them on this card: neither arithmetic nor bytes. The
// inside tests the data needs — one per (pixel, valid triangle) pair whose
// pixel lies in the triangle's bounding box, about 0.7 M on the engine's
// VGA frames, at 6 (v4) or 9 (v2, v3) f32 instructions — take the card
// ~0.2 us, the 1.2 MB output and ~0.2 MB slab ~0.4 us. What the kernels
// wait on is latency: each block runs its chunks one after another (load,
// cull, compaction, tests, three barriers each). Hence the cull, which
// trims a chunk to the candidates that matter, and the next chunk's load
// in flight during the current one's work. v3 walks whole blocks, so it
// stages more chunks than v4's exact ranges (staging bandwidth, not
// tests: the cull drops what the block quantization adds).
// chip_smoke.py prints each kernel's time beside that bound.
//
// Exactness: the id buffer must equal the plain PyTorch version bit for
// bit, so every edge function is evaluated with explicit round-to-nearest
// multiplies and adds (no FMA contraction), in the JAX kernels' order:
// x*a + (y*b + c) for v4, (x*a + y*b) + c for v2 and v3. Hoisting the
// per-row term y*b + c (v4) or y*b (v2, v3) changes no rounding.
//
// raster_v4_batched runs v4 over S images in one launch: the TPU kernel
// under jax.vmap (flame_ros_tpu/parallel/multi_stream.py vmaps the engine
// step over a stream axis, so its pallas_call becomes one batched call).
// A grid of (n_tiles, S); blockIdx.y picks one image's slab, ranges and
// output, and its blocks run v4's tile routine unchanged.
//
// Each kernel adds 1 to work[k] (k = 0 for v4, 1 for v2, 2 for v3, 3 for
// batched v4) once per launch, so a run can show which kernel did the
// raster work; batched v4 also adds the number of images to work[4].

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float EPS = -1e-3f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int PIX = 4;                    // consecutive pixels per thread
constexpr int WARP_ROWS = 2;              // a warp owns 2 rows ...
constexpr int WARP_COLS = 32 / WARP_ROWS * PIX;   // ... of 64 pixels
constexpr int CH = 256;                   // candidates staged per chunk
constexpr int GROUPS = CH / 32;
constexpr float GUARD = 1e-6f;            // ~16 f32 ulps, relative

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pixel rectangle [x0, x1] x [y0, y1]; a block's or a warp's pixels have
// non-negative coordinates.
struct Rect {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ bool overlaps(Rect a, Rect b) {
  return a.x1 >= b.x0 && a.x0 <= b.x1 && a.y1 >= b.y0 && a.y0 <= b.y1;
}

// a*d - b*c to within 2 f32 ulps, so with its exact sign (Kahan: the
// rounding error of b*c recovered with an FMA).
__device__ __forceinline__ float det2(float a, float b, float c, float d) {
  const float w = __fmul_rn(b, c);
  const float err = __fmaf_rn(-b, c, w);
  return __fadd_rn(__fmaf_rn(a, d, -w), err);
}

// A box holding every pixel (x, y), 0 <= x <= sx, 0 <= y <= sy, that the
// f32 inside test can accept for the triangle with edge coefficients
// e[9]. Those pixels satisfy, exactly, E_k >= EPS - d_k for each edge k,
// d_k = GUARD (|a| sx + |b| sy + |c|) bounding the test's rounding. When
// the three edge normals positively span the plane (the pairwise
// determinants share a strict sign) that set is the triangle whose
// corners are the pairwise intersections of the lines E_k = EPS - d_k;
// they are found with compensated 2 x 2 determinants and the box is
// widened by 1e-3 px and ~170 ulps of the terms, far more than their
// rounding. Otherwise (a degenerate triangle, or coefficients that are
// not finite) the set may be unbounded and the box is the whole plane.
// For a sliver the box reaches as far beyond the triangle's own bounding
// box as its -1e-3 band does.
__device__ __forceinline__ Rect region_box(const float (&e)[9], float sx,
                                           float sy) {
  const Rect all = {-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                    CUDART_INF_F};
  float a[3], b[3], r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = e[3 * k];
    b[k] = e[3 * k + 1];
    const float c = e[3 * k + 2];
    const float s = fabsf(a[k]) * sx + fabsf(b[k]) * sy + fabsf(c);
    if (!(s <= FLT_MAX)) return all;
    r[k] = (EPS - GUARD * s) - c;    // the line a x + b y = r
  }
  float x0 = CUDART_INF_F, x1 = -CUDART_INF_F, y0 = CUDART_INF_F,
        y1 = -CUDART_INF_F, err = 0.0f;
  int pos = 0, neg = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const float det = det2(a[i], b[i], a[j], b[j]);   // a_i b_j - b_i a_j
    pos += det > 0.0f;
    neg += det < 0.0f;
    const float inv = 1.0f / det;
    const float vx = det2(r[i], b[i], r[j], b[j]) * inv;
    const float vy = det2(a[i], r[i], a[j], r[j]) * inv;
    err = fmaxf(err, (fabsf(r[i] * b[j]) + fabsf(r[j] * b[i])
                      + fabsf(a[i] * r[j]) + fabsf(a[j] * r[i]))
                     * fabsf(inv) + fabsf(vx) + fabsf(vy));
    x0 = fminf(x0, vx);
    x1 = fmaxf(x1, vx);
    y0 = fminf(y0, vy);
    y1 = fmaxf(y1, vy);
  }
  // A corner can be NaN only where err is not finite.
  if ((pos != 3 && neg != 3) || !(err <= FLT_MAX)) return all;
  const float m = 1e-3f + 1e-5f * err;
  const Rect box = {x0 - m, x1 + m, y0 - m, y1 + m};
  return (box.x0 <= box.x1 && box.y0 <= box.y1) ? box : all;
}

// One tile of `row_tile` rows. Candidates j in [0, n) sit at column
// src(j) of C ([rows, T] row-major): edge coefficients in rows 0-8, then
// what the list's Src says it needs. With Src::kValidity the list may hold
// invalid columns: row 9 (validity) is staged and an invalid column fails
// the cull. With Src::kIdRow a candidate's id is its original id in row
// 10; otherwise it is its column. FIRST_HIT: a pixel takes its first hit
// and the block stops once every pixel has one (the ids must ascend);
// otherwise the minimum id wins. ROW_SPLIT: x*a + (y*b + c); otherwise
// (x*a + y*b) + c. A candidate survives a cull against a rectangle when
// its region_box overlaps the rectangle.
template <bool FIRST_HIT, bool ROW_SPLIT, typename Src>
__device__ __forceinline__ void raster_tile(const float* __restrict__ C,
                                            int T, int n, Src src,
                                            int* __restrict__ out, int width,
                                            int row_tile) {
  __shared__ float raw[2][11][CH];   // staged chunks (rows 9-10 as in C)
  __shared__ float bx[4][CH];        // the staged chunk's region boxes
  __shared__ float cf[13][CH];       // survivors: coefficients and boxes
  __shared__ int cid[CH];            // and ids
  __shared__ unsigned gmask[GROUPS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wx_n = (width + WARP_COLS - 1) / WARP_COLS;
  const int wy = warp / wx_n, wx = warp % wx_n;
  const int y_tile = tile * row_tile;
  const int row = wy * WARP_ROWS + (lane >> 4);   // row within the tile
  const int col0 = wx * WARP_COLS + (lane & 15) * PIX;
  const float y = (float)(y_tile + row);
  const int big = T + 1;

  int best[PIX];
  bool done = true;                 // every pixel of this thread resolved
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const bool ok = row < row_tile && col0 + j < width;
    best[j] = ok ? big : -1;        // slots outside the tile start resolved
    done = done && !ok;
  }
  const Rect tile_rect = {0.0f, (float)(width - 1), (float)y_tile,
                          (float)(y_tile + row_tile - 1)};
  const int wy0 = y_tile + wy * WARP_ROWS;
  const Rect warp_rect = {
      (float)(wx * WARP_COLS),
      (float)min(wx * WARP_COLS + WARP_COLS - 1, width - 1), (float)wy0,
      (float)min(wy0 + WARP_ROWS - 1, y_tile + row_tile - 1)};

  auto stage = [&](int chunk, int buf) {
    for (int k = threadIdx.x; k < CH; k += blockDim.x) {
      const int j = chunk * CH + k;
      if (j < n) {
        const float* p = C + src(j);
#pragma unroll
        for (int r = 0; r < 9; ++r) cp_async4(&raw[buf][r][k], p + r * T);
        if constexpr (Src::kValidity) cp_async4(&raw[buf][9][k], p + 9 * T);
        if constexpr (Src::kIdRow) cp_async4(&raw[buf][10][k], p + 10 * T);
      }
    }
    cp_async_commit();
  };

  const int n_chunks = (n + CH - 1) / CH;
  if (n_chunks > 0) stage(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    // raw[buf ^ 1] was last read by the previous chunk's cull, which
    // ended before that chunk's second barrier.
    if (ch + 1 < n_chunks) {
      stage(ch + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // The chunk is visible to all, and the previous test loop is over
    // (cf and cid may be rewritten). First hit: leave once all are hit.
    if (__syncthreads_and(FIRST_HIT && done)) break;

    const int base = ch * CH;
    const int nk = min(CH, n - base);
    for (int g = warp; g < GROUPS; g += nwarps) {
      const int k = g * 32 + lane;
      bool keep = false;
      if (k < nk && (!Src::kValidity || raw[buf][9][k] > 0.0f)) {
        float e[9];
#pragma unroll
        for (int r = 0; r < 9; ++r) e[r] = raw[buf][r][k];
        const Rect box = region_box(e, tile_rect.x1, tile_rect.y1);
        bx[0][k] = box.x0;
        bx[1][k] = box.x1;
        bx[2][k] = box.y0;
        bx[3][k] = box.y1;
        keep = overlaps(box, tile_rect);
      }
      const unsigned m = __ballot_sync(FULL, keep);
      if (lane == 0) gmask[g] = m;
    }
    __syncthreads();
    for (int g = warp; g < GROUPS; g += nwarps) {
      const unsigned m = gmask[g];
      if (m >> lane & 1u) {
        int dst = __popc(m & ((1u << lane) - 1u));
        for (int h = 0; h < g; ++h) dst += __popc(gmask[h]);
        const int k = g * 32 + lane;
#pragma unroll
        for (int r = 0; r < 9; ++r) cf[r][dst] = raw[buf][r][k];
#pragma unroll
        for (int r = 0; r < 4; ++r) cf[9 + r][dst] = bx[r][k];
        if constexpr (Src::kIdRow) {
          cid[dst] = (int)raw[buf][10][k];
        } else {
          cid[dst] = src(base + k);
        }
      }
    }
    int nc = 0;
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) nc += __popc(gmask[h]);
    __syncthreads();

    bool warp_done = FIRST_HIT && __all_sync(FULL, done);
    for (int s0 = 0; s0 < nc && !warp_done; s0 += 32) {
      bool keep = false;
      if (s0 + lane < nc) {
        const Rect box = {cf[9][s0 + lane], cf[10][s0 + lane],
                          cf[11][s0 + lane], cf[12][s0 + lane]};
        keep = overlaps(box, warp_rect);
      }
      unsigned m = __ballot_sync(FULL, keep);
      while (m) {                    // warp-uniform, ascending candidates
        const int k = s0 + __ffs(m) - 1;
        m &= m - 1u;
        const float a0 = cf[0][k], b0 = cf[1][k], c0 = cf[2][k];
        const float a1 = cf[3][k], b1 = cf[4][k], c1 = cf[5][k];
        const float a2 = cf[6][k], b2 = cf[7][k], c2 = cf[8][k];
        const int id = cid[k];
        // The per-row terms: y*b + c (row split) or y*b.
        const float d0 = ROW_SPLIT ? __fadd_rn(__fmul_rn(y, b0), c0)
                                   : __fmul_rn(y, b0);
        const float d1 = ROW_SPLIT ? __fadd_rn(__fmul_rn(y, b1), c1)
                                   : __fmul_rn(y, b1);
        const float d2 = ROW_SPLIT ? __fadd_rn(__fmul_rn(y, b2), c2)
                                   : __fmul_rn(y, b2);
        bool all = true;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          const float x = (float)(col0 + j);
          float e0, e1, e2;
          if (ROW_SPLIT) {
            e0 = __fadd_rn(__fmul_rn(x, a0), d0);
            e1 = __fadd_rn(__fmul_rn(x, a1), d1);
            e2 = __fadd_rn(__fmul_rn(x, a2), d2);
          } else {
            e0 = __fadd_rn(__fadd_rn(__fmul_rn(x, a0), d0), c0);
            e1 = __fadd_rn(__fadd_rn(__fmul_rn(x, a1), d1), c1);
            e2 = __fadd_rn(__fadd_rn(__fmul_rn(x, a2), d2), c2);
          }
          const bool in = (e0 >= EPS) & (e1 >= EPS) & (e2 >= EPS);
          if (FIRST_HIT) {
            if (in && best[j] == big) best[j] = id;
            all = all && best[j] != big;
          } else {
            if (in) best[j] = min(best[j], id);
          }
        }
        if (FIRST_HIT) {
          done = all;
          if (__all_sync(FULL, done)) {
            warp_done = true;
            break;
          }
        }
      }
    }
  }
  // A first-hit block that left early has copies in flight.
  cp_async_wait<0>();

  if (row < row_tile) {
    int* o = out + (size_t)(y_tile + row) * width + col0;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (col0 + j < width) o[j] = best[j] < big ? best[j] : -1;
    }
  }
}

// The v4 candidate list of one tile: sorted positions [lo, lo + n_s),
// then [n_short, n_live); live columns only.
struct V4Src {
  static constexpr bool kValidity = false, kIdRow = true;
  int lo, n_s, n_short;
  __device__ int operator()(int j) const {
    return j < n_s ? lo + j : n_short + (j - n_s);
  }
};

// The v2 candidate list of one tile: columns [t_lo, t_hi), original order.
struct V2Src {
  static constexpr bool kValidity = true, kIdRow = false;
  int t_lo;
  __device__ int operator()(int j) const { return t_lo + j; }
};

// The v3 candidate list of one tile: the n_s short blocks from lo, then
// the shared long blocks from long_lo, each block index clipped to
// [0, n_blocks) as the Pallas index map does, expanded to its B columns.
struct V3Src {
  static constexpr bool kValidity = true, kIdRow = true;
  int lo, n_s, long_lo, B, n_blocks;
  __device__ int operator()(int j) const {
    const int k = j / B;
    const int blk = k < n_s ? lo + k : long_lo + (k - n_s);
    return min(max(blk, 0), n_blocks - 1) * B + (j - k * B);
  }
};

// One v4 tile (blockIdx.x) of one image. C: [11, T] row-major, columns
// in sorted order. lo_pos, hi_pos: [n_tiles]. counts: [2] = (n_short,
// n_live). out: [H * W].
__device__ __forceinline__ void v4_tile(const float* __restrict__ C, int T,
                                        const int* __restrict__ lo_pos,
                                        const int* __restrict__ hi_pos,
                                        const int* __restrict__ counts,
                                        int* __restrict__ out, int width,
                                        int row_tile) {
  const int tile = blockIdx.x;
  const int lo = lo_pos[tile];
  const int n_s = max(hi_pos[tile] - lo, 0);
  const int n_short = counts[0];
  const int n_long = max(counts[1] - n_short, 0);
  raster_tile<false, true>(C, T, n_s + n_long, V4Src{lo, n_s, n_short}, out,
                           width, row_tile);
}

__global__ void raster_v4_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ lo_pos,
                                 const int* __restrict__ hi_pos,
                                 const int* __restrict__ counts,
                                 int* __restrict__ out, int width,
                                 int row_tile, int* __restrict__ work) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(work + 0, 1);
  v4_tile(C, T, lo_pos, hi_pos, counts, out, width, row_tile);
}

// v4 over a batch of S images in one launch (the TPU kernel under
// jax.vmap): a grid of (n_tiles, S), blockIdx.y selecting one image's
// slab C [S, 11, T], lo_pos / hi_pos [S, n_tiles], counts [S, 2] and
// output out [S, H * W]. Each image's blocks do exactly what
// raster_v4_kernel's do for it alone. work[3] counts launches, work[4]
// the images they covered.
__global__ void raster_v4_batched_kernel(const float* __restrict__ C, int T,
                                         const int* __restrict__ lo_pos,
                                         const int* __restrict__ hi_pos,
                                         const int* __restrict__ counts,
                                         int* __restrict__ out, int height,
                                         int width, int row_tile,
                                         int* __restrict__ work) {
  const int s = blockIdx.y;
  const int n_tiles = gridDim.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (s == 0) atomicAdd(work + 3, 1);
    atomicAdd(work + 4, 1);
  }
  v4_tile(C + (size_t)s * 11 * T, T, lo_pos + (size_t)s * n_tiles,
          hi_pos + (size_t)s * n_tiles, counts + 2 * s,
          out + (size_t)s * height * width, width, row_tile);
}

// C: [10, T] row-major (9 edge coefficients, validity) in original order.
// bounds: [n_tiles, 2] int32 block range [lo, hi).
__global__ void raster_v2_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ bounds,
                                 int tri_block, int* __restrict__ out,
                                 int width, int row_tile,
                                 int* __restrict__ work) {
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 1, 1);
  const int t_lo = bounds[2 * tile] * tri_block;
  const int t_hi = min(bounds[2 * tile + 1] * tri_block, T);
  raster_tile<true, false>(C, T, max(t_hi - t_lo, 0), V2Src{t_lo}, out,
                           width, row_tile);
}

// C: [11, T] row-major (9 edge coefficients, validity, original id as
// f32), columns in sorted order, in blocks of tri_block. lo_blk, nblk_s:
// [n_tiles]. long2: [2] = (long_lo, n_lblk). out: [H * W].
__global__ void raster_v3_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ lo_blk,
                                 const int* __restrict__ nblk_s,
                                 const int* __restrict__ long2,
                                 int tri_block, int* __restrict__ out,
                                 int width, int row_tile,
                                 int* __restrict__ work) {
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 2, 1);
  const int n_s = max(nblk_s[tile], 0);
  const int n_l = max(long2[1], 0);
  raster_tile<false, false>(
      C, T, (n_s + n_l) * tri_block,
      V3Src{lo_blk[tile], n_s, long2[0], tri_block, T / tri_block}, out,
      width, row_tile);
}

// Threads of a block: one warp per 2 x 64 pixels of the tile.
int tile_threads(int row_tile, int width) {
  return 32 * ((row_tile + WARP_ROWS - 1) / WARP_ROWS)
       * ((width + WARP_COLS - 1) / WARP_COLS);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

int raster_v4_launch(const float* C, int T, const int* lo_pos,
                     const int* hi_pos, const int* counts, int* out,
                     int height, int width, int row_tile, int* work,
                     void* stream) {
  const int threads = tile_threads(row_tile, width);
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  raster_v4_kernel<<<height / row_tile, threads, 0, (cudaStream_t)stream>>>(
      C, T, lo_pos, hi_pos, counts, out, width, row_tile, work);
  return (int)cudaGetLastError();
}

int raster_v4_batched_launch(const float* C, int S, int T,
                             const int* lo_pos, const int* hi_pos,
                             const int* counts, int* out, int height,
                             int width, int row_tile, int* work,
                             void* stream) {
  const int threads = tile_threads(row_tile, width);
  if (threads > 1024 || S < 1 || S > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(height / row_tile, S);
  raster_v4_batched_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      C, T, lo_pos, hi_pos, counts, out, height, width, row_tile, work);
  return (int)cudaGetLastError();
}

int raster_v2_launch(const float* C, int T, const int* bounds,
                     int tri_block, int* out, int height, int width,
                     int row_tile, int* work, void* stream) {
  const int threads = tile_threads(row_tile, width);
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  raster_v2_kernel<<<height / row_tile, threads, 0, (cudaStream_t)stream>>>(
      C, T, bounds, tri_block, out, width, row_tile, work);
  return (int)cudaGetLastError();
}

int raster_v3_launch(const float* C, int T, const int* lo_blk,
                     const int* nblk_s, const int* long2, int tri_block,
                     int* out, int height, int width, int row_tile,
                     int* work, void* stream) {
  const int threads = tile_threads(row_tile, width);
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  raster_v3_kernel<<<height / row_tile, threads, 0, (cudaStream_t)stream>>>(
      C, T, lo_blk, nblk_s, long2, tri_block, out, width, row_tile, work);
  return (int)cudaGetLastError();
}

}  // extern "C"
