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
// Both share one design (raster_tile below):
//
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
//
// raster_v3 replaces rasterize_tri_ids_pallas_v3 / _kernel_v3
// (flame_ros_tpu/ops/raster_pallas.py:180-315). The wrapper sorts as for
// v4. A tile needs at most s_blocks blocks of tri_block short triangles
// from lo_blk, plus at most l_blocks shared blocks of long ones; the TPU
// kernel walks them as a grid axis of s_blocks + l_blocks steps with the
// output tile as the accumulator. Here one block per tile loops over
// those steps itself, skips the inactive ones, stages each active block in
// shared memory (11 x 128 floats, 5.6 KB) and keeps a running minimum of
// original ids per pixel in registers.
//
// What bounds them on this card: neither arithmetic nor bytes. The
// inside tests the data needs — one per (pixel, valid triangle) pair whose
// pixel lies in the triangle's bounding box, about 0.7 M on the engine's
// VGA frames, at 6 (v4) or 9 (v2, v3) f32 instructions — take the card
// ~0.2 us, the 1.2 MB output and ~0.2 MB slab ~0.4 us. What the kernels
// wait on is latency: each block runs its chunks one after another (load,
// cull, compaction, tests, three barriers each). Hence the cull, which
// trims a chunk to the candidates that matter, and the next chunk's load
// in flight during the current one's work. chip_smoke.py prints each
// kernel's time beside that bound.
//
// Exactness: the id buffer must equal the plain PyTorch version bit for
// bit, so every edge function is evaluated with explicit round-to-nearest
// multiplies and adds (no FMA contraction), in the JAX kernels' order:
// x*a + (y*b + c) for v4, (x*a + y*b) + c for v2 and v3. Hoisting the
// per-row term y*b + c (v4) or y*b (v2) changes no rounding.
//
// The v3 -> v2 fallback needs no host sync: `fits` is a device flag.
// raster_v3 returns at once when it is false; raster_v2 launched with
// skip_if = fits returns at once when it is true. Each kernel adds 1 to
// work[k] (k = 0 for v4, 1 for v2, 2 for v3) when it does the work, so a
// run can show which one did.

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float EPS = -1e-3f;
constexpr unsigned FULL = 0xffffffffu;

// raster_v4 / raster_v2.
constexpr int PIX = 4;                    // consecutive pixels per thread
constexpr int WARP_ROWS = 2;              // a warp owns 2 rows ...
constexpr int WARP_COLS = 32 / WARP_ROWS * PIX;   // ... of 64 pixels
constexpr int CH = 256;                   // candidates staged per chunk
constexpr int GROUPS = CH / 32;
constexpr float GUARD = 1e-6f;            // ~16 f32 ulps, relative

// raster_v3.
constexpr int PIX3 = 4;
constexpr int CHUNK3 = 128;

__device__ __forceinline__ float edge_v2(float x, float y, float a, float b,
                                         float c) {
  // (x*a + y*b) + c, rounded op by op.
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

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
// src(j) of C ([rows, T] row-major): V4 reads coefficient rows 0-8 and the
// original id (row 10), V2 rows 0-8 and the validity (row 9), its id
// being the column. V4 keeps the minimum id per pixel; V2 takes the
// first hit (ids ascend) and stops once every pixel of the block has one.
// A candidate survives a cull against a rectangle when its region_box
// overlaps the rectangle.
template <bool V4, typename Src>
__device__ __forceinline__ void raster_tile(const float* __restrict__ C,
                                            int T, int n, Src src,
                                            int* __restrict__ out, int width,
                                            int row_tile) {
  __shared__ float raw[2][10][CH];   // staged chunks (row 9: id or valid)
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

  const int id_row = V4 ? 10 : 9;
  auto stage = [&](int chunk, int buf) {
    for (int k = threadIdx.x; k < CH; k += blockDim.x) {
      const int j = chunk * CH + k;
      if (j < n) {
        const float* p = C + src(j);
#pragma unroll
        for (int r = 0; r < 9; ++r) cp_async4(&raw[buf][r][k], p + r * T);
        cp_async4(&raw[buf][9][k], p + id_row * T);
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
    // (cf and cid may be rewritten). v2: leave once all pixels are hit.
    if (__syncthreads_and(!V4 && done)) break;

    const int base = ch * CH;
    const int nk = min(CH, n - base);
    for (int g = warp; g < GROUPS; g += nwarps) {
      const int k = g * 32 + lane;
      bool keep = false;
      if (k < nk && (V4 || raw[buf][9][k] > 0.0f)) {
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
        cid[dst] = V4 ? (int)raw[buf][9][k] : src(base + k);
      }
    }
    int nc = 0;
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) nc += __popc(gmask[h]);
    __syncthreads();

    bool warp_done = !V4 && __all_sync(FULL, done);
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
        // The per-row terms: y*b + c (v4) or y*b (v2).
        const float d0 = V4 ? __fadd_rn(__fmul_rn(y, b0), c0)
                            : __fmul_rn(y, b0);
        const float d1 = V4 ? __fadd_rn(__fmul_rn(y, b1), c1)
                            : __fmul_rn(y, b1);
        const float d2 = V4 ? __fadd_rn(__fmul_rn(y, b2), c2)
                            : __fmul_rn(y, b2);
        bool all = true;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          const float x = (float)(col0 + j);
          float e0, e1, e2;
          if (V4) {
            e0 = __fadd_rn(__fmul_rn(x, a0), d0);
            e1 = __fadd_rn(__fmul_rn(x, a1), d1);
            e2 = __fadd_rn(__fmul_rn(x, a2), d2);
          } else {
            e0 = __fadd_rn(__fadd_rn(__fmul_rn(x, a0), d0), c0);
            e1 = __fadd_rn(__fadd_rn(__fmul_rn(x, a1), d1), c1);
            e2 = __fadd_rn(__fadd_rn(__fmul_rn(x, a2), d2), c2);
          }
          const bool in = (e0 >= EPS) & (e1 >= EPS) & (e2 >= EPS);
          if (V4) {
            if (in) best[j] = min(best[j], id);
          } else {
            if (in && best[j] == big) best[j] = id;
            all = all && best[j] != big;
          }
        }
        if (!V4) {
          done = all;
          if (__all_sync(FULL, done)) {
            warp_done = true;
            break;
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // a v2 block that left early has copies in flight

  if (row < row_tile) {
    int* o = out + (size_t)(y_tile + row) * width + col0;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (col0 + j < width) o[j] = best[j] < big ? best[j] : -1;
    }
  }
}

// The v4 candidate list of one tile: sorted positions [lo, lo + n_s),
// then [n_short, n_live).
struct V4Src {
  int lo, n_s, n_short;
  __device__ int operator()(int j) const {
    return j < n_s ? lo + j : n_short + (j - n_s);
  }
};

// The v2 candidate list of one tile: columns [t_lo, t_hi).
struct V2Src {
  int t_lo;
  __device__ int operator()(int j) const { return t_lo + j; }
};

// C: [11, T] row-major, columns in sorted order. lo_pos, hi_pos:
// [n_tiles]. counts: [2] = (n_short, n_live). out: [H * W].
__global__ void raster_v4_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ lo_pos,
                                 const int* __restrict__ hi_pos,
                                 const int* __restrict__ counts,
                                 int* __restrict__ out, int width,
                                 int row_tile, int* __restrict__ work) {
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 0, 1);
  const int lo = lo_pos[tile];
  const int n_s = max(hi_pos[tile] - lo, 0);
  const int n_short = counts[0];
  const int n_long = max(counts[1] - n_short, 0);
  raster_tile<true>(C, T, n_s + n_long, V4Src{lo, n_s, n_short}, out, width,
                    row_tile);
}

// C: [10, T] row-major (9 edge coefficients, validity) in original order.
// bounds: [n_tiles, 2] int32 block range [lo, hi). skip_if: device bool
// or null.
__global__ void raster_v2_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ bounds,
                                 int tri_block,
                                 const bool* __restrict__ skip_if,
                                 int* __restrict__ out, int width,
                                 int row_tile, int* __restrict__ work) {
  if (skip_if != nullptr && *skip_if) return;
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 1, 1);
  const int t_lo = bounds[2 * tile] * tri_block;
  const int t_hi = min(bounds[2 * tile + 1] * tri_block, T);
  raster_tile<false>(C, T, max(t_hi - t_lo, 0), V2Src{t_lo}, out, width,
                     row_tile);
}

// C: [11, T] row-major (9 edge coefficients, validity, original id as
// f32), columns in sorted order. lo_blk, nblk_s: [n_tiles]. long2: [2] =
// (long_lo, n_lblk). fits: device bool. out: [H * W].
__global__ void raster_v3_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ lo_blk,
                                 const int* __restrict__ nblk_s,
                                 const int* __restrict__ long2,
                                 const bool* __restrict__ fits,
                                 int* __restrict__ out, int width,
                                 int px_tile, int tri_block, int s_blocks,
                                 int l_blocks, int* __restrict__ work) {
  if (!*fits) return;
  __shared__ float sm[11 * CHUNK3];
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 2, 1);
  const int n_blocks = T / tri_block;
  const int lo = lo_blk[tile];
  const int n_s = nblk_s[tile];
  const int long_lo = long2[0];
  const int n_l = long2[1];
  const int big = T + 1;
  float px[PIX3], py[PIX3];
  int best[PIX3];
#pragma unroll
  for (int j = 0; j < PIX3; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int idx = tile * px_tile + (p < px_tile ? p : 0);
    px[j] = (float)(idx % width);
    py[j] = (float)(idx / width);
    best[j] = big;
  }
  for (int k = 0; k < s_blocks + l_blocks; ++k) {
    // The same for every thread of the block, so the barriers below are
    // reached by all or by none.
    const bool active = k < s_blocks ? k < n_s : k - s_blocks < n_l;
    if (!active) continue;
    int blk = k < s_blocks ? lo + k : long_lo + (k - s_blocks);
    blk = min(max(blk, 0), n_blocks - 1);
    for (int off = 0; off < tri_block; off += CHUNK3) {
      const int n = min(CHUNK3, tri_block - off);
      const int base = blk * tri_block + off;
      __syncthreads();   // the previous pass is done with the staged chunk
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
#pragma unroll
        for (int r = 0; r < 11; ++r) sm[r * CHUNK3 + c] = C[r * T + base + c];
      }
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        if (!(sm[9 * CHUNK3 + c] > 0.0f)) continue;
        const float a0 = sm[0 * CHUNK3 + c], b0 = sm[1 * CHUNK3 + c];
        const float c0 = sm[2 * CHUNK3 + c], a1 = sm[3 * CHUNK3 + c];
        const float b1 = sm[4 * CHUNK3 + c], c1 = sm[5 * CHUNK3 + c];
        const float a2 = sm[6 * CHUNK3 + c], b2 = sm[7 * CHUNK3 + c];
        const float c2 = sm[8 * CHUNK3 + c];
        const int id = (int)sm[10 * CHUNK3 + c];
#pragma unroll
        for (int j = 0; j < PIX3; ++j) {
          const bool in = (edge_v2(px[j], py[j], a0, b0, c0) >= EPS)
                        & (edge_v2(px[j], py[j], a1, b1, c1) >= EPS)
                        & (edge_v2(px[j], py[j], a2, b2, c2) >= EPS);
          if (in) best[j] = min(best[j], id);
        }
      }
    }
  }
  int* o = out + (size_t)tile * px_tile;
#pragma unroll
  for (int j = 0; j < PIX3; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < px_tile) o[p] = best[j] > T ? -1 : best[j];
  }
}

// Threads of a v4 / v2 block: one warp per 2 x 64 pixels of the tile.
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

int raster_v2_launch(const float* C, int T, const int* bounds,
                     int tri_block, const bool* skip_if, int* out,
                     int height, int width, int row_tile, int* work,
                     void* stream) {
  const int threads = tile_threads(row_tile, width);
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  raster_v2_kernel<<<height / row_tile, threads, 0, (cudaStream_t)stream>>>(
      C, T, bounds, tri_block, skip_if, out, width, row_tile, work);
  return (int)cudaGetLastError();
}

int raster_v3_launch(const float* C, int T, const int* lo_blk,
                     const int* nblk_s, const int* long2, const bool* fits,
                     int* out, int height, int width, int row_tile,
                     int tri_block, int s_blocks, int l_blocks, int* work,
                     void* stream) {
  const int px_tile = row_tile * width;
  const int n_tiles = (height * width) / px_tile;
  int threads = (px_tile + PIX3 - 1) / PIX3;
  threads = ((threads + 31) / 32) * 32;
  raster_v3_kernel<<<n_tiles, threads, 0, (cudaStream_t)stream>>>(
      C, T, lo_blk, nblk_s, long2, fits, out, width, px_tile, tri_block,
      s_blocks, l_blocks, work);
  return (int)cudaGetLastError();
}

}  // extern "C"
