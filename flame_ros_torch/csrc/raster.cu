// Triangle-id rasterization kernels for Hopper (sm_90a), plain C ABI.
//
// Both kernels compute the triangle-id buffer [H, W] int32 of the
// engine's per-frame raster: for each pixel, the LOWEST original id of a
// valid triangle whose three CCW edge functions are all >= -1e-3, or -1
// where no triangle covers the pixel. The wrappers, the plain PyTorch
// versions and the build live in flame_ros_torch/ops/raster_cuda.py.
//
// raster_v4 replaces the TPU kernel rasterize_tri_ids_pallas_v4 /
// _kernel_v4 (flame_ros_tpu/ops/raster_pallas.py:350-482). The wrapper
// sorts triangles on the device by (class, ymin) and builds the sorted
// master slab M [12, T] (9 edge coefficients, validity, original id, pad).
// Each tile of `row_tile` image rows needs the contiguous short-triangle
// positions [lo_pos, lo_pos + cand_s) plus the shared long slab
// [n_short, n_short + cand_l). One block per tile copies those <= 512
// columns of M (11 rows, 22.5 KB) into shared memory; each thread owns up
// to PIX pixels in registers and loops over the staged candidates.
//
// raster_v2 replaces rasterize_tri_ids_pallas / _kernel
// (flame_ros_tpu/ops/raster_pallas.py:27-147). One block per tile loops
// over the tile's contiguous triangle-block range [lo, hi) in chunks of
// CHUNK triangles staged in shared memory. Candidates come in ascending
// id order, so a pixel's first hit is its answer: threads skip pixels
// already resolved and the block leaves the loop once all are.
//
// raster_v3 replaces rasterize_tri_ids_pallas_v3 / _kernel_v3
// (flame_ros_tpu/ops/raster_pallas.py:180-315). The wrapper sorts as for
// v4 and builds the sorted slab C [11, T] (9 edge coefficients, validity,
// original id). A tile needs at most s_blocks blocks of tri_block short
// triangles from lo_blk, plus at most l_blocks shared blocks of long
// ones; the TPU kernel walks them as a grid axis of s_blocks + l_blocks
// steps with the output tile as the accumulator. Here one block per tile
// loops over those steps itself, skips the inactive ones, stages each
// active block in shared memory (11 x 128 floats, 5.6 KB) and keeps a
// running minimum of original ids per pixel in registers.
//
// What bounds them on this card: arithmetic. At VGA with T = 4096 and
// row_tile = 2 there are 240 tiles x 1280 pixels x <= 512 candidates,
// about 157 M candidate tests of 6 multiplies, 6 adds and 4 compares
// each, against ~4 MB of slab and a 1.2 MB output: f32 CUDA-core bound,
// not memory bound. The design keeps the slab in shared memory (read as
// broadcasts, no bank conflicts), keeps each thread's pixels and running
// minima in registers so a staged candidate's coefficients are loaded
// once for PIX pixels, and never writes an intermediate to device memory.
//
// Exactness: the id buffer must equal the plain PyTorch version bit for
// bit, so every edge function is evaluated with explicit round-to-nearest
// multiplies and adds (no FMA contraction), in the JAX kernels' order:
// x*a + (y*b + c) for v4, (x*a + y*b) + c for v2 and v3.
//
// The v4 -> v2 and v3 -> v2 fallbacks need no host sync: `fits` is a
// device flag. raster_v4 and raster_v3 return at once when it is false;
// raster_v2 launched with skip_if = fits returns at once when it is true.
// Exactly one of the two writes the output. Each kernel adds 1 to work[k]
// (k = 0 for v4, 1 for v2, 2 for v3) when it does the work, so a run can
// show which one did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX = 4;          // pixels per thread
constexpr int CHUNK = 512;      // v2 triangles staged per pass
constexpr int CHUNK3 = 128;     // v3 triangles staged per pass
constexpr float EPS = -1e-3f;

__device__ __forceinline__ float edge_v4(float x, float y, float a, float b,
                                         float c) {
  // x*a + (y*b + c), rounded op by op.
  return __fadd_rn(__fmul_rn(x, a), __fadd_rn(__fmul_rn(y, b), c));
}

__device__ __forceinline__ float edge_v2(float x, float y, float a, float b,
                                         float c) {
  // (x*a + y*b) + c, rounded op by op.
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

// M: [12, T] row-major, columns in sorted order. lo_pos: [n_tiles].
// counts: [2] = (n_short, n_long). fits: device bool. out: [H * W].
__global__ void raster_v4_kernel(const float* __restrict__ M, int T,
                                 const int* __restrict__ lo_pos,
                                 const int* __restrict__ counts,
                                 const bool* __restrict__ fits,
                                 int* __restrict__ out, int width,
                                 int row_tile, int cand_s, int cand_l,
                                 int* __restrict__ work) {
  if (!*fits) return;
  extern __shared__ float sm[];          // [11][nc]
  const int tile = blockIdx.x;
  const int nc = cand_s + cand_l;
  const int n_short = counts[0];
  const int n_long = counts[1];
  const int lo = lo_pos[tile];
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    int pos;
    float lvalid = 1.0f;
    if (c < cand_s) {
      pos = lo + c;
    } else {
      const int k = c - cand_s;
      pos = n_short + k;
      lvalid = (k < n_long) ? 1.0f : 0.0f;
    }
    pos = min(max(pos, 0), T - 1);
    for (int r = 0; r < 11; ++r) sm[r * nc + c] = M[r * T + pos];
    if (c >= cand_s) sm[9 * nc + c] = __fmul_rn(sm[9 * nc + c], lvalid);
  }
  __syncthreads();
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 0, 1);

  const int px_tile = row_tile * width;
  const float big = (float)(T + 1);
  float px[PIX], py[PIX], best[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int pc = p < px_tile ? p : 0;
    px[j] = (float)(pc % width);
    py[j] = (float)(tile * row_tile + pc / width);
    best[j] = big;
  }
  for (int c = 0; c < nc; ++c) {
    const float valid = sm[9 * nc + c];
    if (!(valid > 0.0f)) continue;
    const float a0 = sm[0 * nc + c], b0 = sm[1 * nc + c], c0 = sm[2 * nc + c];
    const float a1 = sm[3 * nc + c], b1 = sm[4 * nc + c], c1 = sm[5 * nc + c];
    const float a2 = sm[6 * nc + c], b2 = sm[7 * nc + c], c2 = sm[8 * nc + c];
    const float id = sm[10 * nc + c];
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const bool in = (edge_v4(px[j], py[j], a0, b0, c0) >= EPS)
                    & (edge_v4(px[j], py[j], a1, b1, c1) >= EPS)
                    & (edge_v4(px[j], py[j], a2, b2, c2) >= EPS);
      if (in) best[j] = fminf(best[j], id);
    }
  }
  int* o = out + (size_t)tile * px_tile;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < px_tile) {
      const int v = (int)best[j];
      o[p] = v > T ? -1 : v;
    }
  }
}

// C: [10, T] row-major (9 edge coefficients, validity) in original order.
// bounds: [n_tiles, 2] int32 block range [lo, hi). skip_if: device bool
// or null.
__global__ void raster_v2_kernel(const float* __restrict__ C, int T,
                                 const int* __restrict__ bounds,
                                 int tri_block,
                                 const bool* __restrict__ skip_if,
                                 int* __restrict__ out, int width,
                                 int px_tile, int* __restrict__ work) {
  if (skip_if != nullptr && *skip_if) return;
  __shared__ float sm[10 * CHUNK];
  const int tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(work + 1, 1);
  const int t_lo = bounds[2 * tile] * tri_block;
  const int t_hi = min(bounds[2 * tile + 1] * tri_block, T);
  const int big = T + 1;
  float px[PIX], py[PIX];
  int best[PIX];
  bool done = true;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int idx = tile * px_tile + (p < px_tile ? p : 0);
    px[j] = (float)(idx % width);
    py[j] = (float)(idx / width);
    best[j] = p < px_tile ? big : -1;   // out-of-tile slots start resolved
    done = done && best[j] < big;
  }
  for (int base = t_lo; base < t_hi; base += CHUNK) {
    const int n = min(CHUNK, t_hi - base);
    if (__syncthreads_and(done)) break;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
#pragma unroll
      for (int r = 0; r < 10; ++r) sm[r * CHUNK + k] = C[r * T + base + k];
    }
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        if (!(sm[9 * CHUNK + k] > 0.0f)) continue;
        const float a0 = sm[0 * CHUNK + k], b0 = sm[1 * CHUNK + k];
        const float c0 = sm[2 * CHUNK + k], a1 = sm[3 * CHUNK + k];
        const float b1 = sm[4 * CHUNK + k], c1 = sm[5 * CHUNK + k];
        const float a2 = sm[6 * CHUNK + k], b2 = sm[7 * CHUNK + k];
        const float c2 = sm[8 * CHUNK + k];
        bool all = true;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          if (best[j] < big) continue;
          const bool in = (edge_v2(px[j], py[j], a0, b0, c0) >= EPS)
                        & (edge_v2(px[j], py[j], a1, b1, c1) >= EPS)
                        & (edge_v2(px[j], py[j], a2, b2, c2) >= EPS);
          if (in) best[j] = base + k;
          all = all && best[j] < big;
        }
        if (all) { done = true; break; }
      }
    }
    __syncthreads();   // the next pass overwrites the staged chunk
  }
  int* o = out + (size_t)tile * px_tile;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < px_tile) o[p] = best[j] < big ? best[j] : -1;
  }
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
  float px[PIX], py[PIX];
  int best[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
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
        for (int j = 0; j < PIX; ++j) {
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
  for (int j = 0; j < PIX; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < px_tile) o[p] = best[j] > T ? -1 : best[j];
  }
}

int threads_for(int px_tile) {
  int t = (px_tile + PIX - 1) / PIX;
  t = ((t + 31) / 32) * 32;
  return t;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int raster_v4_launch(const float* M, int T, const int* lo_pos,
                     const int* counts, const bool* fits, int* out,
                     int height, int width, int row_tile, int cand_s,
                     int cand_l, int* work, void* stream) {
  const int n_tiles = height / row_tile;
  const int threads = threads_for(row_tile * width);
  const size_t smem = (size_t)11 * (cand_s + cand_l) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raster_v4_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      M, T, lo_pos, counts, fits, out, width, row_tile, cand_s, cand_l,
      work);
  return (int)cudaGetLastError();
}

int raster_v2_launch(const float* C, int T, const int* bounds,
                     int tri_block, const bool* skip_if, int* out,
                     int height, int width, int row_tile, int* work,
                     void* stream) {
  const int px_tile = row_tile * width;
  const int n_tiles = (height * width) / px_tile;
  const int threads = threads_for(px_tile);
  raster_v2_kernel<<<n_tiles, threads, 0, (cudaStream_t)stream>>>(
      C, T, bounds, tri_block, skip_if, out, width, px_tile, work);
  return (int)cudaGetLastError();
}

int raster_v3_launch(const float* C, int T, const int* lo_blk,
                     const int* nblk_s, const int* long2, const bool* fits,
                     int* out, int height, int width, int row_tile,
                     int tri_block, int s_blocks, int l_blocks, int* work,
                     void* stream) {
  const int px_tile = row_tile * width;
  const int n_tiles = (height * width) / px_tile;
  const int threads = threads_for(px_tile);
  raster_v3_kernel<<<n_tiles, threads, 0, (cudaStream_t)stream>>>(
      C, T, lo_blk, nblk_s, long2, fits, out, width, px_tile, tri_block,
      s_blocks, l_blocks, work);
  return (int)cudaGetLastError();
}

}  // extern "C"
