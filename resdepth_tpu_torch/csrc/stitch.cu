// Scene stitch kernels for Hopper (sm_90a): weighted overlap-add of a batch
// of refined tiles into the f32 scene canvas, in place.
//
//   scene[y_i + r, x_i + c] += (tile_i[r, c] * sigma + mean_i) * (wy_i[r] * wx_i[c])
//
// Denormalisation (per-tile masked mean, global sigma), the separable
// linear-blend weight and the overlap-add are one pass over the tiles.
//
// Replaces the two Pallas TPU kernels of resdepth_tpu/ops/pallas_stitch.py:
//   stitch_k1  <- stitch_tiles_pallas       (_stitch_kernel, :58-101)
//   stitch_k2  <- stitch_tiles_pallas_fused (_stitch_kernel_fused, :157-209)
// Both TPU kernels add tile after tile in batch order (a sequential grid, a
// sequential loop), so each pixel sums as scene + tile_0 + tile_1 + ...
// Neither TPU-only device carries over: Hopper's loads need no (8, 128)
// aligned superset windows, so there is no pltpu.roll and no scene padding.
//
// What bounds them: memory. Per batch they read B*T^2 tile floats and
// B*2T weights and read and write each covered canvas pixel once: 55 MB at
// B = 128, T = 256 on the main path's grid (2.70 Mpx of canvas a batch),
// 16.6 us at 3.35 TB/s, against some 2.5 TFLOP of UNet forward for the same
// batch. The stitch is a small share of the step, and no speed-up of the
// whole is expected from it. The designs therefore aim at one coalesced
// pass over the tiles and no extra traffic:
//   K1: one thread per tile pixel, warps along tile rows (128-byte
//       coalesced reads), fire-and-forget f32 atomics into the canvas.
//       Overlapping tiles meet in any order, so the sum order, and the last
//       bit, may change from run to run.
//   K2: output-stationary and deterministic: each CTA owns a 16 x 128
//       block of the canvas box, starts from the canvas value and adds the
//       tiles that cover it in batch order, then writes the block once: the
//       per-pixel order of the TPU kernels and of the sequential CPU twin,
//       bitwise reproducible. Only a few of the B tiles cover a block, so
//       a search that walks all B positions in every thread (B serial
//       compare-and-branch steps) makes the instruction rate, not bytes,
//       the limit: at B = 128 it held the kernel near 20 % of the byte bound.
//       Hence:
//       - the covering tiles are found by ballot: each warp tests 32
//         positions at once against the block, and __ballot_sync plus the
//         popcount of the lower lanes compacts the hits into a list in
//         shared memory, in batch order (B / 32 warp steps a CTA, 256
//         positions a round, so any B);
//       - a thread owns 4 adjacent columns of 2 rows, loaded and stored as
//         float4 where the canvas (cols % 4 == 0) and the tile row
//         (x_i % 4 == 0) allow it, and as scalars where they do not (odd
//         scene widths, edge-shifted tiles); the wrapper picks the canvas
//         path by shape, the tile path is chosen per tile;
//       - the loads of kK2Group = 2 covering tiles are all in flight
//         before their adds, which stay in list order: 64 registers a
//         thread, so 4 CTAs an SM keep the bytes in flight (a group of 4
//         took 108 registers, 2 CTAs an SM, and ran slower);
//       - a block that no tile covers neither reads nor writes the canvas.
//
// Numerics: every product and sum goes through __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA, so each weighted value rounds exactly
// as the two-step CPU arithmetic of the plain twin does. Zero-weight
// padding tiles are not skipped: they add 0 * value, as the JAX kernels do.
// Positions are int32 here; the caller validates that every tile lies in
// the canvas, and the kernels drop pixels outside it rather than write out
// of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kK1Rows = 32;      // tile rows per K1 block
constexpr int kK2Threads = 256;  // a K2 CTA: 8 warps
constexpr int kK2Warps = kK2Threads / 32;
constexpr int kK2Cols = 128;     // canvas columns a K2 CTA: 32 lanes x 4
constexpr int kK2Rows = 16;      // canvas rows a K2 CTA
constexpr int kK2RowsPerThread = kK2Rows / kK2Warps;
constexpr int kK2Group = 2;      // covering tiles whose loads fly together

__device__ __forceinline__ float weighted(float t, float sigma, float mean,
                                          float wy, float wx) {
  return __fmul_rn(__fadd_rn(__fmul_rn(t, sigma), mean), __fmul_rn(wy, wx));
}

// grid (ceil(T / kK1Rows), B), block (32, 8).
__global__ void stitch_k1_kernel(float* __restrict__ scene, int rows, int cols,
                                 const float* __restrict__ tiles,
                                 const int* __restrict__ pos,
                                 const float* __restrict__ wy,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ means, float sigma,
                                 int T) {
  const int b = blockIdx.y;
  const int y = pos[2 * b];
  const int x = pos[2 * b + 1];
  const float mean = means[b];
  const float* tile = tiles + static_cast<size_t>(b) * T * T;
  const float* wyb = wy + static_cast<size_t>(b) * T;
  const float* wxb = wx + static_cast<size_t>(b) * T;
  const int r0 = static_cast<int>(blockIdx.x) * kK1Rows;
  const int r_end = min(r0 + kK1Rows, T);
  for (int r = r0 + static_cast<int>(threadIdx.y); r < r_end;
       r += static_cast<int>(blockDim.y)) {
    const int gy = y + r;
    if (gy < 0 || gy >= rows) continue;
    const float w_row = wyb[r];
    for (int c = static_cast<int>(threadIdx.x); c < T;
         c += static_cast<int>(blockDim.x)) {
      const int gx = x + c;
      if (gx < 0 || gx >= cols) continue;
      const float v = weighted(tile[static_cast<size_t>(r) * T + c], sigma,
                               mean, w_row, wxb[c]);
      atomicAdd(scene + static_cast<size_t>(gy) * cols + gx, v);
    }
  }
}

// Loads 4 adjacent floats at p, as one float4 when kVec (p 16-byte
// aligned), else as scalars; lanes not in ``in`` read nothing and give 0.
template <bool kVec>
__device__ __forceinline__ void load4(const float* p, const bool (&in)[4],
                                      float (&v)[4]) {
  if (kVec) {
    const float4 q = in[0] ? __ldg(reinterpret_cast<const float4*>(p))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = in[i] ? __ldg(p + i) : 0.0f;
  }
}

// grid over the box [y0, y0 + kK2Rows * gridDim.y) x [x0, x0 + kK2Cols *
// gridDim.x) with x0 % 4 == 0, kK2Threads threads: warp w owns rows
// by + w + kK2Warps * k, lane l columns bx + 4l .. bx + 4l + 3. Pixels
// outside the canvas are neither read nor written, and pixels outside
// [y0, y1) x [x0, x1) keep their value (a float4 group that straddles x1
// writes its outer columns back unchanged).
// kVecCanvas: cols % 4 == 0 and a 16-byte aligned canvas. kVecTiles:
// T % 4 == 0 and 16-byte aligned tiles and wx; a tile with x_i % 4 == 0
// then loads by float4 (its columns line up with the thread's).
template <bool kVecCanvas, bool kVecTiles>
__global__ void __launch_bounds__(kK2Threads)
stitch_k2_kernel(float* __restrict__ scene, int rows, int cols,
                 const float* __restrict__ tiles, const int* __restrict__ pos,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 const float* __restrict__ means, float sigma, int B, int T,
                 int y0, int x0, int y1, int x1) {
  __shared__ int s_b[kK2Threads];      // the covering tiles of this round,
  __shared__ int s_y[kK2Threads];      // in batch order
  __shared__ int s_x[kK2Threads];
  __shared__ float s_mean[kK2Threads];
  __shared__ int s_count[kK2Warps];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int by = y0 + static_cast<int>(blockIdx.y) * kK2Rows;
  const int bx = x0 + static_cast<int>(blockIdx.x) * kK2Cols;
  const int px = bx + 4 * lane;

  bool row_in[kK2RowsPerThread];
  bool col_in[4];
#pragma unroll
  for (int k = 0; k < kK2RowsPerThread; ++k)
    row_in[k] = by + warp + kK2Warps * k < min(y1, rows);
#pragma unroll
  for (int i = 0; i < 4; ++i) col_in[i] = px + i < min(x1, cols);
  // With cols % 4 == 0 a column group lies wholly inside the canvas; the
  // columns past x1 in it are covered by no tile and go back unchanged.
  const bool group_in = col_in[0];

  float acc[kK2RowsPerThread][4];
  bool loaded = false;   // uniform over the block
  for (int base = 0; base < B; base += kK2Threads) {
    // Find this round's covering tiles: a warp tests 32 positions at once.
    const int j = base + tid;
    int ty = 0, tx = 0;
    bool hit = false;
    if (j < B) {
      ty = __ldg(pos + 2 * j);
      tx = __ldg(pos + 2 * j + 1);
      hit = ty < by + kK2Rows && ty + T > by && tx < bx + kK2Cols && tx + T > bx;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kK2Warps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      n += c;
    }
    if (hit) {
      const int k = offset + __popc(mask & ((1u << lane) - 1u));
      s_b[k] = j;
      s_y[k] = ty;
      s_x[k] = tx;
      s_mean[k] = __ldg(means + j);
    }
    __syncthreads();
    if (n == 0) continue;   // the next round's first barrier orders smem

    if (!loaded) {
      loaded = true;
#pragma unroll
      for (int k = 0; k < kK2RowsPerThread; ++k) {
        const float* p = scene + static_cast<size_t>(by + warp + kK2Warps * k) * cols + px;
        if (kVecCanvas) {
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row_in[k] && group_in) q = *reinterpret_cast<const float4*>(p);
          acc[k][0] = q.x; acc[k][1] = q.y; acc[k][2] = q.z; acc[k][3] = q.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[k][i] = row_in[k] && col_in[i] ? p[i] : 0.0f;
        }
      }
    }

    for (int h0 = 0; h0 < n; h0 += kK2Group) {
      // Start every load of kK2Group tiles, then add them in list order.
      float v[kK2Group][kK2RowsPerThread][4];
      float wyv[kK2Group][kK2RowsPerThread];
      float wxv[kK2Group][4];
      float mean[kK2Group];
      bool r_in[kK2Group][kK2RowsPerThread];
      bool c_in[kK2Group][4];
#pragma unroll
      for (int g = 0; g < kK2Group; ++g) {
        const int h = min(h0 + g, n - 1);
        const bool valid = h0 + g < n;
        const size_t b = static_cast<size_t>(s_b[h]);
        const int ty_h = s_y[h];
        const int c = px - s_x[h];
        mean[g] = s_mean[h];
        const float* tile = tiles + b * T * T;
        const float* wyb = wy + b * T;
        const float* wxb = wx + b * T;
        const bool vec = kVecTiles && (c & 3) == 0;   // uniform over the block
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = vec ? c : c + i;
          c_in[g][i] = valid && ci >= 0 && ci < T;
        }
        if (vec) load4<true>(wxb + c, c_in[g], wxv[g]);
        else load4<false>(wxb + c, c_in[g], wxv[g]);
#pragma unroll
        for (int k = 0; k < kK2RowsPerThread; ++k) {
          const int r = by + warp + kK2Warps * k - ty_h;
          r_in[g][k] = r >= 0 && r < T;
          bool in[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) in[i] = r_in[g][k] && c_in[g][i];
          const float* p = tile + static_cast<size_t>(r) * T + c;
          wyv[g][k] = valid && r_in[g][k] ? __ldg(wyb + r) : 0.0f;
          if (vec) load4<true>(p, in, v[g][k]);
          else load4<false>(p, in, v[g][k]);
        }
      }
#pragma unroll
      for (int g = 0; g < kK2Group; ++g) {
#pragma unroll
        for (int k = 0; k < kK2RowsPerThread; ++k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (r_in[g][k] && c_in[g][i]) {
              acc[k][i] = __fadd_rn(acc[k][i], weighted(v[g][k][i], sigma, mean[g],
                                                        wyv[g][k], wxv[g][i]));
            }
          }
        }
      }
    }
  }
  if (!loaded) return;
#pragma unroll
  for (int k = 0; k < kK2RowsPerThread; ++k) {
    float* p = scene + static_cast<size_t>(by + warp + kK2Warps * k) * cols + px;
    if (kVecCanvas) {
      if (row_in[k] && group_in)
        *reinterpret_cast<float4*>(p) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (row_in[k] && col_in[i]) p[i] = acc[k][i];
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError():
// a launch the runtime refuses never runs, and only this call reports it.

int stitch_k1(float* scene, int rows, int cols, const float* tiles,
              const int* pos, const float* wy, const float* wx,
              const float* means, float sigma, int B, int T, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((T + kK1Rows - 1) / kK1Rows, B);
  stitch_k1_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      scene, rows, cols, tiles, pos, wy, wx, means, sigma, T);
  return static_cast<int>(cudaGetLastError());
}

// K2 over the box [y0, y1) x [x0, x1) of the canvas, which must hold every
// tile of the batch. vec_canvas and vec_tiles select the float4 paths (see
// stitch_k2_kernel); the caller decides them from shapes and alignment.
int stitch_k2(float* scene, int rows, int cols, const float* tiles,
              const int* pos, const float* wy, const float* wx,
              const float* means, float sigma, int B, int T, int y0, int x0,
              int y1, int x1, int vec_canvas, int vec_tiles, void* stream) {
  x0 &= ~3;   // column groups of 4 start on a multiple of 4
  const dim3 block(kK2Threads);
  const dim3 grid((x1 - x0 + kK2Cols - 1) / kK2Cols, (y1 - y0 + kK2Rows - 1) / kK2Rows);
  auto kernel = vec_canvas ? (vec_tiles ? stitch_k2_kernel<true, true>
                                        : stitch_k2_kernel<true, false>)
                           : (vec_tiles ? stitch_k2_kernel<false, true>
                                        : stitch_k2_kernel<false, false>);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      scene, rows, cols, tiles, pos, wy, wx, means, sigma, B, T, y0, x0, y1, x1);
  return static_cast<int>(cudaGetLastError());
}

const char* stitch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
