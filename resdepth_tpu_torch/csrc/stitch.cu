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
// B*2T weights and do B*T^2 read-modify-writes of the canvas, about 100 MB
// at B = 128, T = 256, against some 2.5 TFLOP of UNet forward for the same
// batch. The stitch is a small share of the step, and no speed-up of the
// whole is expected from it. The designs therefore aim at one coalesced
// pass over the tiles and no extra traffic:
//   K1: one thread per tile pixel, warps along tile rows (128-byte
//       coalesced reads), fire-and-forget f32 atomics into the canvas.
//       Overlapping tiles meet in any order, so the sum order, and the last
//       bit, may change from run to run.
//   K2: output-stationary and deterministic. One block per 32x32 canvas
//       block of the batch's bounding box walks the tiles in batch order,
//       adds each covering tile's weighted values to registers that start
//       from the canvas value, and writes the block once: the per-pixel
//       order of the TPU kernels and of the sequential CPU twin, bitwise
//       reproducible.
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
constexpr int kBlock = 32;       // K2 canvas block edge
constexpr int kRowsPerThread = kBlock / 8;
constexpr int kChunk = 256;      // tile positions staged in shared memory

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

// grid over the bounding box [y0, y0 + 32 * gridDim.y) x [x0, ...),
// block (32, 8): each thread owns one column and kRowsPerThread rows.
__global__ void stitch_k2_kernel(float* __restrict__ scene, int rows, int cols,
                                 const float* __restrict__ tiles,
                                 const int* __restrict__ pos,
                                 const float* __restrict__ wy,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ means, float sigma,
                                 int B, int T, int y0, int x0) {
  __shared__ int s_y[kChunk];
  __shared__ int s_x[kChunk];
  __shared__ float s_mean[kChunk];

  const int by = y0 + static_cast<int>(blockIdx.y) * kBlock;
  const int bx = x0 + static_cast<int>(blockIdx.x) * kBlock;
  const int row0 = by + static_cast<int>(threadIdx.y);   // rows row0 + 8k
  const int px = bx + static_cast<int>(threadIdx.x);
  const int tid = static_cast<int>(threadIdx.y * blockDim.x + threadIdx.x);
  const int n_threads = static_cast<int>(blockDim.x * blockDim.y);

  float acc[kRowsPerThread];
  bool inside[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int py = row0 + 8 * k;
    inside[k] = py < rows && px < cols;
    acc[k] = inside[k] ? scene[static_cast<size_t>(py) * cols + px] : 0.0f;
  }

  bool touched = false;  // uniform over the block
  for (int base = 0; base < B; base += kChunk) {
    const int n = min(kChunk, B - base);
    for (int i = tid; i < n; i += n_threads) {
      s_y[i] = pos[2 * (base + i)];
      s_x[i] = pos[2 * (base + i) + 1];
      s_mean[i] = means[base + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int ty = s_y[j];
      const int tx = s_x[j];
      if (ty >= by + kBlock || ty + T <= by || tx >= bx + kBlock || tx + T <= bx)
        continue;
      touched = true;
      const size_t b = static_cast<size_t>(base + j);
      const float* tile = tiles + b * T * T;
      const float* wyb = wy + b * T;
      const int c = px - tx;
      if (c < 0 || c >= T) continue;
      const float w_col = wx[b * T + c];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = row0 + 8 * k - ty;
        if (inside[k] && r >= 0 && r < T) {
          acc[k] = __fadd_rn(acc[k], weighted(tile[static_cast<size_t>(r) * T + c],
                                              sigma, s_mean[j], wyb[r], w_col));
        }
      }
    }
    __syncthreads();
  }
  if (!touched) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (inside[k]) {
      scene[static_cast<size_t>(row0 + 8 * k) * cols + px] = acc[k];
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

int stitch_k2(float* scene, int rows, int cols, const float* tiles,
              const int* pos, const float* wy, const float* wx,
              const float* means, float sigma, int B, int T, int y0, int x0,
              int y1, int x1, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((x1 - x0 + kBlock - 1) / kBlock, (y1 - y0 + kBlock - 1) / kBlock);
  stitch_k2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      scene, rows, cols, tiles, pos, wy, wx, means, sigma, B, T, y0, x0);
  return static_cast<int>(cudaGetLastError());
}

const char* stitch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
