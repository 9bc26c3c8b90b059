// Kernel K3 for Hopper (sm_90a): same-padded 3x3 convolution + bias +
// activation on NHWC data, f32 accumulation.
//
//   out[n, y, x, o] = act(bias[o] + sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * k[dy, dx, c, o])
//
// with zero padding outside the image; act is identity, relu, lrelu (slope
// 0.01, ``v >= 0`` select) or prelu (per-channel slope).
//
// Replaces the Pallas TPU kernel resdepth_tpu/ops/pallas_conv.py::
// conv3x3_bias_act (_conv_kernel, :49-80). The TPU kernel cuts the padded
// input into three row-shifted views so that its BlockSpecs hand each grid
// program a halo window in VMEM, and emulates Precision.HIGH for f32 with a
// 3-pass bf16 hi/lo split on the MXU. Neither carries over: a CTA here loads
// its own halo (zero padding is a bounds check, not a padded copy), and f32
// inputs run IEEE fp32 FMAs (Hopper has native fp32; the port's float32
// policy is IEEE fp32). bf16 inputs are widened to f32 as they are staged,
// so products are exact and the sum is f32, then rounded once to bf16.
//
// What bounds it: arithmetic. A flagship 64->64 layer at 256^2 and batch 128
// is 0.62 TFLOP against about 4 GB of activations in and out, some 150
// FLOP per byte. This first kernel is the simple design: CUDA-core FMAs, no
// tensor cores, so it is held to the 67 TFLOP/s fp32 peak at best, and bf16
// gains nothing from its halved bytes. Each CTA computes a 16x16 pixel x 64
// output-channel block; per 8-channel input chunk it stages the 18x18 halo
// and the chunk's 9x8x64 weights in shared memory, and each of its 256
// threads keeps an 8-pixel x 8-channel block of accumulators in registers,
// reusing every staged input value 24 times and every weight 8 times. A
// Hopper implicit GEMM (wgmma fed by TMA) is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;            // output rows per CTA
constexpr int kTileW = 16;            // output columns per CTA
constexpr int kTileC = 64;            // output channels per CTA
constexpr int kChunk = 8;             // input channels staged at a time
constexpr int kThreads = 256;
constexpr int kPix = 8;               // pixels per thread (one row segment)
constexpr int kCo = 8;                // output channels per thread
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

enum Act { kIdentity = 0, kRelu = 1, kLrelu = 2, kPrelu = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid (tiles_w * tiles_h, ceil(Cout / 64), N), block 256.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_k3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ prelu,
                  T* __restrict__ out, int H, int W, int Cin, int Cout, int act) {
  __shared__ float s_in[kChunk][kHaloH][kHaloW];
  __shared__ __align__(16) float s_w[kChunk][9][kTileC];

  const int tid = static_cast<int>(threadIdx.x);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tile_y = static_cast<int>(blockIdx.x) / tiles_w;
  const int tile_x = static_cast<int>(blockIdx.x) % tiles_w;
  const int co0 = static_cast<int>(blockIdx.y) * kTileC;
  const long long n = blockIdx.z;
  const int y_base = tile_y * kTileH - 1;   // halo origin
  const int x_base = tile_x * kTileW - 1;

  const int cg = tid % (kTileC / kCo);      // channel group: 8 channels
  const int pg = tid / (kTileC / kCo);      // pixel group: 8 pixels of a row
  const int row = pg / (kTileW / kPix);
  const int col0 = (pg % (kTileW / kPix)) * kPix;

  float acc[kPix][kCo];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[p][c] = 0.0f;

  const T* x_n = x + n * H * W * Cin;
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    for (int idx = tid; idx < kChunk * kHaloH * kHaloW; idx += kThreads) {
      const int ci = idx % kChunk;          // channels innermost: NHWC order
      const int pos = idx / kChunk;
      const int hc = pos % kHaloW;
      const int hr = pos / kHaloW;
      const int gy = y_base + hr;
      const int gx = x_base + hc;
      const int gc = c0 + ci;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin) {
        v = to_float(x_n[(static_cast<long long>(gy) * W + gx) * Cin + gc]);
      }
      s_in[ci][hr][hc] = v;
    }
    for (int idx = tid; idx < kChunk * 9 * kTileC; idx += kThreads) {
      const int co = idx % kTileC;          // output channels innermost: HWIO
      const int rest = idx / kTileC;
      const int tap = rest % 9;
      const int ci = rest / 9;
      const int gc = c0 + ci;
      const int gco = co0 + co;
      float v = 0.0f;
      if (gc < Cin && gco < Cout) {
        v = to_float(w[(static_cast<long long>(tap) * Cin + gc) * Cout + gco]);
      }
      s_w[ci][tap][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kChunk; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float in[kPix + 2];
#pragma unroll
        for (int j = 0; j < kPix + 2; ++j) in[j] = s_in[ci][row + dy][col0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w_lo = *reinterpret_cast<const float4*>(&s_w[ci][dy * 3 + dx][cg * kCo]);
          const float4 w_hi = *reinterpret_cast<const float4*>(&s_w[ci][dy * 3 + dx][cg * kCo + 4]);
          const float wv[kCo] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w, w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int c = 0; c < kCo; ++c) acc[p][c] = fmaf(in[p + dx], wv[c], acc[p][c]);
        }
      }
    }
    __syncthreads();
  }

  float b[kCo], a[kCo];
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
    const int co = co0 + cg * kCo + c;
    b[c] = co < Cout ? bias[co] : 0.0f;
    a[c] = co < Cout ? prelu[co] : 0.0f;
  }
  const int gy = tile_y * kTileH + row;
  if (gy >= H) return;
  T* out_row = out + (n * H + gy) * static_cast<long long>(W) * Cout;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int gx = tile_x * kTileW + col0 + p;
    if (gx >= W) continue;
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const int co = co0 + cg * kCo + c;
      if (co >= Cout) continue;
      float v = acc[p][c] + b[c];
      if (act == kRelu) {
        v = fmaxf(v, 0.0f);
      } else if (act == kLrelu) {
        v = v >= 0.0f ? v : 0.01f * v;
      } else if (act == kPrelu) {
        v = v >= 0.0f ? v : a[c] * v;
      }
      store(out_row + static_cast<long long>(gx) * Cout + co, v);
    }
  }
}

}  // namespace

extern "C" {

// Launches K3 on ``stream`` and returns cudaGetLastError(): a launch the
// runtime refuses never runs, and only this call reports it. ``dtype`` 0 is
// float32, 1 is bfloat16 (x, w and out share it); bias and prelu are f32.
int conv3x3_k3(const void* x, const void* w, const float* bias,
               const float* prelu, void* out, int N, int H, int W, int Cin,
               int Cout, int act, int dtype, void* stream) {
  const dim3 grid(((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH),
                  (Cout + kTileC - 1) / kTileC, N);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv3x3_k3_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias, prelu,
        static_cast<float*>(out), H, W, Cin, Cout, act);
  } else if (dtype == 1) {
    conv3x3_k3_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        bias, prelu, static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
