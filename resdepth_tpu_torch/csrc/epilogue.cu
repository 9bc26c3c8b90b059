// The bf16 trunk's epilogue for Hopper (sm_90a): one pass over a conv's
// NHWC output that writes the trunk's value and, after an encoder block, its
// 2x2 stride-2 max-pool.
//
// It replaces no TPU kernel. On the TPU, XLA fused these elementwise ops
// into the convs of the JAX graph (resdepth_tpu/models/unet.py); in the
// port, cuDNN runs the bf16 trunk's convs and ATen then made two or three
// separate passes over each output, every pass reading and writing the
// whole activation. Three modes of one kernel, each rounding exactly where
// those ATen ops round (products and sums in float32, every result rounded
// to bf16 to nearest even, as c10::BFloat16 rounds on the card):
//
//   block  (bf16 y, the raw conv output; every conv of the bf16 trunk):
//            skip = act(bf16(y + bf16(bias)))      bias optional
//          act: relu as clamp_min (NaN kept, else fmaxf(v, 0)), lrelu and
//          prelu as torch.where(v >= 0, v, bf16(slope * v)) with slope 0.01
//          or the per-channel slope rounded to bf16 first; none.
//   cast   (f32 y: encoder0 on K3, which applied bias and activation):
//            skip = bf16(y)
//   skip   (bf16 u, the raw upsampling output, and the additive skip s):
//            out = bf16(s + bf16(u + bf16(bias)))
//
// With pool (block and cast, encoder levels), the pooled map takes the max
// of each 2x2 quad in row-major order, replacing the running max when a
// value is greater or NaN, from -inf (max_pool_forward_nhwc's rule, so NaN
// propagates and ties keep the first value); an odd last row or column is
// written to skip and pooled by nothing (floor, as nn.MaxPool2d(2, 2)).
// Unlike ATen's max_pool2d, no int64 indices are written.
//
// What bounds it: bytes. Per element of an (N, H, W, C) map it reads the
// input once and writes each output once, so the least traffic is
//   block: 2 (y) + 2 (skip) [+ 0.5 (pooled)]   = 4   [4.5] bytes
//   cast:  4 (y) + 2 (skip) [+ 0.5 (pooled)]   = 6   [6.5] bytes
//   skip:  2 (u) + 2 (s) + 2 (out)             = 6         bytes
// times N·H·W·C, plus 4 C bytes of bias (and of slopes), over 3.35 TB/s.
// The arithmetic is a few flops an element, far under the card's rate.
//
// Design: a thread takes 8 channels of one pixel, or of a 2x2 pixel quad
// where a pool follows. 8 channels are 16 bytes of bf16: one vector load
// or store a pixel (two for f32), and neighbouring threads take
// neighbouring channel groups, so a warp's accesses are whole 32-byte
// sectors. A thread that owns the whole quad has the four values the max
// needs in registers: the pool needs no shared memory, no second read of
// the skip and no synchronisation. A map whose channel count is not a
// multiple of 8, or a tensor not 16-byte aligned, runs the same code one
// channel a thread (V = 1). One thread an item, 256 a block: at the
// flagship's deepest maps (16² and 8² at 512 channels, batch 128) that is
// 2,048 blocks, over 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kModeBlock = 0, kModeCast = 1, kModeSkip = 2;
// ops/conv.py's activation codes; any other code is the identity
constexpr int kActNone = 0, kActRelu = 1, kActLrelu = 2, kActPrelu = 3;
constexpr float kLreluSlope = 0.01f;
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_value(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// V bf16 values at p (16-byte aligned for V = 8)
template <int V>
__device__ __forceinline__ void load_bf16(const uint16_t* p, uint16_t (&v)[V]) {
  if constexpr (V == 8) {
    union { uint4 u; uint16_t h[8]; } pack;
    pack.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = pack.h[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(uint16_t* p, const uint16_t (&v)[V]) {
  if constexpr (V == 8) {
    union { uint4 u; uint16_t h[8]; } pack;
#pragma unroll
    for (int i = 0; i < 8; ++i) pack.h[i] = v[i];
    *reinterpret_cast<uint4*>(p) = pack.u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// float32 (C,) vector at p, each value rounded to bf16 (the ``.to(bf16)``
// of a float32 bias or slope), as float; zeros for a null p
template <int V>
__device__ __forceinline__ void load_rounded(const float* p, float (&v)[V]) {
  if (p == nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
    return;
  }
  load_f32<V>(p, v);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = bf16_value(bf16_bits(v[i]));
}

template <int kAct>
__device__ __forceinline__ uint16_t activate(uint16_t bits, float slope) {
  const float v = bf16_value(bits);
  if constexpr (kAct == kActRelu) {
    return isnan(v) ? bits : bf16_bits(fmaxf(v, 0.0f));
  } else if constexpr (kAct == kActLrelu) {
    return v >= 0.0f ? bits : bf16_bits(kLreluSlope * v);
  } else if constexpr (kAct == kActPrelu) {
    return v >= 0.0f ? bits : bf16_bits(slope * v);
  } else {
    return bits;
  }
}

// The trunk's value of V channels of one pixel at element offset off.
template <int kMode, int kAct, int V>
__device__ __forceinline__ void trunk_values(const void* __restrict__ in,
                                             const uint16_t* __restrict__ skip_in,
                                             bool has_bias, const float (&bias)[V],
                                             const float (&slope)[V], size_t off,
                                             uint16_t (&out)[V]) {
  if constexpr (kMode == kModeCast) {
    float y[V];
    load_f32<V>(static_cast<const float*>(in) + off, y);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = bf16_bits(y[i]);
  } else {
    uint16_t y[V];
    load_bf16<V>(static_cast<const uint16_t*>(in) + off, y);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = has_bias ? bf16_bits(bf16_value(y[i]) + bias[i]) : y[i];
    }
    if constexpr (kMode == kModeSkip) {
      uint16_t s[V];
      load_bf16<V>(skip_in + off, s);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = bf16_bits(bf16_value(s[i]) + bf16_value(out[i]));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = activate<kAct>(out[i], slope[i]);
    }
  }
}

// One item a thread: V channels of one pixel, or with kPool of a 2x2 quad
// (the pooled value written where the quad is whole). items < 2^31.
template <int kMode, int kAct, bool kPool, int V>
__global__ void __launch_bounds__(kThreads)
trunk_epilogue_kernel(const void* __restrict__ in, const uint16_t* __restrict__ skip_in,
                      const float* __restrict__ bias_in, const float* __restrict__ slope_in,
                      uint16_t* __restrict__ out, uint16_t* __restrict__ pooled,
                      int h, int w, int c, unsigned items) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const unsigned groups = static_cast<unsigned>(c / V);
  const int c0 = static_cast<int>(t % groups) * V;
  unsigned rest = t / groups;
  float bias[V], slope[V];
  load_rounded<V>(bias_in == nullptr ? nullptr : bias_in + c0, bias);
  load_rounded<V>(kAct == kActPrelu ? slope_in + c0 : nullptr, slope);
  const bool has_bias = bias_in != nullptr;
  uint16_t v[V];
  if constexpr (!kPool) {
    const size_t off = static_cast<size_t>(rest) * c + c0;
    trunk_values<kMode, kAct, V>(in, skip_in, has_bias, bias, slope, off, v);
    store_bf16<V>(out + off, v);
  } else {
    const unsigned qw = (w + 1) / 2, qh = (h + 1) / 2;
    const int qx = static_cast<int>(rest % qw);
    rest /= qw;
    const int qy = static_cast<int>(rest % qh);
    const unsigned n = rest / qh;
    float top[V];
    uint16_t top_bits[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      top[i] = -INFINITY;
      top_bits[i] = 0xFF80;   // bf16 -inf
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = 2 * qy + dy;
      if (y >= h) break;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = 2 * qx + dx;
        if (x >= w) break;
        const size_t off = ((static_cast<size_t>(n) * h + y) * w + x) * c + c0;
        trunk_values<kMode, kAct, V>(in, skip_in, has_bias, bias, slope, off, v);
        store_bf16<V>(out + off, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float value = bf16_value(v[i]);
          if (value > top[i] || isnan(value)) {
            top[i] = value;
            top_bits[i] = v[i];
          }
        }
      }
    }
    const int ph = h / 2, pw = w / 2;
    if (qy < ph && qx < pw) {
      store_bf16<V>(pooled + ((static_cast<size_t>(n) * ph + qy) * pw + qx) * c + c0,
                    top_bits);
    }
  }
}

using Kernel = void (*)(const void*, const uint16_t*, const float*, const float*,
                        uint16_t*, uint16_t*, int, int, int, unsigned);

template <int kMode, int kAct, bool kPool>
Kernel pick_vec(int vec) {
  return vec == 8 ? trunk_epilogue_kernel<kMode, kAct, kPool, 8>
                  : trunk_epilogue_kernel<kMode, kAct, kPool, 1>;
}

template <int kMode, int kAct>
Kernel pick_pool(bool pool, int vec) {
  return pool ? pick_vec<kMode, kAct, true>(vec) : pick_vec<kMode, kAct, false>(vec);
}

Kernel pick(int mode, int act, bool pool, int vec) {
  if (mode == kModeCast) return pick_pool<kModeCast, kActNone>(pool, vec);
  if (mode == kModeSkip) return pick_vec<kModeSkip, kActNone, false>(vec);
  switch (act) {
    case kActRelu: return pick_pool<kModeBlock, kActRelu>(pool, vec);
    case kActLrelu: return pick_pool<kModeBlock, kActLrelu>(pool, vec);
    case kActPrelu: return pick_pool<kModeBlock, kActPrelu>(pool, vec);
    default: return pick_pool<kModeBlock, kActNone>(pool, vec);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(): a launch the
// runtime refuses never runs, and only this call reports it. ``mode`` 0
// block, 1 cast, 2 skip; ``vec`` 8 (C % 8 == 0, every pointer 16-byte
// aligned) or 1; ``bias`` may be null; ``slope`` is read for prelu only;
// ``pooled`` is written with ``pool`` only (block and cast). The caller
// keeps the item count, N·ceil(H/2)·ceil(W/2)·C/vec with ``pool`` and
// N·H·W·C/vec without, below 2^31.
int trunk_epilogue(int mode, int act, int pool, int vec, const void* in,
                   const void* skip_in, const float* bias, const float* slope, void* out,
                   void* pooled, int n, int h, int w, int c, void* stream) {
  const bool with_pool = pool != 0 && mode != kModeSkip;
  const long long pixels = with_pool
      ? static_cast<long long>(n) * ((h + 1) / 2) * ((w + 1) / 2)
      : static_cast<long long>(n) * h * w;
  const unsigned items = static_cast<unsigned>(pixels * (c / vec));
  const unsigned blocks = (items + kThreads - 1) / kThreads;
  pick(mode, act, with_pool, vec)<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const uint16_t*>(skip_in), bias, slope, static_cast<uint16_t*>(out),
      static_cast<uint16_t*>(pooled), h, w, c, items);
  return static_cast<int>(cudaGetLastError());
}

const char* epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
