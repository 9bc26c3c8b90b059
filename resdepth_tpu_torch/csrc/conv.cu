// Kernel K3 for Hopper (sm_90a): same-padded 3x3 convolution + bias +
// activation on NHWC data, as an implicit GEMM on the tensor cores.
//
//   out[n, y, x, o] = act(bias[o] + sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * k[dy, dx, c, o])
//
// with zero padding outside the image; act is identity, relu, lrelu (slope
// 0.01, ``v >= 0`` select) or prelu (per-channel slope).
//
// Replaces the Pallas TPU kernel resdepth_tpu/ops/pallas_conv.py::
// conv3x3_bias_act (_conv_kernel, :49-80), and computes what it computes:
// bf16 inputs take one bf16 product pass with f32 accumulation; f32 inputs
// take the TPU kernel's Precision.HIGH decomposition, x = x_hi + x_lo and
// w = w_hi + w_lo in bf16, accumulating x_hi*w_hi + x_hi*w_lo + x_lo*w_hi in
// f32 (three bf16 passes). f32 inputs may also ask for fewer passes, the
// TPU's other MXU precisions on f32 operands (the serving modes): 1 pass,
// x_hi*w_hi (Precision.DEFAULT), or 2 passes, x_hi*w_hi + x_lo*w_hi
// ((HIGH, DEFAULT): the activation split, the weights single-rounded). The
// TPU kernel cuts the padded input into three row-shifted views so that its
// BlockSpecs hand each grid program a halo window in VMEM.
//
// Five kernels, each a design for its shapes; ops/conv.py::k3_variant
// routes a call by dtype, Cin, Cout and whether it names its passes:
//
//   * wide (conv3x3_k3_kernel, below): bfloat16. x padded with zero
//     channels to a multiple of 16, the weights re-laid (9, Cout, Cin_p)
//     once a call, both bf16; one bf16 pass, a bf16 output.
//   * narrow (float32, Cout <= 8): the composed top's convs.
//   * narrow_bf16 (bfloat16 with a pass count, Cout <= 8): the composed
//     top's convs on the bf16 trunk, the narrow variant's products on
//     x.float() without the upcast, a float32 output.
//   * narrow_k (float32, Cin <= 4 and Cout 9 to 64): the first convs and
//     the last conv's dx in training.
//   * wide_f32 (every other float32 call): the trunk.
//
// Every float32 kernel reads x where it lies, as float32, and splits it on
// chip (narrow_bf16 reads bf16 x where it lies, and has nothing to split);
// each sums its products in the same order (chunks of input
// channels, then taps, then the passes in the TPU kernel's order) and with
// no atomics, so a call gives the same bits every run. Each one's design
// and what bounds it stand before its code.
//
// The wide kernel. The GEMM: M = the output pixels of one image, N = Cout,
// K = 9 taps x Cin. A CTA computes 128 MT pixels (a rectangle of output
// rows, 128 or 256 wide and 1-16 rows high, never across images) x BN
// output channels (64 or 128); MT is 2 at BN 128, else 1. Two consumer
// warpgroups each run wgmma m64nBNk16 on MT x 64 of the pixels, their
// accumulators in registers; one producer thread (warp 8) keeps a ring of
// 3-6 stages full with TMA loads (cp.async.bulk.tensor, mbarrier
// completion). A stage holds, for one tap (dy, dx) and one chunk of KC
// input channels (64, or all of a narrow layer's 16 or 32), the A tile
// (the input window shifted by the tap, 128 MT px x KC bf16, from a 4-D
// tensor map (C, W, H, N) at (c0, x0+dx-1, y0+dy-1, n)) and the B tile (the
// tap's weights, BN x KC bf16). TMA fills zeros outside the tensor,
// negative coordinates included: that is the conv's same padding and the
// Cin / Cout tails, with no padded copy of x and no bounds check in the
// loads. The tiles arrive in the swizzle of their row width (128, 64 or 32
// bytes), which the wgmma descriptors name. Bias and activation run on the
// accumulators in registers; stores are masked at the ragged pixel and
// Cout edges.
//
// What bounds it: at the flagship UNet's convs (batch 128) most 3x3 convs
// are 0.31 TFLOP against 0.25-1 GB of bf16 activations, so it is bound by
// the tensor cores' 989 TFLOP/s (0.31 ms) except the first layer (Cin 3),
// which is bound by its bytes (it writes about 1 GB). This design reaches
// the tensor cores, with the loads overlapped by the ring, and runs at
// 40-50 % of the bound (PERF.md). What it leaves: each tap reloads its
// window from L2 (9 A tiles a chunk, which is why it takes 256 px), and a
// CTA's epilogue does not overlap the next tile's loads (one tile a CTA).
// The bf16 trunk serves on cuDNN, so this kernel is on no main path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;   // and one producer warp

enum Act { kIdentity = 0, kRelu = 1, kLrelu = 2, kPrelu = 3 };

// Error codes beside cudaError_t's for the tensor-map encoder.
constexpr int kErrNoEncoder = 10001;         // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10002;            // cuTensorMapEncodeTiled refused a map

// BN output channels a CTA, KC input channels a stage (16, 32 or 64: rows
// of 32, 64 or 128 bytes, under the swizzle of that width; 16 and 32 serve
// layers with few input channels, such as the first, whose stages would
// otherwise be mostly TMA's zero fill), and MT m64 tiles a consumer
// warpgroup: 128 MT output pixels a CTA.
template <int BN, int KC, int MT>
struct Config {
  static constexpr int kBM = 128 * MT;
  static constexpr int kRowBytes = KC * 2;
  static constexpr int kATileBytes = kBM * kRowBytes;   // 16 KB at KC 64, MT 1
  static constexpr int kBTileBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  static constexpr int kStages = kStageBytes > 49152 ? 3 : (kStageBytes >= 24576 ? 4 : 6);
  // stages, then the full and empty barriers, plus slack to align to 1 KB
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A wait of more
// than about 2^36 cycles (some 40 s) means the ring is broken: trap, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 36)) {
      __trap();
    }
  }
}

// An arrival by the threads where ``pred`` holds, as one predicated
// instruction: no branch around it in a warpgroup's wgmma pipeline.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
               "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               :: "r"(bar), "r"(static_cast<uint32_t>(pred)) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of KC-channel rows (2 KC
// bytes) under the swizzle of that width, as TMA writes it: 8-row groups
// 16 KC bytes apart (stride byte offset), leading byte offset unused (1),
// layout type in bits 62-63 (1: 128-byte, 2: 64-byte, 3: 32-byte swizzle).
// A K step of 16 bf16 inside a row advances the start by 32 bytes.
template <int KC>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kLayout = KC == 64 ? 1 : (KC == 32 ? 2 : 3);
  constexpr uint64_t kGroupBytes = 8 * KC * 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((kGroupBytes >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma and its wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x 64, f32) += A(64 x 16, bf16) * B(16 x 64, bf16), both operands
// K-major in shared memory under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, bf16) * B(16 x 128, bf16), both operands
// K-major in shared memory under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_128(d, a, b);
  } else {
    wgmma_64(d, a, b);
  }
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kLrelu) return v >= 0.0f ? v : 0.01f * v;
  if (act == kPrelu) return v >= 0.0f ? v : slope * v;
  return v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// grid (N * tiles_y * tiles_x * n_cb), block 288: warpgroups 0 and 1
// multiply, the first thread of warp 8 loads. The Cout block varies
// fastest, so the CTAs that share an input window run together and find it
// in L2.
template <int BN, int KC, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_k3_kernel(__grid_constant__ const CUtensorMap x_map,
                  __grid_constant__ const CUtensorMap w_map,
                  const float* __restrict__ bias, const float* __restrict__ prelu,
                  __nv_bfloat16* __restrict__ out, int H, int W, int Cout, int n_chunks,
                  int last_ksteps, int tile_w_log2, int tile_h, int tiles_x, int tiles_y,
                  int n_cb, int act) {
  using Cfg = Config<BN, KC, MT>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle needs 1 KB-aligned tiles.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + Cfg::kStages * Cfg::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (Cfg::kStages + s); };

  const int tid = static_cast<int>(threadIdx.x);
  const int wg = tid / 128;
  int block = static_cast<int>(blockIdx.x);
  const int cb = block % n_cb;
  block /= n_cb;
  const int tx = block % tiles_x;
  block /= tiles_x;
  const int ty = block % tiles_y;
  const int n = block / tiles_y;
  const int tile_w = 1 << tile_w_log2;
  const int x0 = tx * tile_w;
  const int y0 = ty * tile_h;
  const int n0 = cb * BN;
  const int k_iters = 9 * n_chunks;          // chunk-major, then tap

  if (tid == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {                     // the producer warp
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < k_iters; ++it) {
        const int chunk = it / 9;
        const int tap = it - 9 * chunk;
        const int dy = tap / 3;
        const int dx = tap - 3 * dy;
        mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), Cfg::kStageBytes);
        const uint32_t a = base + stage * Cfg::kStageBytes;
        const uint32_t b = a + Cfg::kATileBytes;
        tma_load_4d(a, &x_map, full(stage), chunk * KC, x0 + dx - 1, y0 + dy - 1, n);
        tma_load_3d(b, &w_map, full(stage), chunk * KC, n0, tap);
        if (++stage == Cfg::kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // Consumer warpgroup ``wg``: pixels [64 MT wg, 64 MT (wg + 1)) of the
  // tile, MT m64 tiles with an accumulator each. Two named arrays, not one
  // of two dimensions: the compiler keeps these in registers.
  float acc0[BN / 2], acc1[MT > 1 ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (MT > 1 ? BN / 2 : 1); ++i) acc1[i] = 0.0f;
  auto fence_all = [&]() {
    fence_acc(acc0);
    if constexpr (MT > 1) fence_acc(acc1);
  };
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < k_iters; ++it) {
    const int ksteps = it / 9 == n_chunks - 1 ? last_ksteps : KC / 16;
    mbar_wait(full(stage), phase);
    const uint32_t a = base + stage * Cfg::kStageBytes + wg * MT * 64 * Cfg::kRowBytes;
    const uint32_t b = base + stage * Cfg::kStageBytes + Cfg::kATileBytes;
    fence_all();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      if (k < ksteps) {
        const uint64_t desc_b = smem_desc<KC>(b + 32 * k);
        wgmma_tile<BN>(acc0, smem_desc<KC>(a + 32 * k), desc_b);
        if constexpr (MT > 1) {
          wgmma_tile<BN>(acc1, smem_desc<KC>(a + 64 * Cfg::kRowBytes + 32 * k), desc_b);
        }
      }
    }
    wgmma_commit();
    fence_all();
    // One group stays in flight: the previous stage's products are done,
    // so its buffers go back to the producer.
    wgmma_wait<1>();
    fence_all();
    if (it > 0 && lane == 0) mbar_arrive(empty(prev));
    prev = stage;
    if (++stage == Cfg::kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  fence_all();

  // Accumulator layout of wgmma m64nNk16: thread (warp, lane) holds rows
  // 16 warp + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1) as
  // d[4 j + 2 i + e], i the row half, e the column.
  const bool pairs = (Cout % 2) == 0;
  auto store_tile = [&](const float (&d)[BN / 2], int tile) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = (wg * MT + tile) * 64 + warp * 16 + lane / 4 + 8 * i;
      const int y = y0 + (m >> tile_w_log2);
      const int x = x0 + (m & (tile_w - 1));
      if (y >= H || x >= W) continue;
      auto* row = out + ((static_cast<long long>(n) * H + y) * W + x) * Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
        if (c >= Cout) continue;
        const float v0 = activate(d[4 * j + 2 * i] + bias[c], act, prelu[c]);
        if (pairs) {
          store2(row + c, v0, activate(d[4 * j + 2 * i + 1] + bias[c + 1], act, prelu[c + 1]));
        } else {
          store1(row + c, v0);
          if (c + 1 < Cout) {
            store1(row + c + 1, activate(d[4 * j + 2 * i + 1] + bias[c + 1], act, prelu[c + 1]));
          }
        }
      }
    }
  };
  store_tile(acc0, 0);
  if constexpr (MT > 1) store_tile(acc1, 1);
}

// ---------------------------------------------------------------------------
// The narrow variant: float32 x, Cout <= 8 (the composed top's 256^2 64->1
// and 128^2 64->4 convs, the last conv in training, the studies' narrow
// models). Its products are the other float32 kernels', passes and all; its
// design is for a conv whose output is a sliver of its input, so the input's bytes are
// the bound:
//
//   * x is read once, as float32, where it lies: base pointer and four
//     element strides, so the model's NHWC views (of K3's own NHWC output,
//     or of NCHW memory) are read in place, without a copy or a split
//     launch. The CTA splits each value in registers, hi = bf16(v), lo =
//     bf16(v - hi) (round to nearest even), as it moves a chunk into the
//     split buffers.
//   * A CTA owns 16 x 32 output pixels of one image and walks Cin in chunks
//     of 16. A chunk's halo block (18 x 34 pixels) comes into a 2-stage
//     float32 ring as one TMA load (cp.async.bulk.tensor, 4-D tensor map of
//     x's own layout, mbarrier completion; TMA's zero fill outside the
//     tensor is the same padding and the Cin tail), issued by one thread a
//     chunk ahead. TMA takes x where C is contiguous (NHWC memory: box 16
//     channels x 34 x 18) or W is (the NHWC view of NCHW memory: box 40 x
//     18 x 16 channels), with 16-byte aligned strides; any other layout
//     comes in by predicated 4-byte cp.async. (Loaded by 16- and 4-byte
//     cp.async from all 256 threads, the loads alone ran at 46-61 % of the
//     byte bound on an H100 SXM.) All 9 taps read the chunk from shared
//     memory: the halo is loaded once per chunk, not once per tap.
//   * Products by mma.sync m16n8k16 (bf16 in, f32 accumulate): 16 pixels of
//     a row x 8 output channels x 16 input channels, so Cout 1 wastes 7/8 of
//     the N dimension (the wide kernel's BN 64 wasted 63/64). A warp owns 16
//     columns x 4 rows: each A fragment (ldmatrix from a split buffer, at
//     a 48-byte pixel pitch that keeps its rows off each other's banks) of
//     an input row and column shift serves the up to 3 output rows that
//     read it, so a warp loads 18 fragments a chunk (and 18 of x_lo from 2
//     passes) for 36 tap products a pass. (Packing the passes into fewer
//     mma, x_hi and x_lo of 8 channels in one k16 step and w_lo in the spare
//     columns, was measured and did not help: PERF.md.)
//   * Two sets of split buffers: in one iteration a CTA takes the products
//     of chunk i and splits chunk i + 1, half its warps in each order, so
//     the tensor cores and the split's shared-memory traffic overlap, with
//     one barrier an iteration.
//   * The weights go through one small kernel a call (split_hi_lo_fragments
//     _kernel): hi and lo in the B-fragment order of every chunk and tap, so
//     a thread takes its 9 taps of a chunk as 9 16-byte loads from L2.
//   * Persistent: one CTA an SM (206 KB of shared memory) walks tiles
//     blockIdx.x, + gridDim.x, ...; the ring runs on across tiles, so the
//     loads of the next tile overlap this tile's last products and its
//     epilogue. Each output is one CTA's, summed in a fixed order: no
//     atomics, the same bits every run.
//
// What bounds it (PERF.md, studies/narrow_ablation.py): 256^2 64->1 at
// batch 128 reads 2.15 GB (0.65 ms at 3.35 TB/s); its products at 3 passes
// are 0.23 TFLOP of mma.sync with N padded to 8. On an H100 SXM at 700 W,
// at 1 pass the kernel runs as fast as its loads alone (about 80 % of the
// byte bound on NHWC memory; the box of 160-byte rows of NCHW memory
// reaches 60 %); from 2 passes the products and the split of a chunk
// together outlast its loads.
namespace narrow {

constexpr int kTH = 16, kTW = 32;             // output rows and columns a tile
constexpr int kHaloH = kTH + 2;               // 18 halo rows
constexpr int kHaloW = kTW + 2;               // 34 halo columns in the split buffers
constexpr int kHaloPx = kHaloH * kHaloW;      // 612
// 40 floats a staged row, x0 - 4 .. x0 + 35: a TMA box starts 16-byte
// aligned in W (a box at x0 - 1 never completed)
constexpr int kRowW = kTW + 8;
constexpr int kRowX = 3;                      // the column of x0 - 1
constexpr int kKC = 16;                       // input channels a chunk (one k16 step)
constexpr int kStages = 2;                    // float32 ring
constexpr int kWarps = 8;                     // 2 across (16 columns) x 4 down (4 rows)
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kTH / (kWarps / 2); // 4 output rows a warp
constexpr int kPitch = kKC + 8;               // bf16 a pixel in a split buffer (48 B)
// How a chunk comes in (a launch's inputs pick one): a TMA box of rows
// into [channel][halo row][kRowW] (W contiguous), a TMA box of pixels into
// [halo pixel][kKC] (C contiguous), or 4-byte cp.async into the first
// layout (any other strides).
enum Load { kScalar = 0, kRows = 1, kChannels = 2 };
constexpr int kRowStageBytes = kKC * kHaloH * kRowW * 4;      // 46,080
constexpr int kPixStageBytes = kHaloPx * kKC * 4;             // 39,168
constexpr int kStageBytes = 45 * 1024;                        // either, 1 KB aligned
static_assert(kStageBytes >= kRowStageBytes && kStageBytes >= kPixStageBytes, "stage");
constexpr int kSplitBytes = kHaloPx * kPitch * 2;             // 29,376
// the ring, two sets of split buffers (hi, lo), the stages' barriers and
// slack to align to 1 KB
constexpr int kSmemBytes = kStages * kStageBytes + 4 * kSplitBytes + 8 * kStages + 1024;
constexpr int kMaxCout = 8;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D(16 x 8, f32) += A(16 x 16, bf16, row) * B(16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi = bf16(v0, v1), lo = bf16(v - hi), each a packed pair (v0 in the low half).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

struct XView {
  const float* p;
  long long sn, sh, sw, sc;                   // element strides of (N, H, W, Cin)
};

// One chunk's halo block of image n (output origin y0, x0; channels c0 ..
// c0 + 15) by 4-byte cp.async into a ring stage laid out [channel][halo
// row][kRowW], zeros outside the image and past Cin: the layouts TMA does
// not take. Channels go first where they are contiguous (c_fast), so that
// neighbouring threads read neighbouring addresses.
__device__ __forceinline__ void load_chunk_scalar(uint32_t stage, const XView& x, int n, int y0,
                                                  int x0, int c0, int H, int W, int Cin,
                                                  bool c_fast, int tid) {
  const float* img = x.p + n * x.sn;
  for (int e = tid; e < kKC * kHaloPx; e += kThreads) {
    const int c = c_fast ? e % kKC : e / kHaloPx;
    const int p = c_fast ? e / kKC : e % kHaloPx;
    const int hy = p / kHaloW, hx = p % kHaloW;
    const int y = y0 - 1 + hy, xx = x0 - 1 + hx, ch = c0 + c;
    const bool ok = y >= 0 && y < H && xx >= 0 && xx < W && ch < Cin;
    const float* src = ok ? img + y * x.sh + xx * x.sw + ch * x.sc : x.p;
    cp_async4(stage + ((c * kHaloH + hy) * kRowW + kRowX + hx) * 4, src, ok ? 4 : 0);
  }
}

// A staged chunk into the split buffers, [halo pixel][kPitch] bf16: hi,
// and lo when a pass reads it. From a [pixel][kKC] stage a thread takes 4
// channels of a pixel (a quarter warp reads 2 pixels' 128 contiguous
// bytes: a thread on 8 channels read at a 64-byte stride, 4 ways on the
// same banks, and took a third of the kernel's time), else 8 channels of a
// pixel, neighbouring threads on neighbouring pixels of a staged row; each
// writes its channels' hi and lo as one row segment of each buffer.
template <int kLoad, bool kLo>
__device__ __forceinline__ void split_chunk(const float* stage, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int tid) {
  if constexpr (kLoad == kChannels) {
    for (int i = tid; i < kHaloPx * (kKC / 4); i += kThreads) {
      const int p = i / (kKC / 4), q = i % (kKC / 4);
      const float4 v = *reinterpret_cast<const float4*>(stage + p * kKC + 4 * q);
      uint32_t h[2], l[2];
      split2(v.x, v.y, h[0], l[0]);
      split2(v.z, v.w, h[1], l[1]);
      *reinterpret_cast<uint2*>(hi + p * kPitch + 4 * q) = make_uint2(h[0], h[1]);
      if constexpr (kLo) {
        *reinterpret_cast<uint2*>(lo + p * kPitch + 4 * q) = make_uint2(l[0], l[1]);
      }
    }
  } else {
    for (int i = tid; i < 2 * kHaloPx; i += kThreads) {
      const int p = i % kHaloPx, half = i / kHaloPx;
      const int hy = p / kHaloW, hx = p % kHaloW;
      const float* s = stage + (half * 8 * kHaloH + hy) * kRowW + kRowX + hx;
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split2(s[2 * j * kHaloH * kRowW], s[(2 * j + 1) * kHaloH * kRowW], h[j], l[j]);
      }
      *reinterpret_cast<uint4*>(hi + p * kPitch + half * 8) = make_uint4(h[0], h[1], h[2], h[3]);
      if constexpr (kLo) {
        *reinterpret_cast<uint4*>(lo + p * kPitch + half * 8) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

// grid min(tiles, SMs), block 256: warp w owns output columns 16 (w % 2) ..
// + 15 and rows 4 (w / 2) .. + 3 of each of its CTA's tiles.
template <int kPasses, int kLoad>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_k3_narrow_kernel(__grid_constant__ const CUtensorMap x_map, XView x,
                         const uint4* __restrict__ frags,
                         const float* __restrict__ bias, const float* __restrict__ prelu,
                         float* __restrict__ out, int H, int W, int Cin, int Cout, int act,
                         int tiles_x, int tiles_y, int n_tiles, int n_chunks, int c_fast) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // TMA writes boxes to 128-byte aligned addresses: align the ring to 1 KB
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const uint32_t base = smem_u32(smem);
  // split buffers b = 0, 1: hi at 2 b kSplitBytes, lo kSplitBytes on
  __nv_bfloat16* splits = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  const uint32_t splits_u32 = smem_u32(splits);
  const uint32_t bars = base + kStages * kStageBytes + 4 * kSplitBytes;

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  const int warp_col = 16 * (warp % 2), warp_row = kWarpRows * (warp / 2);
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int total = my_tiles * n_chunks;

  auto tile_origin = [&](int it, int& n, int& y0, int& x0) {
    int t = static_cast<int>(blockIdx.x) + (it / n_chunks) * static_cast<int>(gridDim.x);
    x0 = (t % tiles_x) * kTW;
    t /= tiles_x;
    y0 = (t % tiles_y) * kTH;
    n = t / tiles_y;
  };
  // Chunk it into stage it % kStages: by TMA, one thread, completing on the
  // stage's barrier; or by every thread's cp.async, one group an iteration
  // (empty or not).
  auto issue = [&](int it) {
    const int stage = it % kStages;
    if constexpr (kLoad == kScalar) {
      if (it < total) {
        int n, y0, x0;
        tile_origin(it, n, y0, x0);
        load_chunk_scalar(base + stage * kStageBytes, x, n, y0, x0, (it % n_chunks) * kKC, H,
                          W, Cin, c_fast != 0, tid);
      }
      cp_async_commit();
    } else if (tid == 0 && it < total) {
      int n, y0, x0;
      tile_origin(it, n, y0, x0);
      const int c0 = (it % n_chunks) * kKC;
      const uint32_t bar = bars + 8u * stage, dst = base + stage * kStageBytes;
      if constexpr (kLoad == kRows) {
        mbar_expect_tx(bar, kRowStageBytes);
        tma_load_4d(dst, &x_map, bar, x0 - 1 - kRowX, y0 - 1, c0, n);
      } else {
        mbar_expect_tx(bar, kPixStageBytes);
        tma_load_4d(dst, &x_map, bar, c0, x0 - 1, y0 - 1, n);
      }
    }
  };
  // Wait until chunk it has landed in its stage, for this thread.
  auto landed = [&](int it) {
    if constexpr (kLoad == kScalar) {
      cp_async_wait<kStages - 1>();           // of the first two; later ones wait on all
    } else {
      mbar_wait(bars + 8u * (it % kStages), static_cast<uint32_t>(it / kStages) & 1u);
    }
  };

  if (kLoad != kScalar && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[kWarpRows][4];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  // ldmatrix row of this lane: pixel (lane % 16) of the 16, channels
  // 8 (lane / 16) .. + 7
  const uint32_t lane_off = ((lane % 16) * kPitch + (lane / 16) * 8) * 2;
  // Chunk it from its stage into split buffer it % 2.
  auto split_into = [&](int it) {
    __nv_bfloat16* hi = splits + (it % 2) * kSplitBytes;
    split_chunk<kLoad, (kPasses >= 2)>(
        reinterpret_cast<const float*>(smem + (it % kStages) * kStageBytes), hi,
        hi + kSplitBytes / 2, tid);
  };
  // Chunk it's products from split buffer it % 2, with the chunk's weights.
  auto products = [&](int it, const uint32_t (&bh)[9][2], const uint32_t (&bl)[9][2]) {
    const uint32_t hi_u32 = splits_u32 + (it % 2) * 2 * kSplitBytes;
    const uint32_t lo_u32 = hi_u32 + kSplitBytes;
#pragma unroll
    for (int r = 0; r < kWarpRows + 2; ++r) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t off = ((warp_row + r) * kHaloW + warp_col + dx) * kPitch * 2 + lane_off;
        uint32_t a[4], al[4];
        ldmatrix_x4(a, hi_u32 + off);
        if constexpr (kPasses >= 2) ldmatrix_x4(al, lo_u32 + off);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int i = r - dy;               // the output row that reads this input row at dy
          if (i >= 0 && i < kWarpRows) {
            const int t = 3 * dy + dx;
            // the passes in the TPU kernel's order
            mma_16816(acc[i], a, bh[t][0], bh[t][1]);
            if constexpr (kPasses == 3) mma_16816(acc[i], a, bl[t][0], bl[t][1]);
            if constexpr (kPasses >= 2) mma_16816(acc[i], al, bh[t][0], bh[t][1]);
          }
        }
      }
    }
  };

  // Iteration it takes the products of chunk it and splits chunk it + 1,
  // half the warps in each order, so that the tensor cores and the split's
  // loads and stores run at once; one barrier an iteration.
  issue(0);
  issue(1);
  landed(0);
  if constexpr (kLoad == kScalar) __syncthreads();   // everyone's copies of chunk 0
  split_into(0);
  for (int it = 0; it < total; ++it) {
    if constexpr (kLoad == kScalar) cp_async_wait<0>();   // this thread's copies of it + 1
    // Split buffer it % 2 is whole; buffer (it + 1) % 2 and stage it % 2
    // were last read in iteration it - 1.
    __syncthreads();
    issue(it + 2);
    const int chunk = it % n_chunks;
    uint32_t bh[9][2], bl[9][2];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint4 f = __ldg(frags + (chunk * 9 + t) * 32 + lane);
      bh[t][0] = f.x;
      bh[t][1] = f.y;
      bl[t][0] = f.z;
      bl[t][1] = f.w;
    }
    auto split_next = [&]() {
      if (it + 1 < total) {
        if constexpr (kLoad != kScalar) landed(it + 1);
        split_into(it + 1);
      }
    };
    if (warp % 2 == 0) {
      products(it, bh, bl);
      split_next();
    } else {
      split_next();
      products(it, bh, bl);
    }

    if (chunk == n_chunks - 1) {
      // Accumulator layout of m16n8: lane holds pixels lane / 4 (+ 8) of
      // the 16 and output channels 2 (lane % 4) (+ 1).
      int n, y0, x0;
      tile_origin(it, n, y0, x0);
      const int g = lane / 4, q = lane % 4;
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const int y = y0 + warp_row + i;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int xx = x0 + warp_col + g + 8 * half;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 2 * q + e;
            if (y < H && xx < W && o < Cout) {
              out[((static_cast<long long>(n) * H + y) * W + xx) * Cout + o] =
                  activate(acc[i][2 * half + e] + bias[o], act, prelu[o]);
            }
            acc[i][2 * half + e] = 0.0f;
          }
        }
      }
    }
  }
  if constexpr (kLoad == kScalar) cp_async_wait<0>();
}

// The weights (3, 3, Cin, Cout) float32 at element strides s0-s3 into the
// B fragments of mma m16n8k16 for each chunk of 16 input channels and tap:
// frags[(chunk * 9 + tap) * 32 + lane] = {hi(c, c + 1), hi(c + 8, c + 9),
// lo(c, c + 1), lo(c + 8, c + 9)} at output channel lane / 4, c = 16 chunk
// + 2 (lane % 4), the first of each pair in the low half; zeros past Cin
// and Cout.
__global__ void __launch_bounds__(256)
split_hi_lo_fragments_kernel(const float* __restrict__ w, long long s0, long long s1,
                             long long s2, long long s3, int Cin, int Cout, int n_chunks,
                             uint4* __restrict__ frags) {
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n_chunks * 9 * 32) return;
  const int lane = i % 32, tap = (i / 32) % 9, chunk = i / (32 * 9);
  const int o = lane / 4, c = chunk * kKC + 2 * (lane % 4);
  const float* t = w + (tap / 3) * s0 + (tap % 3) * s1 + o * s3;
  auto at = [&](int ch) { return o < Cout && ch < Cin ? t[ch * s2] : 0.0f; };
  uint32_t h[2], l[2];
  split2(at(c), at(c + 1), h[0], l[0]);
  split2(at(c + 8), at(c + 9), h[1], l[1]);
  frags[i] = make_uint4(h[0], h[1], l[0], l[1]);
}

}  // namespace narrow

// ---------------------------------------------------------------------------
// The narrow_bf16 variant: bfloat16 x with a pass count, Cout <= 8 (the
// composed top's 256^2 64->1 and 128^2 64->4 convs on the bf16 trunk of the
// mixed and balanced16 serving modes). It computes what the narrow variant
// computes on x.float(): a bf16 value is exact in float32, so that
// variant's split of it is x_hi = x and x_lo = 0, and of its passes only
// x_hi w_hi and, at 3, x_hi w_lo add anything. A kernel of its own beside
// the narrow one, whose pipeline is built around the split this one does
// not make:
//
//   * x is read once, as bf16, where it lies, by TMA: a 4-D tensor map of
//     x's own layout with C contiguous (box 16 channels x 34 x 34 pixels;
//     TMA's zero fill is the same padding and the Cin tail) under the
//     32-byte swizzle, which puts the 8 rows of each ldmatrix phase (8
//     neighbouring pixels' 16 bytes) on 8 distinct groups of banks. A view
//     TMA cannot take (C not contiguous, strides or base not 16-byte
//     multiples) goes to the narrow variant on x.float() (ops/conv.py).
//   * No split: ldmatrix feeds the A fragments straight from the ring
//     stage, and each tap product is mma(x, w_hi) and, at 3 passes, mma(x,
//     w_lo): 2 mma where the narrow variant runs 3, 1 where it runs 2.
//     The sum order is the narrow variant's (chunks of 16 input channels,
//     then taps, then the passes) less its x_lo products, which add exact
//     zeros: each output is the narrow variant's on x.float(), but for the
//     sign of a zero.
//   * A CTA owns 32 x 32 output pixels of one image and 8 consumer warps
//     (2 across x 4 down), each 16 columns x 8 rows: an A fragment of an
//     input row and column shift serves the up to 3 output rows that read
//     it, 30 fragments a chunk for 72 tap products. One producer warp keeps
//     a ring of kStages chunks in flight (full and empty mbarriers; no
//     block-wide barrier in the loop).
//   * The weights' B fragments are the narrow variant's
//     (split_hi_lo_fragments_kernel, one launch a call): 9 16-byte loads a
//     chunk from L2.
//   * Persistent: one CTA an SM walks tiles blockIdx.x, + gridDim.x, ...;
//     the ring runs on across tiles, so the next tile's loads overlap this
//     one's last products and its epilogue. No atomics: the same bits every
//     run.
//
// What bounds it: x's bytes, half the narrow variant's. 256^2 64->1 at
// batch 128 reads 1.07 GB (0.32 ms at 3.35 TB/s); its products at 3 passes
// are 0.15 TFLOP of mma.sync with N padded to 8.
namespace narrow_bf16 {

constexpr int kTW = 32;                       // output columns a tile
constexpr int kWarpRows = 8;                  // output rows a consumer warp
constexpr int kTH = 4 * kWarpRows;            // output rows a tile (4 warps down)
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kKC = 16;                       // input channels a chunk (one k16 step)
constexpr int kConsumers = 8;                 // 2 across (16 columns) x 4 down
constexpr int kThreads = 32 * (kConsumers + 1);   // and the producer warp
constexpr int kStageBytes = kHaloH * kHaloW * kKC * 2;   // 32 bytes a halo pixel
constexpr int kStagePitch = (kStageBytes + 1023) / 1024 * 1024;
constexpr int kStages = 4;
// the ring, its full and empty barriers, and slack to align to 1 KB
constexpr int kSmemBytes = kStages * kStagePitch + 2 * kStages * 8 + 1024;

// grid min(tiles, SMs), block 288: warps 0-7 multiply, warp w owning output
// columns 16 (w % 2) .. + 15 and rows kWarpRows (w / 2) .. + kWarpRows - 1
// of each of its CTA's tiles; the first thread of warp 8 loads. kWLo: the
// w_lo products (3 passes).
template <bool kWLo>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_k3_narrow_bf16_kernel(__grid_constant__ const CUtensorMap x_map,
                              const uint4* __restrict__ frags, const float* __restrict__ bias,
                              const float* __restrict__ prelu, float* __restrict__ out, int H,
                              int W, int Cout, int act, int tiles_x, int tiles_y, int n_tiles,
                              int n_chunks) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // TMA's swizzle repeats every 256 bytes of shared address: align the ring
  // to 1 KB, so that a stage's swizzle is that of its own offsets
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStagePitch;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  auto tile_origin = [&](int i, int& n, int& y0, int& x0) {
    int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    x0 = (t % tiles_x) * kTW;
    t /= tiles_x;
    y0 = (t % tiles_y) * kTH;
    n = t / tiles_y;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {                   // the producer: chunk it into stage it % kStages
    if (lane == 0) {
      for (int it = 0; it < my_tiles * n_chunks; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), (static_cast<uint32_t>(it / kStages) & 1u) ^ 1u);
        int n, y0, x0;
        tile_origin(it / n_chunks, n, y0, x0);
        mbar_expect_tx(full(s), kStageBytes);
        tma_load_4d(base + s * kStagePitch, &x_map, full(s), (it % n_chunks) * kKC, x0 - 1,
                    y0 - 1, n);
      }
    }
    return;
  }

  const int warp_col = 16 * (warp % 2), warp_row = kWarpRows * (warp / 2);
  // ldmatrix row of this lane: pixel lane % 16 of the fragment's 16, the
  // 16-byte half lane / 16 of its channels
  const int lane_px = lane % 16, lane_half = lane / 16;
  float acc[kWarpRows][4];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  int it = 0;
  for (int tile = 0; tile < my_tiles; ++tile) {
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++it) {
      uint32_t bh[9][2], bl[9][2];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const uint4 f = __ldg(frags + (chunk * 9 + t) * 32 + lane);
        bh[t][0] = f.x;
        bh[t][1] = f.y;
        bl[t][0] = f.z;
        bl[t][1] = f.w;
      }
      const int s = it % kStages;
      mbar_wait(full(s), static_cast<uint32_t>(it / kStages) & 1u);
      const uint32_t stage = base + s * kStagePitch;
#pragma unroll
      for (int r = 0; r < kWarpRows + 2; ++r) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // halo pixel p's 32 bytes, its two 16-byte halves swapped where
          // bit 2 of p is set (the 32-byte swizzle: address bit 4 ^= bit 7)
          const int p = (warp_row + r) * kHaloW + warp_col + dx + lane_px;
          uint32_t xa[4];
          narrow::ldmatrix_x4(xa, stage + p * 32 + ((lane_half ^ (p >> 2)) & 1) * 16);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int row = r - dy;           // the output row that reads this input row at dy
            if (row >= 0 && row < kWarpRows) {
              const int t = 3 * dy + dx;
              // the narrow variant's passes, less x_lo's
              narrow::mma_16816(acc[row], xa, bh[t][0], bh[t][1]);
              if constexpr (kWLo) narrow::mma_16816(acc[row], xa, bl[t][0], bl[t][1]);
            }
          }
        }
      }
      // this warp's reads of the stage are done: give it back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Accumulator layout of m16n8: lane holds pixels lane / 4 (+ 8) of the
    // 16 and output channels 2 (lane % 4) (+ 1).
    int n, y0, x0;
    tile_origin(tile, n, y0, x0);
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int y = y0 + warp_row + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = x0 + warp_col + g + 8 * half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = 2 * q + e;
          if (y < H && xx < W && o < Cout) {
            out[((static_cast<long long>(n) * H + y) * W + xx) * Cout + o] =
                activate(acc[i][2 * half + e] + bias[o], act, prelu[o]);
          }
          acc[i][2 * half + e] = 0.0f;
        }
      }
    }
  }
}

}  // namespace narrow_bf16

// ---------------------------------------------------------------------------
// The narrow_k variant:float32 x with Cin 1 to 4 and Cout 9 to 64 (the
// flagship's encoder0, 256^2 3->64; the dx of the last conv in training,
// 1->64; the channel modes' first convs, 1/2/4->64). Its products are the
// other variants', passes and all. At 3 passes encoder0 at batch 128 is
// 0.1 TFLOP (K packed to 32) against 2.25 GB, 96 % of them the float32
// output: a store kernel with a little arithmetic, bound by its bytes
// (0.67 ms at 3.35 TB/s). The wide kernel padded each tap's Cin to 16 (144
// K for 27 products), ran one 128-px tile a CTA and stored from the wgmma
// layout, and split x in a launch of its own; this design:
//
//   * packs taps x channels into K: GEMM row m is an output pixel, column
//     k = tap Cin + c, K = 9 Cin padded to the next multiple of 16 (16 for
//     Cin 1, 32 for 2 and 3, 48 for 4): one to three k16 steps of
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) over up to 8 n8 tiles.
//   * reads x once, as float32, where it lies (base pointer and four
//     element strides: NHWC memory, the NHWC view of NCHW memory, any
//     other): a block's halo (18 x 34 pixels x Cin) comes into shared
//     memory by predicated 4-byte cp.async, zeros outside the image, one
//     block ahead in a 2-stage ring. The input is 4 % of the bytes.
//   * builds each A fragment from the staged halo, not from 9 tap-shifted
//     loads: a thread's k columns are fixed, so it keeps their halo offsets
//     in registers and gathers 8 floats a k step, splitting them in
//     registers (hi = bf16(v), lo = bf16(v - hi)): no split launch for x.
//   * holds the weights for the whole run: one small kernel a call lays out
//     the K x 64 hi and lo halves as mma B fragments (at most 12 KB), and
//     each CTA copies them into shared memory once. (Held in each thread's
//     registers instead, they took the kernel past 128 registers, to one
//     CTA an SM, and it ran slower from 2 passes on.)
//   * is persistent (as many CTAs an SM as fit, two at 128 registers, each
//     walking 16 x 32-pixel blocks blockIdx.x, + gridDim.x, ...), and the
//     store is the kernel: a quad swaps halves of its accumulators (two
//     shuffles) so that each thread writes 16 contiguous bytes, a quad 64
//     bytes of a pixel's channels (a warp 8 pixels), straight from
//     registers; stores do not hold a warp, so a block's stores overlap the
//     next block's gathers and products. Whole 32-byte sectors, each
//     written once. Cout not a multiple of 4 takes 4-byte stores.
//   * no atomics, and Cin is never split across CTAs: the same bits every run.
//
// What bounds it (PERF.md, studies/narrow_ablation.py --kernel narrow_k):
// on an H100 SXM at 700 W, encoder0 at batch 128 runs at about three
// quarters of its byte bound at every pass count; the kernel with its
// products or its split cut out takes as long, with nothing but its stores
// it comes within about 5 % of the bound, and so it does without its halo
// loads: the 4-byte cp.async loads of the halo, 4 % of the bytes, cost the
// rest (a ring of 3 stages did not help, so it is not their latency).
namespace narrow_k {

constexpr int kTH = 16, kTW = 32;              // output rows and columns a block
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kMaxCin = 4, kMaxCout = 64;
constexpr int kNTiles = kMaxCout / 8;          // n8 tiles of the B fragments
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrips = kTH * kTW / 16;        // 16-pixel row strips a block: 32
constexpr int kStageFloats = kHaloH * kHaloW * kMaxCin;

// A block's halo (output origin y0, x0 of image n) by 4-byte cp.async into a
// stage laid out [halo row][halo column][Cin], zeros outside the image: a
// thread a halo pixel, its Cin channels in turn (neighbouring threads on
// neighbouring pixels: contiguous in NHWC memory at a stride of Cin, in
// NCHW memory along a row).
__device__ __forceinline__ void load_halo(uint32_t stage, const narrow::XView& x, int n, int y0,
                                          int x0, int H, int W, int Cin, int tid) {
  constexpr int kPx = kHaloH * kHaloW;
  const float* img = x.p + n * x.sn;
  for (int p = tid; p < kPx; p += kThreads) {
    const int hy = p / kHaloW, hx = p % kHaloW;
    const int y = y0 - 1 + hy, xx = x0 - 1 + hx;
    const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
    const float* src = ok ? img + y * x.sh + xx * x.sw : x.p;
    for (int c = 0; c < Cin; ++c) {
      narrow::cp_async4(stage + (p * Cin + c) * 4, ok ? src + c * x.sc : x.p, ok ? 4 : 0);
    }
  }
}

// A fragments of one k step from gathered values: v0 at pixel g, v1 at
// pixel g + 8, each at the thread's k columns 2q, 2q + 1, 2q + 8, 2q + 9.
__device__ __forceinline__ void split_a(const float (&v0)[4], const float (&v1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  narrow::split2(v0[0], v0[1], hi[0], lo[0]);
  narrow::split2(v1[0], v1[1], hi[1], lo[1]);
  narrow::split2(v0[2], v0[3], hi[2], lo[2]);
  narrow::split2(v1[2], v1[3], hi[3], lo[3]);
}

// grid: as many CTAs as fit on the SMs (at most one a block; two an SM
// at most 128 registers a thread), block 256: warp w takes strips w, w + 8,
// w + 16 and w + 24 of each block (strip s: row s / 2, columns 16 (s % 2)
// .. + 15).
// kKSteps k16 steps (K = 16 kKSteps).
template <int kPasses, int kKSteps>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_k3_narrow_k_kernel(narrow::XView x, const uint4* __restrict__ frags,
                           const float* __restrict__ bias, const float* __restrict__ prelu,
                           float* __restrict__ out, int H, int W, int Cin, int Cout, int act,
                           int tiles_x, int tiles_y, int n_tiles, int vec4) {
  __shared__ __align__(16) float halo[2][kStageFloats];
  __shared__ uint4 b_frags[kKSteps * kNTiles * 32];
  __shared__ float epi_bias[kMaxCout], epi_slope[kMaxCout];
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int n_out_tiles = (Cout + 7) / 8;
  if (tid < kMaxCout) {
    epi_bias[tid] = tid < Cout ? bias[tid] : 0.0f;
    epi_slope[tid] = tid < Cout ? prelu[tid] : 0.0f;
  }
  // The weights' B fragments (split_hi_lo_k_fragments_kernel), for the run:
  // a 16-byte load a k step and n8 tile from here, {hi, lo} of this lane's.
  for (int i = tid; i < kKSteps * kNTiles * 32; i += kThreads) b_frags[i] = frags[i];
  // This thread's k columns, 16 ks + 2q + {0, 1, 8, 9}, as halo offsets
  // from a pixel's own (tap (dy, dx), channel c); bit 4 ks + i of ``valid``
  // where k < 9 Cin (the rest of K is zeros).
  const int rowp = kHaloW * Cin;
  int off[kKSteps][4];
  uint32_t valid = 0;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * ks + 2 * q + (i & 1) + 8 * (i >> 1);
      const int tap = k / Cin, c = k - tap * Cin;
      off[ks][i] = tap < 9 ? (tap / 3) * rowp + (tap % 3) * Cin + c : 0;
      if (tap < 9) valid |= 1u << (4 * ks + i);
    }
  }

  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  auto origin = [&](int i, int& n, int& y0, int& x0) {
    int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    x0 = (t % tiles_x) * kTW;
    t /= tiles_x;
    y0 = (t % tiles_y) * kTH;
    n = t / tiles_y;
  };
  auto prefetch = [&](int i) {
    if (i < my_tiles) {
      int n, y0, x0;
      origin(i, n, y0, x0);
      load_halo(smem_u32(halo[i % 2]), x, n, y0, x0, H, W, Cin, tid);
    }
    narrow::cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < my_tiles; ++i) {
    prefetch(i + 1);
    narrow::cp_async_wait<1>();                // this thread's copies of block i
    __syncthreads();                           // everyone's
    int n, y0, x0;
    origin(i, n, y0, x0);
    const float* hs = halo[i % 2];
    for (int s = warp; s < kStrips; s += kWarps) {
      const int r = s / (kTW / 16), col0 = 16 * (s % (kTW / 16));
      if (y0 + r >= H || x0 + col0 >= W) continue;    // the whole strip is outside
      float acc[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      }
      const int base0 = r * rowp + (col0 + g) * Cin, base1 = base0 + 8 * Cin;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        float v0[4], v1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = (valid >> (4 * ks + i)) & 1u;
          v0[i] = ok ? hs[base0 + off[ks][i]] : 0.0f;
          v1[i] = ok ? hs[base1 + off[ks][i]] : 0.0f;
        }
        uint32_t ah[4], al[4];
        split_a(v0, v1, ah, al);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          if (nt < n_out_tiles) {
            const uint4 f = b_frags[(ks * kNTiles + nt) * 32 + lane];
            // the passes in the TPU kernel's order
            narrow::mma_16816(acc[nt], ah, f.x, f.y);
            if constexpr (kPasses == 3) narrow::mma_16816(acc[nt], ah, f.z, f.w);
            if constexpr (kPasses >= 2) narrow::mma_16816(acc[nt], al, f.x, f.y);
          }
        }
      }
      // Accumulator layout of m16n8: lane holds pixels g (+ 8) of the strip
      // and channels 8 nt + 2q (+ 1) as acc[nt][2 h + e].
      const int y = y0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = x0 + col0 + g + 8 * h;
        const bool px_ok = xx < W;
        float* row = out + ((static_cast<long long>(n) * H + y) * W + xx) * Cout;
        auto value = [&](int nt, int e) {
          const int c = 8 * nt + 2 * q + e;
          return activate(acc[nt][2 * h + e] + epi_bias[c], act, epi_slope[c]);
        };
        if (vec4) {
          // Tiles nt, nt + 1: an even lane writes channels 8 nt + 2q .. + 3
          // (its own pair and its odd partner's), an odd lane 8 (nt + 1) +
          // 2 (q - 1) .. + 3 (its even partner's pair and its own).
          const bool odd = q & 1;
#pragma unroll
          for (int nt = 0; nt < kNTiles; nt += 2) {
            const float v[2] = {value(nt, 0), value(nt, 1)};
            const float w[2] = {value(nt + 1, 0), value(nt + 1, 1)};
            const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : w[0], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : w[1], 1);
            const int c = 8 * (nt + (odd ? 1 : 0)) + 4 * (q >> 1);
            if (px_ok && c < Cout) {
              *reinterpret_cast<float4*>(row + c) =
                  odd ? make_float4(r0, r1, w[0], w[1]) : make_float4(v[0], v[1], r0, r1);
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * nt + 2 * q + e;
              if (px_ok && c < Cout) row[c] = value(nt, e);
            }
          }
        }
      }
    }
    __syncthreads();                           // stage i % 2 is free again
  }
  narrow::cp_async_wait<0>();
}

// The weights (3, 3, Cin, Cout) float32 at element strides s0-s3 into the
// B fragments of mma m16n8k16 over K = 16 k_steps (k = tap Cin + c) and
// 64 output channels: frags[(ks * 8 + nt) * 32 + lane] = {hi(k, k + 1),
// hi(k + 8, k + 9), lo(k, k + 1), lo(k + 8, k + 9)} at output channel
// 8 nt + lane / 4, k = 16 ks + 2 (lane % 4), the first of each pair in the
// low half; zeros past 9 Cin and Cout.
__global__ void __launch_bounds__(256)
split_hi_lo_k_fragments_kernel(const float* __restrict__ w, long long s0, long long s1,
                               long long s2, long long s3, int Cin, int Cout, int k_steps,
                               uint4* __restrict__ frags) {
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= k_steps * kNTiles * 32) return;
  const int lane = i % 32, nt = (i / 32) % kNTiles, ks = i / (32 * kNTiles);
  const int o = 8 * nt + lane / 4, k = 16 * ks + 2 * (lane % 4);
  auto at = [&](int kk) {
    if (o >= Cout || kk >= 9 * Cin) return 0.0f;
    const int tap = kk / Cin, c = kk - tap * Cin;
    return w[(tap / 3) * s0 + (tap % 3) * s1 + c * s2 + o * s3];
  };
  uint32_t h[2], l[2];
  narrow::split2(at(k), at(k + 1), h[0], l[0]);
  narrow::split2(at(k + 8), at(k + 9), h[1], l[1]);
  frags[i] = make_uint4(h[0], h[1], l[0], l[1]);
}

}  // namespace narrow_k

// ---------------------------------------------------------------------------
// The wide_f32 variant: float32 x with Cout > 8 outside narrow_k's range
// (the trunk of every f32-storage serving mode, 128^2 64->128 down to 8^2
// 512->512 and back up to 128^2 128->64, and the forward and dx of every
// trunk conv in training at a pass count). Its products are the other
// variants', in the order the wide kernel summed them before it took bf16
// alone (bit for bit its float32 results): chunks of 64 input channels,
// then the 9 taps, then the chunk's 4 k16 steps, then the passes in the TPU
// kernel's order. At batch 128 most of these convs are 0.31 TFLOP a pass
// against 0.5-1.6 GB of float32 x and output: bound by the tensor cores
// from 2 passes, and at 1 pass by the bytes where Cout is 128 or less. The
// wide kernel ran them on bf16 copies of x that a split launch wrote, with
// one TMA load of the window for each tap and one tile a CTA. This design:
//
//   * reads x once a chunk, as float32, where it lies: one TMA box of the
//     tile's halo ((rows + 2) x (cols + 2) pixels x 64 channels) from a 4-D
//     tensor map of NHWC memory (box of pixels) or of the NHWC view of NCHW
//     memory (box of rows, starting 16-byte aligned at x0 - 4 as the narrow
//     variant's); any other strides come in by predicated 4-byte cp.async.
//     TMA's zero fill is the same padding and the Cin tail. No copy of x is
//     written to device memory.
//   * splits x on chip, once a chunk: three warps turn the staged halo into
//     bf16 hi (and lo from 2 passes) buffers, [halo pixel][72] (a 144-byte
//     pitch keeps ldmatrix's 8 rows off each other's banks), two sets so
//     that chunk i + 1 is split while chunk i's products run.
//   * feeds the 9 taps from that one buffer: wgmma with A in registers
//     (m64nBNk16, BN 64 or 128), each lane's ldmatrix address its output
//     pixel's halo pixel shifted by the tap, so any tile shape works (16 x
//     8 pixels, 8 x 16, or two 8 x 8 images); B, the tap's weights (BN x 64
//     bf16 under the 128-byte swizzle), comes by TMA through a ring of 3-6
//     stages filled by one thread. The weights' hi and lo are one small
//     split launch a call (split_hi_lo_weights_kernel).
//   * is persistent: one CTA an SM walks work items (a 128-pixel tile and
//     a block of BN output channels, the block fastest so that neighbouring
//     CTAs share the tile's halo in L2) blockIdx.x, + gridDim.x, ...; the
//     rings run on across items, so the next item's first chunk is loaded
//     and split while this one's epilogue runs. BN is 64 where 128 would
//     leave more of the card idle on the last wave (small grids).
//   * stores from registers: a quad swaps halves of its accumulators so
//     that each thread writes 16 contiguous bytes (64 a quad: whole 32-byte
//     sectors), bias and activation applied on the way.
//   * no atomics, and Cin is never split across CTAs: the same bits every
//     run.
namespace wide_f32 {

constexpr int kKC = 64;                        // input channels a chunk
constexpr int kKSteps = kKC / 16;              // its k16 steps
constexpr int kPitch = kKC + 8;                // bf16 a halo pixel in a split buffer (144 B)
constexpr int kMaxHaloPx = 200;                // 18 x 10 (a 16 x 8 tile), 2 x 10 x 10 (two 8 x 8)
constexpr int kConsumers = 2;                  // warpgroups 0 and 1: the products and stores
constexpr int kSplitWarps = 3;                 // warps 9-11: x's loads and split
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kThreads = 128 * kConsumers + 32 + kSplitThreads;   // + warp 8: the weights
// A staged chunk: at most 200 pixels x 64 floats, or 64 channels x 10 rows
// x 24 floats (the box of rows of a 16 x 8 tile)
constexpr int kXStageBytes = 61440;
constexpr int kHalfBytes = kMaxHaloPx * kPitch * 2;   // a split buffer's hi (or lo): 28,800
constexpr int kSmemLimit = 232448;
// How a chunk comes in (a launch's inputs pick one).
enum Load { kScalar = 0, kRows = 1, kPixels = 2 };

// BN output channels an item and kPasses bf16 passes: the rings' sizes.
// One pass keeps two steps' products in flight (three sets of A registers)
// and so more weight stages; from 2 passes a set holds lo beside hi (and
// one step is in flight), and at 3 a weight stage holds w_lo beside w_hi.
template <int BN, int kPasses>
struct Cfg {
  static constexpr int kASets = kPasses == 1 ? 3 : 2;
  static constexpr int kWTileBytes = BN * kKC * 2;
  static constexpr int kWStageBytes = (kPasses == 3 ? 2 : 1) * kWTileBytes;
  static constexpr int kXStages = 1;
  static constexpr int kSetBytes = (kPasses >= 2 ? 2 : 1) * kHalfBytes;
  static constexpr int kSets = kPasses == 3 ? 1 : 2;
  static constexpr int kFixed = kXStages * kXStageBytes + kSets * kSetBytes + 256 + 1024;
  static constexpr int kFit = (kSmemLimit - kFixed) / kWStageBytes;
  static constexpr int kWStages = kFit > 6 ? 6 : kFit;
  static_assert(kWStages >= 2, "the weight ring needs two stages");
  // weight stages (1 KB aligned for the swizzle), x stages, split sets,
  // barriers, and slack to align the base to 1 KB
  static constexpr int kXOffset = kWStages * kWStageBytes;
  static constexpr int kSetOffset = kXOffset + kXStages * kXStageBytes;
  static constexpr int kBarOffset = kSetOffset + kSets * kSetBytes;
  static constexpr int kSmemBytes = kBarOffset + 256 + 1024;
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
};

// A launch's work items: tn images x th rows x tw columns of output pixels
// (128), tiles_x x tiles_y tiles an image group, n_cb blocks of BN output
// channels; n_chunks chunks of Cin. Every step loads the A registers of
// a_ksteps k16 steps: all kKSteps (a split set holds zeros past Cin, and
// the weights' stage too, so a ragged chunk's last steps add exact zeros),
// handed over at run time so that the loads stay predicated: with loads
// the compiler could see were unconditional, ptxas gave every A register
// set the same registers and waited for each wgmma before the next
// (WARPGROUP.DEPBAR after each), and a branch around each wgmma put a
// warpgroup arrive before each.
struct Geometry {
  int tw, th, tn, tiles_x, tiles_y, n_cb, n_items, n_chunks, a_ksteps;
};

// D(64 x BN, f32) += A(64 x 16, bf16, four registers a thread in the
// layout of mma m16n8k16's A, warp w of the warpgroup rows 16 w .. + 15) *
// B(16 x BN, bf16, K-major in shared memory under the 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_rs_128(d, a, b);
  } else {
    wgmma_rs_64(d, a, b);
  }
}

// Keeps the compiler from moving writes of the A registers across the
// asynchronous wgmma that reads them and its wait.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kKSteps][4]) {
#pragma unroll
  for (int k = 0; k < kKSteps; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i]) :: "memory");
  }
}

__device__ __forceinline__ void split_bar() {
  asm volatile("bar.sync 1, %0;" :: "n"(kSplitThreads) : "memory");
}

// Chunk c0 .. c0 + 63 of the halo of (n0, y0, x0) by 4-byte cp.async into a
// stage laid out [halo pixel][64] floats, zeros outside the images and past
// Cin: the layouts TMA does not take. Channels go first where they are
// contiguous, so that neighbouring threads read neighbouring addresses.
__device__ __forceinline__ void load_scalar(uint32_t stage, const narrow::XView& x, int n0, int y0,
                                            int x0, int c0, int N, int H, int W, int Cin,
                                            const Geometry& g, int st) {
  const int halo_w = g.tw + 2, halo_h = g.th + 2, px = g.tn * halo_h * halo_w;
  const bool c_fast = x.sc == 1;
  for (int e = st; e < px * kKC; e += kSplitThreads) {
    const int c = c_fast ? e % kKC : e / px;
    const int p = c_fast ? e / kKC : e % px;
    const int img = p / (halo_h * halo_w), hy = (p / halo_w) % halo_h, hx = p % halo_w;
    const int n = n0 + img, y = y0 - 1 + hy, xx = x0 - 1 + hx, ch = c0 + c;
    const bool ok = n < N && y >= 0 && y < H && xx >= 0 && xx < W && ch < Cin;
    const float* src = ok ? x.p + n * x.sn + y * x.sh + xx * x.sw + ch * x.sc : x.p;
    narrow::cp_async4(stage + (p * kKC + c) * 4, src, ok ? 4 : 0);
  }
}

// A staged chunk into a split set, [halo pixel][kPitch] bf16: hi, and lo
// when a pass reads it. From a [pixel][64] stage a thread takes 4 channels
// of a pixel (a warp reads 2 pixels' 512 contiguous bytes); from a box of
// rows ([image][channel][halo row][tw + 8], the halo's column hx at hx + 3)
// 8 channels of a pixel, neighbouring threads on neighbouring pixels.
template <bool kLo>
__device__ __forceinline__ void split_x(const float* stage, __nv_bfloat16* hi, int load,
                                        const Geometry& g, int st) {
  __nv_bfloat16* lo = hi + kHalfBytes / 2;
  const int halo_w = g.tw + 2, halo_h = g.th + 2, px = g.tn * halo_h * halo_w;
  if (load != kRows) {
    for (int i = st; i < px * (kKC / 4); i += kSplitThreads) {
      const int p = i / (kKC / 4), q = i % (kKC / 4);
      const float4 v = *reinterpret_cast<const float4*>(stage + p * kKC + 4 * q);
      uint32_t h[2], l[2];
      narrow::split2(v.x, v.y, h[0], l[0]);
      narrow::split2(v.z, v.w, h[1], l[1]);
      *reinterpret_cast<uint2*>(hi + p * kPitch + 4 * q) = make_uint2(h[0], h[1]);
      if constexpr (kLo) *reinterpret_cast<uint2*>(lo + p * kPitch + 4 * q) = make_uint2(l[0], l[1]);
    }
  } else {
    const int row_w = g.tw + 8, plane = halo_h * row_w;
    for (int i = st; i < px * (kKC / 8); i += kSplitThreads) {
      const int p = i % px, grp = i / px;
      const int img = p / (halo_h * halo_w), hy = (p / halo_w) % halo_h, hx = p % halo_w;
      const float* s = stage + (img * kKC + 8 * grp) * plane + hy * row_w + hx + 3;
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) narrow::split2(s[2 * j * plane], s[(2 * j + 1) * plane], h[j], l[j]);
      *reinterpret_cast<uint4*>(hi + p * kPitch + 8 * grp) = make_uint4(h[0], h[1], h[2], h[3]);
      if constexpr (kLo) {
        *reinterpret_cast<uint4*>(lo + p * kPitch + 8 * grp) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

// grid min(items, SMs), block 384: warpgroups 0 and 1 multiply and store,
// warp 8 loads the weights, warps 9-11 load and split x.
template <int BN, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_k3_wide_f32_kernel(__grid_constant__ const CUtensorMap x_map,
                           __grid_constant__ const CUtensorMap w_hi,
                           __grid_constant__ const CUtensorMap w_lo, narrow::XView x,
                           const float* __restrict__ bias, const float* __restrict__ prelu,
                           float* __restrict__ out, int N, int H, int W, int Cin, int Cout,
                           int act, Geometry g, int load, int vec4) {
  using C = Cfg<BN, kPasses>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // TMA's 128-byte swizzle needs the weight stages 1 KB aligned
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const uint32_t base = smem_u32(smem);
  const uint32_t x_ring = base + C::kXOffset, sets = base + C::kSetOffset;
  const uint32_t bars = base + C::kBarOffset;
  auto wfull = [&](int s) { return bars + 8u * s; };
  auto wempty = [&](int s) { return bars + 8u * (C::kWStages + s); };
  auto xfull = [&](int s) { return bars + 8u * (2 * C::kWStages + s); };
  auto sfull = [&](int s) { return bars + 8u * (2 * C::kWStages + C::kXStages + s); };
  auto sempty = [&](int s) {
    return bars + 8u * (2 * C::kWStages + C::kXStages + C::kSets + s);
  };

  const int tid = static_cast<int>(threadIdx.x);
  // the warp's index from lane 0, so that the compiler sees every role's
  // branch as uniform across the warp (and the warpgroup)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int my_items = (g.n_items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int n_steps = 9 * g.n_chunks;         // (chunk, tap) steps an item, chunk-major
  // Item i of this CTA: first image n0, rows from y0, columns from x0, the
  // block cb of BN output channels (fastest).
  auto origin = [&](int i, int& n0, int& y0, int& x0, int& cb) {
    int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    cb = t % g.n_cb;
    t /= g.n_cb;
    x0 = (t % g.tiles_x) * g.tw;
    t /= g.tiles_x;
    y0 = (t % g.tiles_y) * g.th;
    n0 = (t / g.tiles_y) * g.tn;
  };

  if (tid == 0) {
    for (int s = 0; s < C::kWStages; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), kConsumers * 4);   // one arrival per consumer warp
    }
    for (int s = 0; s < C::kXStages; ++s) mbar_init(xfull(s), 1);
    for (int s = 0; s < C::kSets; ++s) {
      mbar_init(sfull(s), 1);
      mbar_init(sempty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {               // the weights: one tap's tiles a stage
    if (lane == 0) {
      int step = 0;
      for (int i = 0; i < my_items; ++i) {
        int n0, y0, x0, cb;
        origin(i, n0, y0, x0, cb);
        for (int s = 0; s < n_steps; ++s, ++step) {
          const int chunk = s / 9, tap = s - 9 * chunk, ws = step % C::kWStages;
          const uint32_t dst = base + ws * C::kWStageBytes;
          mbar_wait(wempty(ws), ((step / C::kWStages) & 1u) ^ 1u);
          mbar_expect_tx(wfull(ws), C::kWStageBytes);
          tma_load_3d(dst, &w_hi, wfull(ws), chunk * kKC, cb * BN, tap);
          if constexpr (kPasses == 3) {
            tma_load_3d(dst + C::kWTileBytes, &w_lo, wfull(ws), chunk * kKC, cb * BN, tap);
          }
        }
      }
    }
    return;
  }

  if (warp > 4 * kConsumers) {                // x: a chunk's halo a stage, split into a set
    const int st = tid - (4 * kConsumers + 1) * 32;
    const int total = my_items * g.n_chunks;
    const int halo_px = g.tn * (g.th + 2) * (g.tw + 2);
    // Chunk j of this CTA into x stage j % kXStages: by TMA, one thread,
    // completing on the stage's barrier; or by every split thread's
    // cp.async, one group a chunk (empty or not).
    auto issue_x = [&](int j) {
      const uint32_t dst = x_ring + (j % C::kXStages) * kXStageBytes;
      const int c0 = (j % g.n_chunks) * kKC;
      int n0 = 0, y0 = 0, x0 = 0, cb = 0;
      if (j < total) origin(j / g.n_chunks, n0, y0, x0, cb);
      if (load == kScalar) {
        if (j < total) load_scalar(dst, x, n0, y0, x0, c0, N, H, W, Cin, g, st);
        narrow::cp_async_commit();
      } else if (st == 0 && j < total) {
        const uint32_t bar = xfull(j % C::kXStages);
        if (load == kPixels) {
          mbar_expect_tx(bar, halo_px * kKC * 4);
          tma_load_4d(dst, &x_map, bar, c0, x0 - 1, y0 - 1, n0);
        } else {
          mbar_expect_tx(bar, g.tn * kKC * (g.th + 2) * (g.tw + 8) * 4);
          tma_load_4d(dst, &x_map, bar, x0 - 4, y0 - 1, c0, n0);
        }
      }
    };
    // Wait until chunk j has landed, for every split thread.
    auto landed_x = [&](int j) {
      if (load == kScalar) {
        narrow::cp_async_wait<C::kXStages - 1>();
        split_bar();
      } else {
        mbar_wait(xfull(j % C::kXStages), static_cast<uint32_t>(j / C::kXStages) & 1u);
      }
    };
    for (int j = 0; j < C::kXStages; ++j) issue_x(j);
    for (int j = 0; j < total; ++j) {
      const int set = j % C::kSets;
      const float* stage = reinterpret_cast<const float*>(
          smem + C::kXOffset + (j % C::kXStages) * kXStageBytes);
      auto* hi = reinterpret_cast<__nv_bfloat16*>(smem + C::kSetOffset + set * C::kSetBytes);
      landed_x(j);
      mbar_wait(sempty(set), ((j / C::kSets) & 1u) ^ 1u);
      split_x<(kPasses >= 2)>(stage, hi, load, g, st);
      split_bar();                            // the set is whole and the stage free
      if (st == 0) mbar_arrive(sfull(set));
      issue_x(j + C::kXStages);
    }
    if (load == kScalar) narrow::cp_async_wait<0>();
    return;
  }

  // Consumer warpgroup wg: output pixels 64 wg .. + 63 of each item's tile,
  // warp cw rows 16 cw .. + 15 of those, as the A fragments of wgmma.
  const int wg = warp / 4, cw = warp % 4;
  const int tile_px = g.th * g.tw, halo_w = g.tw + 2;
  // This lane's ldmatrix row, output pixel m of the tile, and its halo
  // pixel; ldmatrix lanes 16-31 take channels 8 .. 15 of a k16 step.
  const int m = wg * 64 + cw * 16 + lane % 16;
  const uint32_t lane_off =
      ((((m / tile_px) * (g.th + 2) + (m % tile_px) / g.tw) * halo_w + m % g.tw) * kPitch +
       (lane / 16) * 8) * 2;
  float acc[BN / 2];
  // kASets sets of A registers, one a step in flight (hi, and lo when a
  // pass reads it)
  uint32_t ah[C::kASets][kKSteps][4] = {};
  uint32_t al[kPasses >= 2 ? C::kASets : 1][kKSteps][4] = {};
  int step = 0, chunk_seq = 0, released = 0;
  // Give the weight stages of steps ``released`` .. ``last`` back to the
  // producer (their products are done).
  auto release_upto = [&](int last) {
    for (; released <= last; ++released) {
      mbar_arrive_if(wempty(released % C::kWStages), lane == 0);
    }
  };
  // Step s of an item (chunk s / 9, tap s % 9), in A register set u: A of
  // the tap from the chunk's split set into registers, the products with
  // the tap's weight stage; then at most kASets - 1 steps' products are in
  // flight, so the set the next step loads into (u + 1) is free, and so is
  // the weight stage of the step kASets - 1 back.
  auto run_step = [&](int s, auto u) {
    constexpr int kU = decltype(u)::value, kNext = (kU + 1) % C::kASets;
    constexpr int kLo = kPasses >= 2 ? kU : 0, kLoNext = kPasses >= 2 ? kNext : 0;
    const int chunk = s / 9, tap = s - 9 * chunk;
    const int set = chunk_seq % C::kSets;
    if (tap == 0) mbar_wait(sfull(set), static_cast<uint32_t>(chunk_seq / C::kSets) & 1u);
    const int ws = step % C::kWStages;
    mbar_wait(wfull(ws), static_cast<uint32_t>(step / C::kWStages) & 1u);
    const uint32_t a = sets + set * C::kSetBytes + lane_off +
                       ((tap / 3) * halo_w + tap % 3) * kPitch * 2;
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      if (k < g.a_ksteps) {
        narrow::ldmatrix_x4(ah[kU][k], a + 32 * k);
        if constexpr (kPasses >= 2) narrow::ldmatrix_x4(al[kLo][k], a + kHalfBytes + 32 * k);
      }
    }
    if (tap == 8) {                           // the chunk's last reads of its set
      __syncwarp();
      mbar_arrive_if(sempty(set), lane == 0);
      ++chunk_seq;
    }
    const uint32_t b_hi = base + ws * C::kWStageBytes, b_lo = b_hi + C::kWTileBytes;
    fence_acc(acc);
    fence_a(ah[kU]);
    if constexpr (kPasses >= 2) fence_a(al[kLo]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      // the passes in the TPU kernel's order
      wgmma_rs<BN>(acc, ah[kU][k], smem_desc<kKC>(b_hi + 32 * k));
      if constexpr (kPasses == 3) wgmma_rs<BN>(acc, ah[kU][k], smem_desc<kKC>(b_lo + 32 * k));
      if constexpr (kPasses >= 2) wgmma_rs<BN>(acc, al[kLo][k], smem_desc<kKC>(b_hi + 32 * k));
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<C::kASets - 1>();
    fence_acc(acc);
    fence_a(ah[kNext]);
    if constexpr (kPasses >= 2) fence_a(al[kLoNext]);
    release_upto(step - (C::kASets - 1));
    ++step;
  };

  const int g4 = lane / 4, q = lane % 4;
  for (int i = 0; i < my_items; ++i) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
    for (int s = 0; s < n_steps; s += C::kASets) {
      run_step(s, std::integral_constant<int, 0>());
      if (s + 1 < n_steps) run_step(s + 1, std::integral_constant<int, 1>());
      if constexpr (C::kASets == 3) {
        if (s + 2 < n_steps) run_step(s + 2, std::integral_constant<int, 2>());
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release_upto(step - 1);

    // Accumulator layout of wgmma m64nNk16: thread (cw, lane) holds rows
    // 16 cw + g4 (+ 8) and columns 8 j + 2 q (+ 1) as acc[4 j + 2 h + e],
    // h the row half, e the column.
    int n0, y0, x0, cb;
    origin(i, n0, y0, x0, cb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = wg * 64 + cw * 16 + g4 + 8 * h;
      const int n = n0 + mm / tile_px, y = y0 + (mm % tile_px) / g.tw, xx = x0 + mm % g.tw;
      const bool px_ok = n < N && y < H && xx < W;
      float* row = out + ((static_cast<long long>(n) * H + y) * W + xx) * Cout;
      // Bias and slope loaded without a branch (the index clamped to the
      // last channel), so that the compiler batches the loads; the
      // activation as selects: v >= 0 ? v : s v, s 1 for identity, 0.01
      // for lrelu, the channel's slope for prelu; relu max(v, 0).
      auto value = [&](int j, int e) {
        const int c = cb * BN + 8 * j + 2 * q + e, cc = c < Cout ? c : Cout - 1;
        const float v = acc[4 * j + 2 * h + e] + __ldg(bias + cc);
        const float slope = act == kPrelu ? __ldg(prelu + cc) : (act == kLrelu ? 0.01f : 1.0f);
        return act == kRelu ? fmaxf(v, 0.0f) : (v >= 0.0f ? v : slope * v);
      };
      if (vec4) {
        // Column blocks j, j + 1: an even lane writes channels 8 j + 2 q ..
        // + 3 (its own pair and its odd partner's), an odd lane 8 (j + 1) +
        // 2 (q - 1) .. + 3 (its even partner's pair and its own).
        const bool odd = q & 1;
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const float v[2] = {value(j, 0), value(j, 1)};
          const float w[2] = {value(j + 1, 0), value(j + 1, 1)};
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : w[0], 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : w[1], 1);
          const int c = cb * BN + 8 * (j + (odd ? 1 : 0)) + 4 * (q >> 1);
          if (px_ok && c < Cout) {
            *reinterpret_cast<float4*>(row + c) =
                odd ? make_float4(r0, r1, w[0], w[1]) : make_float4(v[0], v[1], r0, r1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = cb * BN + 8 * j + 2 * q + e;
            if (px_ok && c < Cout) row[c] = value(j, e);
          }
        }
      }
    }
  }
}

// The weights (3, 3, Cin, Cout) float32 at element strides s0-s3 into the
// wide_f32 kernel's B operand: hi (and lo, when not null) (9, Cout, Cin_p)
// bf16, K-major, hi = bf16(w), lo = bf16(w - hi), zeros in [Cin, Cin_p). A
// block turns a 32 x 32 tile (input x output channels) of one tap through
// shared memory, so that both its reads and its writes run along a row.
__global__ void __launch_bounds__(256)
split_hi_lo_weights_kernel(const float* __restrict__ w, long long s0, long long s1, long long s2,
                           long long s3, int Cin, int Cout, int Cin_p,
                           __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int tap = static_cast<int>(blockIdx.z);
  const int c0 = static_cast<int>(blockIdx.x) * 32, o0 = static_cast<int>(blockIdx.y) * 32;
  const int tx = static_cast<int>(threadIdx.x), ty = static_cast<int>(threadIdx.y);
  const float* t = w + (tap / 3) * s0 + (tap % 3) * s1;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, o = o0 + tx;
    tile[r][tx] = c < Cin && o < Cout ? t[c * s2 + o * s3] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int o = o0 + r, c = c0 + tx;
    if (o < Cout && c < Cin_p) {
      const float v = tile[tx][r];
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      const long long at = (static_cast<long long>(tap) * Cout + o) * Cin_p + c;
      hi[at] = h;
      if (lo != nullptr) lo[at] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

}  // namespace wide_f32

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so the library needs no -lcuda.
EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeFn>(p);
    }
  }
  return fn;
}

// A bf16 tensor map with zero fill outside the tensor, its box's rows
// swizzled at their width (box[0] of 16, 32 or 64 elements). dims and box
// innermost first; strides in bytes of dims 1..rank-1.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box[0] == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                   strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A float32 tensor map of rank 4 with zero fill outside the tensor and no
// swizzle; dims and box innermost first, strides in bytes of dims 1..3.
bool encode_f32(CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                   strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kPasses, int kLoad>
int launch_narrow(const CUtensorMap& map, const narrow::XView& x, const uint4* frags,
                  const float* bias, const float* prelu, float* out, int N, int H, int W,
                  int Cin, int Cout, int act, int n_chunks, int c_fast, cudaStream_t stream) {
  auto kernel = narrow::conv3x3_k3_narrow_kernel<kPasses, kLoad>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         narrow::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + narrow::kTW - 1) / narrow::kTW,
            tiles_y = (H + narrow::kTH - 1) / narrow::kTH;
  const int n_tiles = N * tiles_x * tiles_y;
  const unsigned grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, narrow::kThreads, narrow::kSmemBytes, stream>>>(
      map, x, frags, bias, prelu, out, H, W, Cin, Cout, act, tiles_x, tiles_y, n_tiles, n_chunks,
      c_fast);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWLo>
int launch_narrow_bf16(const CUtensorMap& map, const uint4* frags, const float* bias,
                       const float* prelu, float* out, int N, int H, int W, int Cout, int act,
                       int n_chunks, cudaStream_t stream) {
  auto kernel = narrow_bf16::conv3x3_k3_narrow_bf16_kernel<kWLo>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         narrow_bf16::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + narrow_bf16::kTW - 1) / narrow_bf16::kTW,
            tiles_y = (H + narrow_bf16::kTH - 1) / narrow_bf16::kTH;
  const long long n_tiles = static_cast<long long>(N) * tiles_x * tiles_y;
  if (n_tiles * n_chunks > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, narrow_bf16::kThreads, narrow_bf16::kSmemBytes, stream>>>(
      map, frags, bias, prelu, out, H, W, Cout, act, tiles_x, tiles_y,
      static_cast<int>(n_tiles), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int kPasses, int kKSteps>
int launch_narrow_k(const narrow::XView& x, const uint4* frags, const float* bias,
                    const float* prelu, float* out, int N, int H, int W, int Cin, int Cout,
                    int act, int vec4, cudaStream_t stream) {
  auto kernel = narrow_k::conv3x3_k3_narrow_k_kernel<kPasses, kKSteps>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, narrow_k::kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + narrow_k::kTW - 1) / narrow_k::kTW,
            tiles_y = (H + narrow_k::kTH - 1) / narrow_k::kTH;
  const long long n_tiles = static_cast<long long>(N) * tiles_x * tiles_y;
  if (n_tiles > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(n_tiles < fit ? n_tiles : fit);
  kernel<<<grid, narrow_k::kThreads, 0, stream>>>(x, frags, bias, prelu, out, H, W, Cin, Cout,
                                                  act, tiles_x, tiles_y,
                                                  static_cast<int>(n_tiles), vec4);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int kPasses>
int launch_wide_f32(const CUtensorMap* maps, const narrow::XView& x, const float* bias,
                    const float* prelu, float* out, int N, int H, int W, int Cin, int Cout,
                    int act, const wide_f32::Geometry& g, int load, int vec4, int sms,
                    cudaStream_t stream) {
  using C = wide_f32::Cfg<BN, kPasses>;
  auto kernel = wide_f32::conv3x3_k3_wide_f32_kernel<BN, kPasses>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(g.n_items < sms ? g.n_items : sms);
  kernel<<<grid, wide_f32::kThreads, C::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], x, bias, prelu, out, N, H, W, Cin, Cout, act, g, load, vec4);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int KC, int MT>
int launch(const CUtensorMap* maps, const float* bias, const float* prelu, void* out, int N,
           int H, int W, int Cout, int n_chunks, int last_ksteps, int tile_w_log2, int tile_h,
           int act, cudaStream_t stream) {
  using Cfg = Config<BN, KC, MT>;
  auto kernel = conv3x3_k3_kernel<BN, KC, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + (1 << tile_w_log2) - 1) >> tile_w_log2;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int n_cb = (Cout + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(N) * tiles_y * tiles_x * n_cb);
  kernel<<<grid, kThreads, Cfg::kSmemBytes, stream>>>(
      maps[0], maps[1], bias, prelu, static_cast<__nv_bfloat16*>(out), H, W, Cout, n_chunks,
      last_ksteps, tile_w_log2, tile_h, tiles_x, tiles_y, n_cb, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3's wide kernel on ``stream`` and returns cudaGetLastError()
// (or one of the kErr codes above): a launch the runtime refuses never
// runs, and only this call reports it. x is (N, H, W, Cin_p) bf16 and w
// (9, Cout, Cin_p) bf16, Cin_p a multiple of 16, both 16-byte aligned; one
// bf16 pass, a bf16 output; bias and prelu are f32 (Cout,).
int conv3x3_k3(const void* x, const void* w, const float* bias, const float* prelu, void* out,
               int N, int H, int W, int Cin_p, int Cout, int act, void* stream) {
  if (encoder() == nullptr) return kErrNoEncoder;
  if (Cin_p % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int BN = Cout > 64 ? 128 : 64;
  // Channels a stage: all of Cin_p when it is 16 or 32 (narrow layers at
  // BN 64, such as the first), else chunks of 64.
  const int KC = BN == 64 && Cin_p <= 32 ? Cin_p : 64;
  // Pixels a CTA: 256 at BN 128 (each A tile feeds twice the products, for
  // less L2 traffic a FLOP), else 128; as tile_h rows of tile_w, tile_w the
  // smallest power of two in [16, 128] that covers W.
  const int MT = BN == 128 ? 2 : 1;
  int tile_w_log2 = 4;
  while ((1 << tile_w_log2) < W && tile_w_log2 < 7) ++tile_w_log2;
  const int tile_w = 1 << tile_w_log2;
  const int tile_h = 128 * MT / tile_w;
  const cuuint64_t row = static_cast<cuuint64_t>(Cin_p) * 2;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cin_p), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t x_strides[3] = {row, row * W, row * W * H};
  const cuuint32_t x_box[4] = {static_cast<cuuint32_t>(KC), static_cast<cuuint32_t>(tile_w),
                               static_cast<cuuint32_t>(tile_h), 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(Cin_p), static_cast<cuuint64_t>(Cout), 9};
  const cuuint64_t w_strides[2] = {row, row * Cout};
  const cuuint32_t w_box[3] = {static_cast<cuuint32_t>(KC), static_cast<cuuint32_t>(BN), 1};
  CUtensorMap maps[2];
  if (!encode(&maps[0], x, 4, x_dims, x_strides, x_box) ||
      !encode(&maps[1], w, 3, w_dims, w_strides, w_box)) {
    return kErrEncode;
  }
  const int n_chunks = (Cin_p + KC - 1) / KC;
  const int last_ksteps = (Cin_p - (n_chunks - 1) * KC) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(BN_, KC_, MT_)                                                             \
  launch<BN_, KC_, MT_>(maps, bias, prelu, out, N, H, W, Cout, n_chunks, last_ksteps,      \
                        tile_w_log2, tile_h, act, s)
  if (BN == 128) return K3_LAUNCH(128, 64, 2);
  if (KC == 16) return K3_LAUNCH(64, 16, 1);
  if (KC == 32) return K3_LAUNCH(64, 32, 1);
  return K3_LAUNCH(64, 64, 1);
#undef K3_LAUNCH
}

// K3's narrow variant on ``stream``: float32 x (N, H, W, Cin) at element
// strides (sn, sh, sw, sc), any layout, read in place; the weights (3, 3,
// Cin, Cout) float32 at element strides (w0, w1, w2, w3), Cout 1 to 8;
// ``passes`` 1 to 3 as conv3x3_k3 takes them; out (N, H, W, Cout) float32
// contiguous. ``frags`` is scratch of ceil(Cin / 16) * 9 * 512 bytes,
// 16-byte aligned, for the weights' split (split_hi_lo_fragments_kernel,
// launched first). Returns cudaGetLastError() after each launch.
int conv3x3_k3_narrow(const float* x, long long sn, long long sh, long long sw, long long sc,
                      const float* w, long long w0, long long w1, long long w2, long long w3,
                      void* frags, const float* bias, const float* prelu, float* out, int N,
                      int H, int W, int Cin, int Cout, int act, int passes, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cout > narrow::kMaxCout || passes < 1 ||
      passes > 3 || reinterpret_cast<uintptr_t>(frags) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (Cin + narrow::kKC - 1) / narrow::kKC;
  const int work = n_chunks * 9 * 32;
  auto* f = static_cast<uint4*>(frags);
  narrow::split_hi_lo_fragments_kernel<<<(work + 255) / 256, 256, 0, s>>>(
      w, w0, w1, w2, w3, Cin, Cout, n_chunks, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA where W or C is contiguous and the other strides and the base are
  // 16-byte multiples (its global strides must be)
  const bool aligned = sh % 4 == 0 && sn % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool rows = aligned && sw == 1 && W % 4 == 0 && (sc % 4 == 0 || Cin == 1);
  const bool channels = !rows && aligned && sc == 1 && Cin % 4 == 0 && sw % 4 == 0;
  CUtensorMap map{};
  if (rows || channels) {
    if (encoder() == nullptr) return kErrNoEncoder;
    const cuuint64_t b = 4;   // bytes a float
    const cuuint64_t n = static_cast<cuuint64_t>(N), h = static_cast<cuuint64_t>(H),
                     w_ = static_cast<cuuint64_t>(W), c = static_cast<cuuint64_t>(Cin);
    const cuuint64_t row_dims[4] = {w_, h, c, n}, pix_dims[4] = {c, w_, h, n};
    const cuuint64_t row_strides[3] = {sh * b, (Cin == 1 ? h * w_ : sc) * b, sn * b};
    const cuuint64_t pix_strides[3] = {sw * b, sh * b, sn * b};
    const cuuint32_t row_box[4] = {narrow::kRowW, narrow::kHaloH, narrow::kKC, 1};
    const cuuint32_t pix_box[4] = {narrow::kKC, narrow::kHaloW, narrow::kHaloH, 1};
    const bool ok = rows ? encode_f32(&map, x, row_dims, row_strides, row_box)
                         : encode_f32(&map, x, pix_dims, pix_strides, pix_box);
    if (!ok) return kErrEncode;
  }
  const narrow::XView view{x, sn, sh, sw, sc};
  const int c_fast = sc == 1 ? 1 : 0;
#define K3_NARROW(LOAD_)                                                                      \
  (passes == 1   ? launch_narrow<1, LOAD_>(map, view, f, bias, prelu, out, N, H, W, Cin,      \
                                           Cout, act, n_chunks, c_fast, s)                    \
   : passes == 2 ? launch_narrow<2, LOAD_>(map, view, f, bias, prelu, out, N, H, W, Cin,      \
                                           Cout, act, n_chunks, c_fast, s)                    \
                 : launch_narrow<3, LOAD_>(map, view, f, bias, prelu, out, N, H, W, Cin,      \
                                           Cout, act, n_chunks, c_fast, s))
  if (rows) return K3_NARROW(narrow::kRows);
  if (channels) return K3_NARROW(narrow::kChannels);
  return K3_NARROW(narrow::kScalar);
#undef K3_NARROW
}

// K3's narrow_bf16 variant on ``stream``: bfloat16 x (N, H, W, Cin) at
// element strides (sn, sh, sw, sc), read in place by TMA, so sc must be 1
// and sn, sh, sw multiples of 8 (16 bytes), the base 16-byte aligned; the
// weights (3, 3, Cin, Cout) float32 at element strides (w0, w1, w2, w3),
// Cout 1 to 8; ``passes`` 1 to 3 as conv3x3_k3_narrow takes them on
// x.float(), with the same float32 result; out (N, H, W, Cout) float32
// contiguous. ``frags`` is scratch of ceil(Cin / 16) * 9 * 512 bytes,
// 16-byte aligned, for the weights' split (split_hi_lo_fragments_kernel,
// launched first). Returns cudaGetLastError() after each launch (or one of
// the kErr codes).
int conv3x3_k3_narrow_bf16(const void* x, long long sn, long long sh, long long sw,
                           long long sc, const float* w, long long w0, long long w1,
                           long long w2, long long w3, void* frags, const float* bias,
                           const float* prelu, float* out, int N, int H, int W, int Cin,
                           int Cout, int act, int passes, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cout > narrow::kMaxCout || passes < 1 ||
      passes > 3 || reinterpret_cast<uintptr_t>(frags) % 16 != 0 || sc != 1 || sw % 8 != 0 ||
      sh % 8 != 0 || sn % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) return kErrNoEncoder;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (Cin + narrow_bf16::kKC - 1) / narrow_bf16::kKC;
  const int work = n_chunks * 9 * 32;
  auto* f = static_cast<uint4*>(frags);
  narrow::split_hi_lo_fragments_kernel<<<(work + 255) / 256, 256, 0, s>>>(
      w, w0, w1, w2, w3, Cin, Cout, n_chunks, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t b = 2;   // bytes a bf16
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {sw * b, sh * b, sn * b};
  const cuuint32_t box[4] = {narrow_bf16::kKC, narrow_bf16::kHaloW, narrow_bf16::kHaloH, 1};
  CUtensorMap map{};
  if (!encode(&map, x, 4, dims, strides, box)) return kErrEncode;   // box[0] 16: 32-byte swizzle
  return passes == 3 ? launch_narrow_bf16<true>(map, f, bias, prelu, out, N, H, W, Cout, act,
                                                n_chunks, s)
                     : launch_narrow_bf16<false>(map, f, bias, prelu, out, N, H, W, Cout, act,
                                                 n_chunks, s);
}

// K3's narrow_k variant on ``stream``: float32 x (N, H, W, Cin) at element
// strides (sn, sh, sw, sc), any layout, read in place, Cin 1 to 4; the
// weights (3, 3, Cin, Cout) float32 at element strides (w0, w1, w2, w3),
// Cout 1 to 64; ``passes`` 1 to 3 as conv3x3_k3 takes them; out (N, H, W,
// Cout) float32 contiguous. ``frags`` is scratch of ceil(9 Cin / 16) * 4096
// bytes, 16-byte aligned, for the weights' split
// (split_hi_lo_k_fragments_kernel, launched first). Returns
// cudaGetLastError() after each launch.
int conv3x3_k3_narrow_k(const float* x, long long sn, long long sh, long long sw, long long sc,
                        const float* w, long long w0, long long w1, long long w2, long long w3,
                        void* frags, const float* bias, const float* prelu, float* out, int N,
                        int H, int W, int Cin, int Cout, int act, int passes, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cin > narrow_k::kMaxCin || Cout < 1 ||
      Cout > narrow_k::kMaxCout || passes < 1 || passes > 3 ||
      reinterpret_cast<uintptr_t>(frags) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_steps = (9 * Cin + 15) / 16;
  const int work = k_steps * narrow_k::kNTiles * 32;
  auto* f = static_cast<uint4*>(frags);
  narrow_k::split_hi_lo_k_fragments_kernel<<<(work + 255) / 256, 256, 0, s>>>(
      w, w0, w1, w2, w3, Cin, Cout, k_steps, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const narrow::XView view{x, sn, sh, sw, sc};
  // 16-byte stores where every pixel's channels start 16-byte aligned
  const int vec4 = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
#define K3_NARROW_K(KS_)                                                                        \
  (passes == 1   ? launch_narrow_k<1, KS_>(view, f, bias, prelu, out, N, H, W, Cin, Cout, act,  \
                                           vec4, s)                                             \
   : passes == 2 ? launch_narrow_k<2, KS_>(view, f, bias, prelu, out, N, H, W, Cin, Cout, act,  \
                                           vec4, s)                                             \
                 : launch_narrow_k<3, KS_>(view, f, bias, prelu, out, N, H, W, Cin, Cout, act,  \
                                           vec4, s))
  if (k_steps == 1) return K3_NARROW_K(1);
  if (k_steps == 2) return K3_NARROW_K(2);
  return K3_NARROW_K(3);
#undef K3_NARROW_K
}

// K3's wide_f32 variant on ``stream``: float32 x (N, H, W, Cin) at element
// strides (sn, sh, sw, sc), any layout, read in place; the weights (3, 3,
// Cin, Cout) float32 at element strides (w0, w1, w2, w3); ``passes`` 1 to 3
// as conv3x3_k3 takes them; out (N, H, W, Cout) float32 contiguous.
// ``scratch`` holds the weights' split (split_hi_lo_weights_kernel,
// launched first): w_hi (9, Cout, Cin_p) bf16 with Cin_p = Cin rounded up to
// 16, and w_lo after it at 3 passes; 16-byte aligned. Returns
// cudaGetLastError() after each launch (or one of the kErr codes).
int conv3x3_k3_wide_f32(const float* x, long long sn, long long sh, long long sw, long long sc,
                        const float* w, long long w0, long long w1, long long w2, long long w3,
                        void* scratch, const float* bias, const float* prelu, float* out, int N,
                        int H, int W, int Cin, int Cout, int act, int passes, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || passes < 1 || passes > 3 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) return kErrNoEncoder;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cin_p = (Cin + 15) / 16 * 16;
  auto* w_hi = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* w_lo = passes == 3 ? w_hi + 9ll * Cout * cin_p : nullptr;
  const dim3 split_grid((cin_p + 31) / 32, (Cout + 31) / 32, 9);
  wide_f32::split_hi_lo_weights_kernel<<<split_grid, dim3(32, 8), 0, s>>>(
      w, w0, w1, w2, w3, Cin, Cout, cin_p, w_hi, w_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  // x by TMA where C is contiguous (a box of pixels) or W is (a box of
  // rows), with the other strides and the base 16-byte multiples (its
  // global strides must be); else by cp.async
  const bool aligned = sh % 4 == 0 && sn % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool pixels = aligned && sc == 1 && sw % 4 == 0;
  const bool rows = !pixels && aligned && sw == 1 && sc % 4 == 0;
  const int load = pixels ? wide_f32::kPixels : rows ? wide_f32::kRows : wide_f32::kScalar;
  // A work item's 128 output pixels: 16 x 8 of one image; where W is at
  // most 8, 8 x 16, or 8 x 8 of two images where H is too, but for a box
  // of rows (whose stage holds 16-wide tiles alone) 16 x 8 all the same.
  wide_f32::Geometry g{};
  g.tw = W > 8 || rows ? 16 : 8;
  g.th = g.tw == 16 || H > 8 ? 128 / g.tw : 8;
  g.tn = 128 / (g.tw * g.th);
  g.tiles_x = (W + g.tw - 1) / g.tw;
  g.tiles_y = (H + g.th - 1) / g.th;
  g.n_chunks = (Cin + wide_f32::kKC - 1) / wide_f32::kKC;
  g.a_ksteps = wide_f32::kKSteps;
  const long long tiles = static_cast<long long>((N + g.tn - 1) / g.tn) * g.tiles_x * g.tiles_y;
  // BN 128 unless Cout fits 64, or 64 gives the last wave less idle time:
  // the fewest waves of items, each weighted by its BN.
  auto waves = [&](int bn) { return (tiles * ((Cout + bn - 1) / bn) + sms - 1) / sms; };
  const int BN = Cout <= 64 || 64 * waves(64) < 128 * waves(128) ? 64 : 128;
  g.n_cb = (Cout + BN - 1) / BN;
  const long long items = tiles * g.n_cb;
  if (items > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  g.n_items = static_cast<int>(items);

  CUtensorMap maps[3]{};
  const cuuint64_t b = 4;   // bytes a float
  const cuuint64_t n_ = static_cast<cuuint64_t>(N), h_ = static_cast<cuuint64_t>(H),
                   w_ = static_cast<cuuint64_t>(W), c_ = static_cast<cuuint64_t>(Cin);
  const cuuint32_t halo_w = static_cast<cuuint32_t>(g.tw + 2),
                   halo_h = static_cast<cuuint32_t>(g.th + 2), tn = static_cast<cuuint32_t>(g.tn);
  if (pixels) {
    const cuuint64_t dims[4] = {c_, w_, h_, n_};
    const cuuint64_t strides[3] = {sw * b, sh * b, sn * b};
    const cuuint32_t box[4] = {wide_f32::kKC, halo_w, halo_h, tn};
    if (!encode_f32(&maps[0], x, dims, strides, box)) return kErrEncode;
  } else if (rows) {
    const cuuint64_t dims[4] = {w_, h_, c_, n_};
    const cuuint64_t strides[3] = {sh * b, sc * b, sn * b};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.tw + 8), halo_h, wide_f32::kKC, tn};
    if (!encode_f32(&maps[0], x, dims, strides, box)) return kErrEncode;
  }
  const cuuint64_t row = static_cast<cuuint64_t>(cin_p) * 2;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin_p), static_cast<cuuint64_t>(Cout), 9};
  const cuuint64_t w_strides[2] = {row, row * Cout};
  const cuuint32_t w_box[3] = {wide_f32::kKC, static_cast<cuuint32_t>(BN), 1};
  if (!encode(&maps[1], w_hi, 3, w_dims, w_strides, w_box) ||
      !encode(&maps[2], passes == 3 ? w_lo : w_hi, 3, w_dims, w_strides, w_box)) {
    return kErrEncode;
  }
  const narrow::XView view{x, sn, sh, sw, sc};
  // 16-byte stores where every pixel's channels start 16-byte aligned
  const int vec4 = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
#define K3_WIDE_F32(BN_)                                                                        \
  (passes == 1   ? launch_wide_f32<BN_, 1>(maps, view, bias, prelu, out, N, H, W, Cin, Cout,   \
                                           act, g, load, vec4, sms, s)                          \
   : passes == 2 ? launch_wide_f32<BN_, 2>(maps, view, bias, prelu, out, N, H, W, Cin, Cout,   \
                                           act, g, load, vec4, sms, s)                          \
                 : launch_wide_f32<BN_, 3>(maps, view, bias, prelu, out, N, H, W, Cin, Cout,   \
                                           act, g, load, vec4, sms, s))
  return BN == 128 ? K3_WIDE_F32(128) : K3_WIDE_F32(64);
#undef K3_WIDE_F32
}

const char* conv_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled could not be looked up";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
