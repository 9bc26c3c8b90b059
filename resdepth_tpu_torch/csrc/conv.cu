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
// ((HIGH, DEFAULT): the activation split, the weights single-rounded); a
// stage then holds only the tiles its passes read. The TPU kernel cuts the padded input into three
// row-shifted views so that its BlockSpecs hand each grid program a halo
// window in VMEM; here TMA fetches each tap's window itself.
//
// The GEMM: M = the output pixels of one image, N = Cout, K = 9 taps x Cin.
// A CTA computes 128 MT pixels (a rectangle of output rows, 128 or 256
// wide and 1-16 rows high, never across images) x BN output channels (64
// or 128); MT is 2 for bf16 at BN 128, else 1. Two consumer warpgroups
// each run wgmma m64nBNk16 on MT x 64 of the pixels, their accumulators
// in registers; one producer thread (warp 8) keeps a ring of 3-6 stages
// full with TMA loads (cp.async.bulk.tensor, mbarrier completion).
// A stage holds, for one tap (dy, dx) and one chunk of KC input channels
// (64, or all of a narrow layer's 16 or 32), the A tile (the input window
// shifted by the tap, 128 MT px x KC bf16, from a 4-D tensor map (C, W, H, N)
// at (c0, x0+dx-1, y0+dy-1, n)) and the B tile (the tap's weights, BN x KC
// bf16), and for f32 the lo tiles its passes read beside the hi ones. TMA fills zeros
// outside the tensor, negative coordinates included: that is the conv's
// same padding and the Cin / Cout tails, with no padded copy of x and no
// bounds check in the loads. The tiles arrive in the swizzle of their row
// width (128, 64 or 32 bytes), which the wgmma descriptors name. Bias and
// activation run on the accumulators in registers; stores are masked at
// the ragged pixel and Cout edges.
//
// The wrapper (ops/conv.py) hands the kernel bf16 operands: x as it is, or
// padded with zero channels to a multiple of 16 (TMA needs 16-byte strides,
// wgmma takes K in steps of 16); the weights re-laid once a call as
// (9, Cout, Cin_p), K-major. For f32 the split kernel below writes x_hi,
// and x_lo from 2 passes (bf16, NHWC, Cin padded), and the weights' hi,
// and lo at 3 passes, the same way: one extra read of x and write of 1 or
// 2 bf16 copies, not yet fused into the load.
//
// What bounds it: at the flagship UNet's convs (batch 128) most 3x3 convs
// are 0.31 TFLOP against 0.5-2 GB of activations, so bf16 is bound by the
// tensor cores' 989 TFLOP/s (0.31 ms) except the first layer (Cin 3) and
// the top's (Cout 1 and 4), which are bound by their bytes (the first
// writes about 1 GB, 0.34 ms); f32 does 1 to 3 passes (up to 0.94 ms). This design reaches the tensor cores, with the loads
// overlapped by the ring, and runs at 40-50 % of the bound in bf16 and
// 50-60 % in f32 at Cin >= 128 (PERF.md). What it leaves: each tap reloads
// its window from L2 (9 A tiles a chunk; at 128 px x 128 Cout that was
// 32 KB of loads a 2.1 MFLOP step, some 6 TB/s across the card, which is
// why bf16 takes 256 px), a CTA's epilogue does not overlap the next
// tile's loads (one tile a CTA, not persistent), narrow layers pay that
// fixed cost on little work, and the f32 split costs a pass over x.
// Loading each chunk's halo once, a persistent grid and a split fused into
// the load are the next steps.

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

// BN output channels a CTA, kPasses bf16 product passes (1, 2 or 3) and
// kF32 the f32 path (f32 output; bf16 takes 1 pass), KC input channels a stage
// (16, 32 or 64: rows of 32, 64 or 128 bytes, under the swizzle of that
// width; 16 and 32 serve layers with few input channels, such as the
// first, whose stages would otherwise be mostly TMA's zero fill), and MT
// m64 tiles a consumer warpgroup: 128 MT output pixels a CTA.
template <int BN, int kPasses, int KC, int MT>
struct Config {
  static constexpr int kBM = 128 * MT;
  static constexpr int kRowBytes = KC * 2;
  static constexpr int kATiles = kPasses >= 2 ? 2 : 1;  // x_hi, and x_lo from 2 passes
  static constexpr int kBTiles = kPasses == 3 ? 2 : 1;  // w_hi, and w_lo at 3 passes
  static constexpr int kATileBytes = kBM * kRowBytes;   // 16 KB at KC 64, MT 1
  static constexpr int kBTileBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kATiles * kATileBytes + kBTiles * kBTileBytes;
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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// grid (N * tiles_y * tiles_x * n_cb), block 288: warpgroups 0 and 1
// multiply, the first thread of warp 8 loads. The Cout block varies
// fastest, so the CTAs that share an input window run together and find it
// in L2.
template <int BN, int kPasses, bool kF32, int KC, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_k3_kernel(__grid_constant__ const CUtensorMap x_hi,
                  __grid_constant__ const CUtensorMap x_lo,
                  __grid_constant__ const CUtensorMap w_hi,
                  __grid_constant__ const CUtensorMap w_lo,
                  const float* __restrict__ bias, const float* __restrict__ prelu,
                  typename std::conditional<kF32, float, __nv_bfloat16>::type* __restrict__ out,
                  int H, int W, int Cout, int n_chunks, int last_ksteps, int tile_w_log2,
                  int tile_h, int tiles_x, int tiles_y, int n_cb, int act) {
  using Cfg = Config<BN, kPasses, KC, MT>;
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
        const uint32_t b = a + Cfg::kATiles * Cfg::kATileBytes;
        tma_load_4d(a, &x_hi, full(stage), chunk * KC, x0 + dx - 1, y0 + dy - 1, n);
        tma_load_3d(b, &w_hi, full(stage), chunk * KC, n0, tap);
        if constexpr (kPasses >= 2) {
          tma_load_4d(a + Cfg::kATileBytes, &x_lo, full(stage), chunk * KC, x0 + dx - 1,
                      y0 + dy - 1, n);
        }
        if constexpr (kPasses == 3) {
          tma_load_3d(b + Cfg::kBTileBytes, &w_lo, full(stage), chunk * KC, n0, tap);
        }
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
    const uint32_t a_hi = base + stage * Cfg::kStageBytes + wg * MT * 64 * Cfg::kRowBytes;
    const uint32_t b_hi = base + stage * Cfg::kStageBytes + Cfg::kATiles * Cfg::kATileBytes;
    const uint32_t b_lo = b_hi + Cfg::kBTileBytes;
    fence_all();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      if (k < ksteps) {
        const uint64_t b = smem_desc<KC>(b_hi + 32 * k);
        wgmma_tile<BN>(acc0, smem_desc<KC>(a_hi + 32 * k), b);
        if constexpr (MT > 1) {
          wgmma_tile<BN>(acc1, smem_desc<KC>(a_hi + 64 * Cfg::kRowBytes + 32 * k), b);
        }
        // MT is 1 for f32; the passes in the TPU kernel's order
        if constexpr (kPasses == 3) {
          wgmma_tile<BN>(acc0, smem_desc<KC>(a_hi + 32 * k),
                         smem_desc<KC>(b_lo + 32 * k));
        }
        if constexpr (kPasses >= 2) {
          wgmma_tile<BN>(acc0, smem_desc<KC>(a_hi + Cfg::kATileBytes + 32 * k), b);
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

// The f32 path's operand split: src (rows, cols) f32 -> hi, lo (rows,
// cols_p) bf16 with hi = bf16(v), lo = bf16(v - hi), zeros in columns
// [cols, cols_p); lo null writes hi alone (no pass reads lo). cols_p is a
// multiple of 16; each thread takes 4 columns.
__global__ void __launch_bounds__(256)
split_hi_lo_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ hi,
                   __nv_bfloat16* __restrict__ lo, long long rows, int cols, int cols_p) {
  const int quads = cols_p / 4;
  const long long total = rows * quads;
  const bool vector = cols % 4 == 0;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < total;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = q / quads;
    const int c = static_cast<int>(q - r * quads) * 4;
    const float* s = src + r * cols + c;
    float v[4];
    if (vector && c < cols) {
      const float4 f = *reinterpret_cast<const float4*>(s);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c + e < cols ? s[e] : 0.0f;
    }
    uint32_t h[2], l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      const float2 back = __bfloat1622float2(hv);
      const __nv_bfloat162 lv = __floats2bfloat162_rn(v[2 * e] - back.x, v[2 * e + 1] - back.y);
      h[e] = *reinterpret_cast<const uint32_t*>(&hv);
      l[e] = *reinterpret_cast<const uint32_t*>(&lv);
    }
    *reinterpret_cast<uint2*>(hi + r * cols_p + c) = make_uint2(h[0], h[1]);
    if (lo != nullptr) *reinterpret_cast<uint2*>(lo + r * cols_p + c) = make_uint2(l[0], l[1]);
  }
}

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

template <int BN, int kPasses, bool kF32, int KC, int MT>
int launch(const CUtensorMap* maps, const float* bias, const float* prelu, void* out, int N,
           int H, int W, int Cout, int n_chunks, int last_ksteps, int tile_w_log2, int tile_h,
           int act, cudaStream_t stream) {
  using Cfg = Config<BN, kPasses, KC, MT>;
  using Out = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  auto kernel = conv3x3_k3_kernel<BN, kPasses, kF32, KC, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + (1 << tile_w_log2) - 1) >> tile_w_log2;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int n_cb = (Cout + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(N) * tiles_y * tiles_x * n_cb);
  kernel<<<grid, kThreads, Cfg::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, prelu, static_cast<Out*>(out), H, W, Cout,
      n_chunks, last_ksteps, tile_w_log2, tile_h, tiles_x, tiles_y, n_cb, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on ``stream`` and returns cudaGetLastError() (or one of the
// kErr codes above): a launch the runtime refuses never runs, and only this
// call reports it. x_* are (N, H, W, Cin_p) bf16 and w_* (9, Cout, Cin_p)
// bf16, Cin_p a multiple of 16, all 16-byte aligned; ``dtype`` 1 (bfloat16)
// reads x_hi and w_hi only, takes ``passes`` 1 and writes bf16, ``dtype`` 0
// (float32) runs ``passes`` bf16 passes (1: x_hi w_hi; 2: + x_lo w_hi; 3: +
// x_hi w_lo) and writes f32; x_lo is read from 2 passes, w_lo at 3 only
// (the others may be null). bias and prelu are f32 (Cout,).
int conv3x3_k3(const void* x_hi, const void* x_lo, const void* w_hi, const void* w_lo,
               const float* bias, const float* prelu, void* out, int N, int H, int W,
               int Cin_p, int Cout, int act, int dtype, int passes, void* stream) {
  if (encoder() == nullptr) return kErrNoEncoder;
  if (Cin_p % 16 != 0 || (dtype != 0 && dtype != 1) || passes < 1 || passes > 3 ||
      (dtype == 1 && passes != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool split = dtype == 0;
  const int BN = Cout > 64 ? 128 : 64;
  // Channels a stage: all of Cin_p when it is 16 or 32 (narrow layers at
  // BN 64, such as the first), else chunks of 64.
  const int KC = BN == 64 && Cin_p <= 32 ? Cin_p : 64;
  // Pixels a CTA: 256 for bf16 at BN 128 (each A tile feeds twice the
  // products, for less L2 traffic a FLOP), else 128; as tile_h rows of
  // tile_w, tile_w the smallest power of two in [16, 128] that covers W.
  const int MT = !split && BN == 128 ? 2 : 1;
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
  CUtensorMap maps[4];
  if (!encode(&maps[0], x_hi, 4, x_dims, x_strides, x_box) ||
      !encode(&maps[1], passes >= 2 ? x_lo : x_hi, 4, x_dims, x_strides, x_box) ||
      !encode(&maps[2], w_hi, 3, w_dims, w_strides, w_box) ||
      !encode(&maps[3], passes == 3 ? w_lo : w_hi, 3, w_dims, w_strides, w_box)) {
    return kErrEncode;
  }
  const int n_chunks = (Cin_p + KC - 1) / KC;
  const int last_ksteps = (Cin_p - (n_chunks - 1) * KC) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(BN_, PASSES_, F32_, KC_, MT_)                                            \
  launch<BN_, PASSES_, F32_, KC_, MT_>(maps, bias, prelu, out, N, H, W, Cout, n_chunks,  \
                                       last_ksteps, tile_w_log2, tile_h, act, s)
  // f32 at ``passes`` passes for one configuration (BN_, KC_), MT 1
#define K3_F32(BN_, KC_)                                     \
  (passes == 1   ? K3_LAUNCH(BN_, 1, true, KC_, 1)           \
   : passes == 2 ? K3_LAUNCH(BN_, 2, true, KC_, 1)           \
                 : K3_LAUNCH(BN_, 3, true, KC_, 1))
  if (BN == 128) return split ? K3_F32(128, 64) : K3_LAUNCH(128, 1, false, 64, 2);
  if (KC == 16) return split ? K3_F32(64, 16) : K3_LAUNCH(64, 1, false, 16, 1);
  if (KC == 32) return split ? K3_F32(64, 32) : K3_LAUNCH(64, 1, false, 32, 1);
  return split ? K3_F32(64, 64) : K3_LAUNCH(64, 1, false, 64, 1);
#undef K3_F32
#undef K3_LAUNCH
}

// The f32 operand split (split_hi_lo_kernel) on ``stream``; returns
// cudaGetLastError(). src is (rows, cols) f32, hi and lo (rows, cols_p)
// bf16 with cols_p a multiple of 16; all 16-byte aligned; lo may be null.
int conv_split_hi_lo(const float* src, void* hi, void* lo, long long rows, int cols, int cols_p,
                     void* stream) {
  if (cols_p % 16 != 0 || cols > cols_p) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = rows * (cols_p / 4);
  const long long blocks = (work + 255) / 256;
  const long long capped = blocks < 132 * 32 ? blocks : 132 * 32;   // grid-stride beyond
  const unsigned grid = static_cast<unsigned>(capped > 0 ? capped : 1);
  split_hi_lo_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(lo), rows, cols, cols_p);
  return static_cast<int>(cudaGetLastError());
}

const char* conv_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled could not be looked up";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
