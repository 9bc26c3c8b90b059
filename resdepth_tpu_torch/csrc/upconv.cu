// The float32 decoder's upsampling for Hopper (sm_90a): the 2x2 stride-2
// transposed conv at a number of bf16 product passes, its bias and the
// decoder's additive skip, in one pass over NHWC data.
//
//   out[n, 2i+a, 2j+b, o] = skip[n, 2i+a, 2j+b, o] + (S[n, i, j, a, b, o] + bias[o])
//   S = sum_c x[n, i, j, c] * w[c, o, a, b]
//
// with the products of ops/passes.py's passes, x = x_hi + x_lo and w = w_hi
// + w_lo in bf16: 1 pass x_hi w_hi, 2 passes + x_lo w_hi, 3 passes + x_hi
// w_lo (each product exact in float32, summed in float32). The result
// rounds where the chain it replaces rounds: the float32 sum, plus the bias,
// then plus the skip.
//
// It replaces no TPU kernel. The JAX package leaves the upconv to XLA
// (resdepth_tpu/models/unet.py, _upconv2x2_fwd_impl); in the port, eval on
// float32 storage at a pass count (the serving modes fast32, act2pass and
// balanced) ran it as the split of x and the weights into bf16 halves held
// in float32, a concatenation, cuDNN's IEEE-float32 transposed conv with its
// layout conversion and bias, and a separate skip add: several passes over
// the activations, the conv itself on cuDNN's non-tensor-core engine.
//
// The work is one GEMM: A = x as [M = N H W, Cin], B = the weights as
// [4 Cout, Cin] with rows in (a, b, o) order, each product a 2x2 scatter on
// the store. What bounds it: bytes. At the flagship's four levels (batch
// 128; 8^2 512->512 up to 64^2 128->128) a level is Cin/2 flops a byte of
// its output and skip, far under the card's 295: it reads x (4 Cin bytes a
// pixel) and the skip (16 Cout), and writes the result (16 Cout), 34.2 MB
// a 256^2 tile over all four. Where Cin is 512 the loads from L2 bound it
// instead: an item reads 256 KB of B for 128 KB of output and skip.
//
// Design: an item is 64 consecutive pixels of x (any rows, any images:
// nothing needs a neighbour) and a block of 256 of B's rows, 128 for each
// of the two consumer warpgroups, which read the same 64 pixels of A (a
// narrower block, or 128 pixels a warpgroup each, loads and splits x more
// times a byte of output, and measured slower at every level of the
// flagship; TMA fills the rows past 4 Cout with zeros). A persistent grid
// of one CTA an SM walks the items, the block fastest so that neighbouring
// CTAs find the same x tile in L2.
//   * x comes in as float32, 64 channels a chunk, by one TMA box of 64
//     pixels (4-byte cp.async where Cin % 4 != 0 or x is not 16-byte
//     aligned; TMA's zero fill is the Cin and M tails), through two
//     stages; three warps split it on chip into bf16 hi (and lo from 2
//     passes) tiles of 128-byte rows under the 128-byte swizzle, the layout
//     in which wgmma reads A from shared memory, two sets, so that chunk i
//     + 1 is split while chunk i's products run. No copy of x is written to
//     device memory, and A takes no registers.
//   * B's hi (and lo at 3 passes) are one small split launch a call
//     (transposed2x2_split_kernel, with the bias laid out by B's rows),
//     read by TMA under the same swizzle through a ring filled by one
//     thread.
//   * two consumer warpgroups run wgmma m64n128k16 with both operands in
//     shared memory and float32 accumulators, the passes in the TPU
//     kernel's order inside each k16 step, one chunk's products in flight
//     while the next chunk's are issued;
//   * the epilogue adds the bias in float32, then the skip, and stores the
//     sum with 16-byte accesses: a quad swaps halves of its
//     accumulators so that each thread holds 4 consecutive rows of B,
//     which are 4 consecutive output channels of one output pixel. A
//     thread loads its skip of the next item as soon as it has issued the
//     stores of this one, so that the loads run under the next item's
//     products.
//   * no atomics, and Cin is never split across CTAs: the same bits every
//     run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Error codes beside cudaError_t's for the tensor-map encoder.
constexpr int kErrNoEncoder = 10001;         // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10002;            // cuTensorMapEncodeTiled refused a map

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
// than about 2^36 cycles (some 40 s) means a ring is broken: trap, so the
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

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

// hi = bf16(v0, v1), lo = bf16(v - hi), each a packed pair (v0 in the low half).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// wgmma shared-memory descriptor of a K-major tile of 64-channel rows (128
// bytes) under the 128-byte swizzle, as TMA writes it: 8-row groups 1024
// bytes apart, leading byte offset unused (1), layout type 1 in bits 62-63.
// A K step of 16 bf16 inside a row advances the start by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
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

namespace up2x2 {

constexpr int kKC = 64;                        // input channels a chunk
constexpr int kKSteps = kKC / 16;              // its k16 steps
constexpr int kRowBytes = kKC * 2;             // a pixel's (or B row's) bf16 chunk: 128 B
constexpr int kConsumers = 2;                  // warpgroups 0 and 1: the products and stores
constexpr int kSplitWarps = 3;                 // warps 9-11: x's loads and split
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kThreads = 128 * kConsumers + 32 + kSplitThreads;   // + warp 8: the weights
constexpr int kSmemLimit = 232448;

constexpr int kBM = 64;                        // pixels an item
constexpr int kBN = 128;                       // B's rows a consumer warpgroup
constexpr int kRows = kConsumers * kBN;        // B's rows an item

// The rings' sizes at kPasses bf16 passes: from 2 passes a split set holds
// lo beside hi, and at 3 a weight stage holds w_lo beside w_hi.
template <int kPasses>
struct Cfg {
  static constexpr int kXStageBytes = kBM * kKC * 4;       // a chunk of x as float32
  static constexpr int kHalfBytes = kBM * kRowBytes;       // a split tile's hi (or lo)
  static constexpr int kWTileBytes = kRows * kRowBytes;
  static constexpr int kWStageBytes = (kPasses == 3 ? 2 : 1) * kWTileBytes;
  static constexpr int kXStages = 2;
  static constexpr int kSetBytes = (kPasses >= 2 ? 2 : 1) * kHalfBytes;
  static constexpr int kSets = 2;
  static constexpr int kFixed = kXStages * kXStageBytes + kSets * kSetBytes + 256 + 1024;
  static constexpr int kFit = (kSmemLimit - kFixed) / kWStageBytes;
  static constexpr int kWStages = kFit > 6 ? 6 : kFit;
  static_assert(kWStages >= 2, "the weight ring needs two stages");
  // weight stages, split sets (both 1 KB aligned for the swizzle), x
  // stages, barriers, and slack to align the base to 1 KB
  static constexpr int kSetOffset = kWStages * kWStageBytes;
  static constexpr int kXOffset = kSetOffset + kSets * kSetBytes;
  static constexpr int kBarOffset = kXOffset + kXStages * kXStageBytes;
  static constexpr int kSmemBytes = kBarOffset + 256 + 1024;
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
};

// A launch's shape and work: M = N H W pixels of x, n_cb blocks of B's 4
// Cout rows, n_items = ceil(M / kBM) n_cb, n_chunks chunks of Cin.
struct Geometry {
  int M, H, W, Cin, Cout, n_cb, n_items, n_chunks;
};

__device__ __forceinline__ void split_bar() {
  asm volatile("bar.sync 1, %0;" :: "n"(kSplitThreads) : "memory");
}

// Chunk c0 .. c0 + 63 of pixels m0 .. m0 + 63 by 4-byte cp.async into a
// stage laid out [pixel][64] floats, zeros past M and Cin: where TMA cannot
// read x (Cin % 4 != 0, or x not 16-byte aligned). x is [M, Cin] row-major.
__device__ __forceinline__ void load_scalar(uint32_t stage, const float* x, int m0, int c0,
                                            const Geometry& g, int st) {
  for (int e = st; e < kBM * kKC; e += kSplitThreads) {
    const int m = m0 + e / kKC, ch = c0 + e % kKC;
    const bool ok = m < g.M && ch < g.Cin;
    const float* src = ok ? x + static_cast<long long>(m) * g.Cin + ch : x;
    cp_async4(stage + e * 4, src, ok ? 4 : 0);
  }
}

// A staged chunk into a split set: bf16 hi, and lo when a pass reads it,
// each [pixel][64] in 128-byte rows under the 128-byte swizzle (16-byte unit
// u of row p at u ^ (p % 8)), as TMA lays out B and wgmma reads both. A
// thread takes 4 channels of a pixel (a warp reads 2 pixels' 512
// contiguous bytes).
template <bool kLo>
__device__ __forceinline__ void split_x(const float* stage, uint8_t* hi, int st) {
  uint8_t* lo = hi + kBM * kRowBytes;
  for (int i = st; i < kBM * (kKC / 4); i += kSplitThreads) {
    const int p = i / (kKC / 4), q = i % (kKC / 4);
    const float4 v = *reinterpret_cast<const float4*>(stage + p * kKC + 4 * q);
    uint32_t h[2], l[2];
    split2(v.x, v.y, h[0], l[0]);
    split2(v.z, v.w, h[1], l[1]);
    const int at = p * kRowBytes + (((q >> 1) ^ (p & 7)) << 4) + (q & 1) * 8;
    *reinterpret_cast<uint2*>(hi + at) = make_uint2(h[0], h[1]);
    if constexpr (kLo) *reinterpret_cast<uint2*>(lo + at) = make_uint2(l[0], l[1]);
  }
}

// grid min(items, SMs), block 384: warpgroups 0 and 1 multiply and store,
// warp 8 loads the weights, warps 9-11 load and split x.
template <int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
transposed2x2_skip_kernel(__grid_constant__ const CUtensorMap x_map,
                          __grid_constant__ const CUtensorMap w_hi,
                          __grid_constant__ const CUtensorMap w_lo, const float* __restrict__ x,
                          const float* __restrict__ bias4, const float* __restrict__ skip,
                          float* __restrict__ out, Geometry g, int tma_x, int vec4) {
  using C = Cfg<kPasses>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the 128-byte swizzle needs the weight stages and split sets 1 KB aligned
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
  // Item i of this CTA: first pixel m0, the block cb of B's rows (fastest).
  auto origin = [&](int i, int& m0, int& cb) {
    const int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    cb = t % g.n_cb;
    m0 = (t / g.n_cb) * kBM;
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

  if (warp == 4 * kConsumers) {               // the weights: one chunk's tiles a stage
    if (lane == 0) {
      int step = 0;
      for (int i = 0; i < my_items; ++i) {
        int m0, cb;
        origin(i, m0, cb);
        for (int chunk = 0; chunk < g.n_chunks; ++chunk, ++step) {
          const int ws = step % C::kWStages;
          const uint32_t dst = base + ws * C::kWStageBytes;
          mbar_wait(wempty(ws), ((step / C::kWStages) & 1u) ^ 1u);
          mbar_expect_tx(wfull(ws), C::kWStageBytes);
          tma_load_2d(dst, &w_hi, wfull(ws), chunk * kKC, cb * kRows);
          if constexpr (kPasses == 3) {
            tma_load_2d(dst + C::kWTileBytes, &w_lo, wfull(ws), chunk * kKC, cb * kRows);
          }
        }
      }
    }
    return;
  }

  if (warp > 4 * kConsumers) {                // x: a chunk a stage, split into a set
    const int st = tid - (4 * kConsumers + 1) * 32;
    const int total = my_items * g.n_chunks;
    // Chunk j of this CTA into x stage j % kXStages: by TMA, one thread,
    // completing on the stage's barrier; or by every split thread's
    // cp.async, one group a chunk (empty or not).
    auto issue_x = [&](int j) {
      const uint32_t dst = x_ring + (j % C::kXStages) * C::kXStageBytes;
      const int c0 = (j % g.n_chunks) * kKC;
      int m0 = 0, cb = 0;
      if (j < total) origin(j / g.n_chunks, m0, cb);
      if (!tma_x) {
        if (j < total) load_scalar(dst, x, m0, c0, g, st);
        cp_async_commit();
      } else if (st == 0 && j < total) {
        const uint32_t bar = xfull(j % C::kXStages);
        mbar_expect_tx(bar, C::kXStageBytes);
        tma_load_2d(dst, &x_map, bar, c0, m0);
      }
    };
    // Wait until chunk j has landed, for every split thread.
    auto landed_x = [&](int j) {
      if (!tma_x) {
        cp_async_wait<C::kXStages - 1>();
        split_bar();
      } else {
        mbar_wait(xfull(j % C::kXStages), static_cast<uint32_t>(j / C::kXStages) & 1u);
      }
    };
    for (int j = 0; j < C::kXStages; ++j) issue_x(j);
    for (int j = 0; j < total; ++j) {
      const int set = j % C::kSets;
      const float* stage = reinterpret_cast<const float*>(
          smem + C::kXOffset + (j % C::kXStages) * C::kXStageBytes);
      landed_x(j);
      mbar_wait(sempty(set), ((j / C::kSets) & 1u) ^ 1u);
      split_x<(kPasses >= 2)>(stage, smem + C::kSetOffset + set * C::kSetBytes, st);
      // the set's generic-proxy writes before wgmma's async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      split_bar();                            // the set is whole and the stage free
      if (st == 0) mbar_arrive(sfull(set));
      issue_x(j + C::kXStages);
    }
    if (!tma_x) cp_async_wait<0>();
    return;
  }

  // Consumer warpgroup wg: rows wg kBN .. + kBN - 1 of the item's block, all
  // 64 pixels.
  const int wg = warp / 4, cw = warp % 4;
  const uint32_t b_off = static_cast<uint32_t>(wg * kBN * kRowBytes);
  float acc[kBN / 2];
  int step = 0, released = 0;
  // Give the split sets and weight stages of steps ``released`` .. ``last``
  // back to their producers (their products are done).
  auto release_upto = [&](int last) {
    for (; released <= last; ++released) {
      mbar_arrive_if(wempty(released % C::kWStages), lane == 0);
      mbar_arrive_if(sempty(released % C::kSets), lane == 0);
    }
  };
  // The next step (one chunk: a split set and a weight stage): its
  // products issued, then the step before it waited for and its set and
  // stage given back.
  auto run_step = [&]() {
    const int set = step % C::kSets, ws = step % C::kWStages;
    mbar_wait(sfull(set), static_cast<uint32_t>(step / C::kSets) & 1u);
    mbar_wait(wfull(ws), static_cast<uint32_t>(step / C::kWStages) & 1u);
    const uint32_t a_hi = sets + set * C::kSetBytes, a_lo = a_hi + C::kHalfBytes;
    const uint32_t b_hi = base + ws * C::kWStageBytes + b_off, b_lo = b_hi + C::kWTileBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      // the passes in the TPU kernel's order
      wgmma_128(acc, smem_desc(a_hi + 32 * k), smem_desc(b_hi + 32 * k));
      if constexpr (kPasses == 3) {
        wgmma_128(acc, smem_desc(a_hi + 32 * k), smem_desc(b_lo + 32 * k));
      }
      if constexpr (kPasses >= 2) {
        wgmma_128(acc, smem_desc(a_lo + 32 * k), smem_desc(b_hi + 32 * k));
      }
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    release_upto(step - 1);
    ++step;
  };

  const int g4 = lane / 4, q = lane % 4;
  const bool odd = q & 1;
  const int n_rows = 4 * g.Cout, hw = g.H * g.W;
  // Where B's row (column of the product) r lands in an output pixel's
  // neighbourhood: phase (a, b) = (r / Cout) / 2, % 2, channel r % Cout.
  auto row_offset = [&](int r) {
    const int ab = r / g.Cout, o = r - ab * g.Cout;
    return ((ab >> 1) * 2 * g.W + (ab & 1)) * g.Cout + o;
  };
  // Accumulator layout of wgmma m64nNk16: thread (cw, lane) holds rows
  // 16 cw + g4 (+ 8) of the pixels and columns 8 j + 2 q (+ 1) as acc[4 j
  // + 2 h + e], h the row half, e the column. With vec4, a quad swaps
  // halves: for column blocks j, j + 1 an even lane takes rows 8 j + 2 q ..
  // + 3 of B (its own pair and its odd partner's), an odd lane 8 (j + 1) +
  // 2 (q - 1) .. + 3 (its even partner's pair and its own).
  // An item's place: this warpgroup's first row of B, and for each row
  // half whether its pixel exists and where its output pixel (2 y, 2 x)
  // starts; with vec4 its skip, loaded while the item's products run.
  int r0 = 0;
  bool px_ok[2];
  long long at[2];
  float4 sk[2][kBN / 16];
  auto row_of = [&](int j) { return r0 + 8 * (j + (odd ? 1 : 0)) + 4 * (q >> 1); };
  auto prefetch = [&](int i) {
    int m0, cb;
    origin(i, m0, cb);
    r0 = cb * kRows + wg * kBN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + cw * 16 + g4 + 8 * h;
      px_ok[h] = m < g.M;
      const int mc = px_ok[h] ? m : 0;
      const int n = mc / hw, rest = mc - n * hw, y = rest / g.W, xx = rest - y * g.W;
      at[h] = ((static_cast<long long>(n) * 2 * g.H + 2 * y) * 2 * g.W + 2 * xx) * g.Cout;
    }
    if (vec4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kBN / 8; j += 2) {
          const int r = row_of(j);
          sk[h][j / 2] = px_ok[h] && r < n_rows
                             ? __ldcs(reinterpret_cast<const float4*>(skip + at[h] + row_offset(r)))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
  };
  // The sum plus the bias in float32 (the bias index clamped to the last
  // row, so that the compiler batches the loads).
  auto value = [&](int h, int j, int e) {
    const int r = r0 + 8 * j + 2 * q + e;
    return acc[4 * j + 2 * h + e] + __ldg(bias4 + (r < n_rows ? r : n_rows - 1));
  };
  if (my_items > 0) prefetch(0);
  for (int i = 0; i < my_items; ++i) {
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.0f;
    for (int s = 0; s < g.n_chunks; ++s) run_step();
    wgmma_wait<0>();
    fence_acc(acc);
    release_upto(step - 1);

    if (vec4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kBN / 8; j += 2) {
          const float v[2] = {value(h, j, 0), value(h, j, 1)};
          const float w[2] = {value(h, j + 1, 0), value(h, j + 1, 1)};
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : w[0], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : w[1], 1);
          const int r = row_of(j);
          if (px_ok[h] && r < n_rows) {
            const float4 u = odd ? make_float4(s0, s1, w[0], w[1])
                                 : make_float4(v[0], v[1], s0, s1);
            const float4 k = sk[h][j / 2];
            __stcs(reinterpret_cast<float4*>(out + at[h] + row_offset(r)),
                   make_float4(k.x + u.x, k.y + u.y, k.z + u.z, k.w + u.w));
          }
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + 8 * j + 2 * q + e;
            if (px_ok[h] && r < n_rows) {
              const long long o = at[h] + row_offset(r);
              out[o] = skip[o] + value(h, j, e);
            }
          }
        }
      }
    }
    if (i + 1 < my_items) prefetch(i + 1);
  }
}

// The weights (Cin, Cout, 2, 2) float32 at element strides (s_c, s_o, s_a,
// s_b) into the kernel's B operand: hi (and lo, when not null) (4 Cout,
// Cin_p) bf16, K-major, row (2 a + b) Cout + o, hi = bf16(w), lo = bf16(w -
// hi), zeros in [Cin, Cin_p); and the bias (or zeros) by B's rows into
// bias4 (4 Cout) float32. A block turns a 32 x 32 tile (input x output
// channels) of one phase through shared memory, so that its writes run
// along a row.
__global__ void __launch_bounds__(256)
transposed2x2_split_kernel(const float* __restrict__ w, long long s_c, long long s_o,
                           long long s_a, long long s_b, const float* __restrict__ bias,
                           int Cin, int Cout, int Cin_p, __nv_bfloat16* __restrict__ hi,
                           __nv_bfloat16* __restrict__ lo, float* __restrict__ bias4) {
  __shared__ float tile[32][33];
  const int ab = static_cast<int>(blockIdx.z);
  const int c0 = static_cast<int>(blockIdx.x) * 32, o0 = static_cast<int>(blockIdx.y) * 32;
  const int tx = static_cast<int>(threadIdx.x), ty = static_cast<int>(threadIdx.y);
  const float* t = w + (ab >> 1) * s_a + (ab & 1) * s_b;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, o = o0 + tx;
    tile[r][tx] = c < Cin && o < Cout ? t[c * s_c + o * s_o] : 0.0f;
  }
  if (blockIdx.x == 0 && ty == 0 && o0 + tx < Cout) {
    bias4[ab * Cout + o0 + tx] = bias != nullptr ? bias[o0 + tx] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int o = o0 + r, c = c0 + tx;
    if (o < Cout && c < Cin_p) {
      const float v = tile[tx][r];
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      const long long at = (static_cast<long long>(ab) * Cout + o) * Cin_p + c;
      hi[at] = h;
      if (lo != nullptr) lo[at] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

}  // namespace up2x2

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

// A 2-D tensor map with zero fill outside the tensor: dims and box
// innermost first, the row stride in bytes.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, cuuint64_t cols,
               cuuint64_t rows, cuuint64_t row_bytes, cuuint32_t box_cols, cuuint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel at ``kPasses`` passes on encoded maps.
template <int kPasses>
int launch(const float* x, const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
           const float* bias4, const float* skip, float* out, up2x2::Geometry g, int tma_x,
           int vec4, int sms, cudaStream_t stream) {
  using C = up2x2::Cfg<kPasses>;
  const long long tiles = (static_cast<long long>(g.M) + up2x2::kBM - 1) / up2x2::kBM;
  g.n_cb = (4 * g.Cout + up2x2::kRows - 1) / up2x2::kRows;
  const long long items = tiles * g.n_cb;
  if (items > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  g.n_items = static_cast<int>(items);
  const cuuint64_t cin_p = static_cast<cuuint64_t>((g.Cin + 15) / 16 * 16);
  CUtensorMap maps[3]{};
  if (tma_x && !encode_2d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x,
                          static_cast<cuuint64_t>(g.Cin), static_cast<cuuint64_t>(g.M),
                          static_cast<cuuint64_t>(g.Cin) * 4, up2x2::kKC, up2x2::kBM,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return kErrEncode;
  }
  if (!encode_2d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w_hi, cin_p, 4 * g.Cout, cin_p * 2,
                 up2x2::kKC, up2x2::kRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w_lo, cin_p, 4 * g.Cout, cin_p * 2,
                 up2x2::kKC, up2x2::kRows, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return kErrEncode;
  }
  auto kernel = up2x2::transposed2x2_skip_kernel<kPasses>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(g.n_items < sms ? g.n_items : sms);
  kernel<<<grid, up2x2::kThreads, C::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], x, bias4,
                                                           skip, out, g, tma_x, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The upconv and skip add on ``stream``: x (N, H, W, Cin) float32
// contiguous; the weights (Cin, Cout, 2, 2) float32 at element strides (w0,
// w1, w2, w3); bias (Cout,) float32 or null; skip and out (N, 2H, 2W, Cout)
// float32 contiguous; ``passes`` 1 to 3. ``scratch`` (16-byte aligned)
// holds the weights' split and the bias by B's rows
// (transposed2x2_split_kernel, launched first): w_hi (4 Cout, Cin_p) bf16
// with Cin_p = Cin rounded up to 16, w_lo after it at 3 passes, then 4 Cout
// floats. Returns cudaGetLastError() after each launch (or one of the kErr
// codes).
int upconv2x2_skip(const float* x, const float* w, long long w0, long long w1, long long w2,
                   long long w3, const float* bias, const float* skip, void* scratch, float* out,
                   int N, int H, int W, int Cin, int Cout, int passes, void* stream) {
  const long long M = static_cast<long long>(N) * H * W;
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || passes < 1 || passes > 3 ||
      M > (1ll << 31) - 1 || 16ll * W * Cout > (1ll << 31) - 1 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) return kErrNoEncoder;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cin_p = (Cin + 15) / 16 * 16, n_rows = 4 * Cout;
  auto* w_hi = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* w_lo = passes == 3 ? w_hi + static_cast<long long>(n_rows) * cin_p : nullptr;
  float* bias4 = reinterpret_cast<float*>(w_hi + static_cast<long long>(n_rows) * cin_p *
                                                    (passes == 3 ? 2 : 1));
  const dim3 split_grid((cin_p + 31) / 32, (Cout + 31) / 32, 4);
  up2x2::transposed2x2_split_kernel<<<split_grid, dim3(32, 8), 0, s>>>(
      w, w0, w1, w2, w3, bias, Cin, Cout, cin_p, w_hi, w_lo, bias4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  up2x2::Geometry g{};
  g.M = static_cast<int>(M);
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.n_chunks = (Cin + up2x2::kKC - 1) / up2x2::kKC;
  // x by TMA where its rows are 16-byte multiples and its base 16-byte
  // aligned (TMA's global strides and address must be), else by cp.async
  const int tma_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
  // 16-byte skip loads and stores where every pixel's channels start
  // 16-byte aligned
  const int vec4 = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(skip) % 16 == 0
                       ? 1
                       : 0;
  const __nv_bfloat16* lo = passes == 3 ? w_lo : w_hi;
  if (passes == 1) return launch<1>(x, w_hi, lo, bias4, skip, out, g, tma_x, vec4, sms, s);
  if (passes == 2) return launch<2>(x, w_hi, lo, bias4, skip, out, g, tma_x, vec4, sms, s);
  return launch<3>(x, w_hi, lo, bias4, skip, out, g, tma_x, vec4, sms, s);
}

const char* upconv_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled could not be looked up";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
