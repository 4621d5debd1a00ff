// FeatureAttention surrogate forward for Hopper (sm_90a).
//
// Replaces the TPU kernel humanoid_mppi_rl_tpu/ops/estimator_kernel.py::
// make_flash_feature_attention (its `kernel_body`, :129): the learned-dynamics
// surrogate's whole forward for a batch of samples. Every scalar of
// [state; action] is a token (F of them); each token row has H channels:
//   encode   h = relu(LN(round(x) * w_enc + b_enc)) + pos
//   L x      y = LN1(h); q|k|v = y Wqkv + b; per (sample, head) softmax
//            attention; h = (h + att Wo) + bo; y = LN2(h);
//            f = relu(y W1 + b1); h = (h + f W2) + b2
//   head     out[b, f] = sum_f32(round(h * w_head)) + b_out, f < state_dim
// It rounds where the TPU kernel rounds: products take operands of the
// compute type T (bf16, or f32 for tight checks) and accumulate in f32,
// then round to T; bias adds and the residual stream are in T; LayerNorm
// statistics (eps 1e-6) and softmax are f32. The TPU kernel's block-diagonal
// -1e9 mask was a workaround for its compiler; here attention is computed
// per sample directly. Any batch size: every kernel masks its ragged edge.
//
// The output keeps only the state_dim (Sd) tokens of each sample, so the
// last layer computes K and V (and Q, 1% of the products) for all F tokens
// and everything after the attention for the Sd state tokens alone: the
// attention writes their rows compacted to (B*Sd, H), the out-projection
// reads its residual through the row map (r / Sd) * F + r % Sd, and the
// LayerNorm, the FFN and the head run on B*Sd rows.
//
// Design: a few kernels per layer, launched in order on one stream by
// hmr_estimator_forward (2 + 7 L launches per forward):
//   rowwise    one warp per token row: the encode, or a LayerNorm
//   gemm       C = epilogue(A W^T), W stored (N, K) as nn.Linear keeps it.
//              bf16: wgmma m64n256k16 fed by TMA. Persistent blocks, one
//              per SM, walk 128x256 output tiles; 64-deep K steps go
//              through a 3-stage ring of 128-byte-swizzled shared tiles
//              completed on mbarriers. A producer warpgroup issues the TMA
//              loads (and fills the next tile's stages during an
//              epilogue); two consumer warpgroups issue the wgmma, then
//              stage their bf16 results through shared memory (stmatrix)
//              so that the epilogue moves whole rows.
//              f32: a plain FMA tiled product (no TF32), for the f32 check.
//   attention  bf16: mma.sync m16n8k16 tensor-core products; tokens padded
//              to a multiple of 16 (padded keys masked out of the softmax,
//              padded queries not written), one warp per 16 query rows,
//              scores and weights in registers, several (sample, head)
//              pairs per block. f32: one block per (sample, head) on CUDA
//              cores. Both use the plain two-pass softmax.
//   head       one warp per output scalar
// The GEMM epilogue fuses the bias, the ReLU and the residual add, with the
// same roundings as the TPU kernel. Each kind also has an entry point of
// its own (hmr_estimator_rowwise/gemm/attention/head), through the same
// launcher, so a check can hold one kernel at a time against its plain
// version on inputs whose sums are exact in any order.
//
// What bounds it: the operations. A forward of quadruped_attention at
// B=2048 needs 1.15 TFLOP of products (12 H^2 MACs per token per layer,
// except that in the last layer the action tokens need only their K and V),
// 1.16 ms at the card's 989 TFLOP/s bf16 peak. Its own inputs and outputs
// are ~0.8 MB and the weights 12.6 MB (L2-resident). This layer-wise design
// also moves its activations through device memory (5.1 GB at B=2048,
// 1.53 ms at 3.35 TB/s), so as built it is held by those bytes before the
// products. A fused kernel that keeps each block's residual stream on chip
// (as the TPU kernel does) would drop them: later work.
//
// TMA descriptors are encoded on the host for every GEMM launch from the
// operands' current pointers; cuTensorMapEncodeTiled is reached through
// the runtime's cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 fromf<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T, held in a float
template <typename T>
__device__ __forceinline__ float rnd(float v) { return tof(fromf<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// row of the residual for output row r: C holds rq rows per sample, res rf
// (the last layer's compacted state rows read the full residual stream)
__device__ __forceinline__ size_t res_row(int r, int rq, int rf) {
  return rq == rf ? static_cast<size_t>(r) : static_cast<size_t>(r / rq) * rf + r % rq;
}

// ---- rowwise: encode + LayerNorm, or LayerNorm ------------------------------
// kEncode: row r is token f = r % F of its sample, built from x[r];
// enc rows are [w_enc, b_enc, ln0_scale, ln0_bias, w_head], each (H,).
// Otherwise LayerNorm of in[r] with ln rows [scale, bias].
template <typename T, bool kEncode>
__global__ void rowwise_kernel(const float* __restrict__ x, const T* __restrict__ in,
                               const T* __restrict__ vecs, const T* __restrict__ pos,
                               T* __restrict__ out, int M, int F, int H) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* scale = kEncode ? vecs + 2 * H : vecs;
  const T* bias = kEncode ? vecs + 3 * H : vecs + H;
  const float xc = kEncode ? rnd<T>(x[row]) : 0.f;
  const T* src = kEncode ? nullptr : in + static_cast<size_t>(row) * H;
  auto value = [&](int c) -> float {
    if (kEncode) return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(xc, tof(vecs[c]))), tof(vecs[H + c])));
    return tof(src[c]);
  };
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += value(c);
  const float mu = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = value(c) - mu;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / H + 1e-6f);
  T* dst = out + static_cast<size_t>(row) * H;
  const T* p = kEncode ? pos + static_cast<size_t>(row % F) * H : nullptr;
  for (int c = lane; c < H; c += 32) {
    float y = rnd<T>(__fmul_rn(value(c) - mu, r));
    y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(y, tof(scale[c]))), tof(bias[c])));
    if (kEncode) y = rnd<T>(__fadd_rn(fmaxf(y, 0.f), tof(p[c])));
    dst[c] = fromf<T>(y);
  }
}

// ---- GEMM epilogue ----------------------------------------------------------
// round(acc); then (res + .) if res; then (. + bias); then relu: the TPU
// kernel's `mm(a, w) + b` and `h + mm(a, w) + b`, rounding after each op.
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float bias, const T* res, bool relu) {
  float v = rnd<T>(acc);
  if (res != nullptr) v = rnd<T>(__fadd_rn(tof(*res), v));
  v = rnd<T>(__fadd_rn(v, bias));
  return relu ? fmaxf(v, 0.f) : v;
}

// ---- f32 GEMM: C (M,N) = A (M,K) W^T, W (N,K); plain FMA, 64x64 tiles -------
constexpr int kSB = 64, kSK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* res, float* C,
                int M, int N, int K, int relu, int rq, int rf) {
  __shared__ float As[kSK][kSB + 1];
  __shared__ float Bs[kSK][kSB + 1];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int m0 = blockIdx.y * kSB, n0 = blockIdx.x * kSB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSK) {
    for (int e = tid; e < kSB * kSK; e += 256) {
      const int r = e / kSK, k = e % kSK;
      As[k][r] = (m0 + r < M && k0 + k < K) ? A[static_cast<size_t>(m0 + r) * K + k0 + k] : 0.f;
      Bs[k][r] = (n0 + r < N && k0 + k < K) ? W[static_cast<size_t>(n0 + r) * K + k0 + k] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kSK; ++k) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tc * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + tr * 4 + i;
    if (r >= M) continue;
    const size_t rr = res_row(r, rq, rf) * N;
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tc * 4 + j;
      if (c >= N) continue;
      C[static_cast<size_t>(r) * N + c] =
          epilogue<float>(acc[i][j], bias[c], res ? res + rr + c : nullptr, relu);
    }
  }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  return pack_pair(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// ---- bf16 GEMM: wgmma fed by TMA --------------------------------------------
// Block tile 128 (M) x 256 (N), K in steps of 64 bf16 = 128 bytes, the width
// of the 128-byte swizzle. Stage s holds A (128 rows x 128 B) and W (256
// rows x 128 B), both K-major as TMA writes them: 48 KB for 4.2 MFLOP, so
// the tiles come from L2 at ~87 FLOP/B (a 128 x 128 tile needs 64 FLOP/B,
// more than L2 feeds at the tensor cores' rate). Warps 0-7 are two consumer
// warpgroups (rows 0-63 and 64-127 of the tile, 128 f32 accumulators per
// thread), warps 8-11 the producer warpgroup, of which one thread issues
// the loads; setmaxnreg moves registers from the producer (40 each) to the
// consumers (232 each). One block per SM, 3 stages and the epilogue's
// staging rows.
constexpr int kGM = 128, kGN = 256, kGK = 64, kStages = 3;
constexpr int kTileA = kGM * kGK * 2, kTileW = kGN * kGK * 2;
constexpr int kGemmThreads = 384;
// epilogue staging: per consumer warpgroup 64 rows of kGN bf16, padded by
// 16 B so that the 8 rows of an 8 x 8 stmatrix block fall in distinct banks
constexpr int kLdS = kGN + 8, kStaging = 64 * kLdS * 2, kEpi = 64 * kGN / 8 / 128;
constexpr int kGemmSmem = kStages * (kTileA + kTileW) + 2 * kStaging + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// waits for the phase of the given parity to complete; a wait that cannot
// end (a fault in the pipeline's bookkeeping) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// start address >> 4, leading offset 16 B (unused for this layout), stride
// 1024 B between 8-row groups, layout type 1 (128B swizzle) in bits 62-63.
// The tile base is 1024-byte aligned; a 16-deep K step adds 32 B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

#define HMR_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HMR_ACC64(i)                                                                        \
  HMR_ACC8(i), HMR_ACC8(i + 8), HMR_ACC8(i + 16), HMR_ACC8(i + 24), HMR_ACC8(i + 32),        \
      HMR_ACC8(i + 40), HMR_ACC8(i + 48), HMR_ACC8(i + 56)

// d (64 x 256 f32, this thread's 128) += A (64 x 16) W^T (16 x 256)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t dw) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : HMR_ACC64(0), HMR_ACC64(64)
      : "l"(da), "l"(dw), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are in flight between issue and wait)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... (the N tiles
// of one row block next to each other, so concurrent blocks share A rows in
// L2). Producer and consumers walk the same sequence of (tile, K step), so
// the ring's phases carry over from tile to tile and the producer fills
// the next tile's stages while the consumers run an epilogue.
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                 const bf16* __restrict__ bias, const bf16* res, bf16* C, int M, int N, int K,
                 int relu, int rq, int rf) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t tiles_w = base + kStages * kTileA;
  const uint32_t staging = base + kStages * (kTileA + kTileW);
  const uint32_t full = staging + 2 * kStaging, empty = full + 8 * kStages;
  const int nk = (K + kGK - 1) / kGK;
  const int tiles_n = (N + kGN - 1) / kGN, tiles = tiles_n * ((M + kGM - 1) / kGM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kGM, n0 = tile % tiles_n * kGN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages, round = it / kStages;
          mbar_wait(empty + 8 * s, (round & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kTileA + kTileW);
          tma_load_2d(base + s * kTileA, &tm_a, full + 8 * s, kt * kGK, m0);
          tma_load_2d(tiles_w + s * kTileW, &tm_w, full + 8 * s, kt * kGK, n0);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const uint32_t stage = staging + wg * kStaging;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kGM, n0 = tile % tiles_n * kGN;
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      // one wgmma group in flight while the next stage is waited for: a
      // stage is released once the group that read it has completed
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages, round = it / kStages;
        mbar_wait(full + 8 * s, round & 1);
        const uint32_t a = base + s * kTileA + wg * 64 * 128, w = tiles_w + s * kTileW;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kGK / 16; ++kk)
          wgmma_m64n256k16(d, desc_sw128(a + kk * 32), desc_sw128(w + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(d);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
      // Epilogue (epilogue<bf16>'s roundings). d[4i + 2h + e] is row
      // 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2 t + e of this
      // warpgroup's 64 x 256 part. Each value is rounded to bf16 (the
      // epilogue's first rounding) and stored with stmatrix to the
      // warpgroup's staging rows; then each warp takes whole rows, so bias,
      // residual and output move in 16-byte accesses, 512 contiguous bytes
      // per warp. Each thread reads the residual of exactly the elements it
      // writes, so C == res (the in-place h += ...) is race-free; all its
      // residual loads are issued first (res may alias C, so a load placed
      // after a store would wait for it).
      const int tt = threadIdx.x % 128;
      uint4 rv[kEpi] = {};
#pragma unroll
      for (int k = 0; k < kEpi; ++k) {
        const int e = tt + 128 * k, r = m0 + 64 * wg + e / 32, c = n0 + 8 * (e % 32);
        if (res != nullptr && r < M && c < N)
          rv[k] = *reinterpret_cast<const uint4*>(res + res_row(r, rq, rf) * N + c);
      }
      // stmatrix.x4: lanes 8 j .. 8 j + 7 address the rows of 8 x 8 block j
      // = (column group i + j / 2, rows + 8 (j % 2))
      const uint32_t srow =
          stage + ((16 * (warp % 4) + 8 * ((lane / 8) & 1) + lane % 8) * kLdS + 8 * (lane / 16)) * 2;
#pragma unroll
      for (int i = 0; i < kGN / 8; i += 2)
        asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         srow + 16 * i),
                     "r"(pack_pair(d[4 * i], d[4 * i + 1])),
                     "r"(pack_pair(d[4 * i + 2], d[4 * i + 3])),
                     "r"(pack_pair(d[4 * i + 4], d[4 * i + 5])),
                     "r"(pack_pair(d[4 * i + 6], d[4 * i + 7]))
                     : "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int k = 0; k < kEpi; ++k) {
        const int e = tt + 128 * k, r = m0 + 64 * wg + e / 32, c = n0 + 8 * (e % 32);
        if (r >= M || c >= N) continue;  // N % 8 == 0: all 8 columns or none
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(stage + ((e / 32) * kLdS + 8 * (e % 32)) * 2)
                     : "memory");
        // the rest of epilogue<bf16> on pairs: a bf16 add rounds the exact
        // sum once, which equals rounding the f32 sum (two bf16 values'
        // f32 sum is exact unless their exponents differ by > 16, and then
        // it cannot lie at a bf16 rounding midpoint)
        const uint4 bv = *reinterpret_cast<const uint4*>(bias + c);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[k]);
        __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (res != nullptr) v2[j] = __hadd2(r2[j], v2[j]);
          v2[j] = __hadd2(v2[j], b2[j]);
          if (relu) v2[j] = __hmax2(v2[j], __float2bfloat162_rn(0.f));
        }
        *reinterpret_cast<uint4*>(C + static_cast<size_t>(r) * N + c) = v;
      }
      // the staging rows are free again once every warp has read them
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
  }
}

// ---- attention, f32: one block per (sample, head), CUDA cores ---------------
// qkv rows are [q | k | v] (3H wide), head hi owns columns hi*hd .. +hd of
// each. Scores s = (q k^T) * scale in f32, softmax in f32, weights rounded
// to T, then (w v) with f32 sums, rounded to T. Query rows i < Fq are
// written, to out row b * Fq + i, columns hi*hd ...
__global__ void attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int F,
                                     int Fq, int H, int nh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, hi = blockIdx.y, hd = H / nh;
  const int ld = hd + 1;  // odd word stride: no bank conflicts
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + F * ld;
  float* vs = ks + F * ld;
  float* S = vs + F * ld;
  const size_t base = static_cast<size_t>(b) * F * 3 * H + static_cast<size_t>(hi) * hd;
  for (int e = threadIdx.x; e < F * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float* src = qkv + base + static_cast<size_t>(i) * 3 * H + d;
    qs[i * ld + d] = src[0];
    ks[i * ld + d] = src[H];
    vs[i * ld + d] = src[2 * H];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Fq * F; e += blockDim.x) {
    const int i = e / F, j = e % F;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qs[i * ld + d], ks[j * ld + d], acc);
    S[e] = __fmul_rn(acc, scale);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarp = blockDim.x / 32;
  for (int i = warp; i < Fq; i += nwarp) {
    float* row = S + i * F;
    float m = -INFINITY;
    for (int j = lane; j < F; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < F; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < F; j += 32) row[j] = __fdiv_rn(expf(row[j] - m), sum);
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(b) * Fq * H + static_cast<size_t>(hi) * hd;
  for (int e = threadIdx.x; e < Fq * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    float acc = 0.f;
    for (int j = 0; j < F; ++j) acc = fmaf(S[i * F + j], vs[j * ld + d], acc);
    dst[static_cast<size_t>(i) * H + d] = acc;
  }
}

// ---- attention, bf16: tensor cores (mma.sync m16n8k16) ----------------------
// Tokens are padded to FP = 16 NT rows and the head width hd (a multiple
// of 8) to HD columns, zeros in shared memory. Each
// (sample, head) pair takes NT warps, warp qt computing query rows
// 16 qt .. 16 qt + 15: S = Q K^T into registers (f32), scale, mask the
// padded keys to -inf, row max, expf, sum, divide, round to bf16 — the
// plain two-pass softmax, not an online one — then O = P V with the
// weights taken straight from the score registers as the A operand.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared row of a padded tile: HD + 8 bf16, so the 8 rows x 4 words of a
// fragment load fall in 32 distinct banks
__host__ __device__ constexpr int attn_ld(int hd) { return hd + 8; }
// threads a block may have: the wider the head, the more registers a warp
// holds (scores 8 NT and outputs HD / 2 per thread)
__host__ __device__ constexpr int attn_threads(int hd) { return hd <= 16 ? 1024 : hd <= 64 ? 512 : 256; }

template <int NT, int HD>
__global__ void __launch_bounds__(attn_threads(HD))
attention_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int B,
                                      int F, int Fq, int H, int nh, float scale) {
  const int hd = H / nh;
  constexpr int FP = 16 * NT, LD = attn_ld(HD);
  extern __shared__ uint4 smem_u4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_u4);
  const int per_block = blockDim.x / (32 * NT), n_pairs = B * nh;
  // load every pair of the block: q, k, v rows in 16-byte asynchronous
  // copies, all in flight at once; zeros past F, hd and the last pair
  constexpr int cpr = HD / 8;
  for (int e = threadIdx.x; e < per_block * 3 * FP * cpr; e += blockDim.x) {
    const int c = e % cpr, row = (e / cpr) % FP, part = (e / (cpr * FP)) % 3,
              slot = e / (cpr * FP * 3);
    const int pair = blockIdx.x * per_block + slot;
    const bool ok = pair < n_pairs && row < F && 8 * c < hd;
    const bf16* src = qkv;
    if (ok)
      src += (static_cast<size_t>(pair / nh) * F + row) * 3 * H + part * H + (pair % nh) * hd + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(smem + ((slot * 3 + part) * FP + row) * LD + c * 8)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / NT, qt = warp % NT, pair = blockIdx.x * per_block + slot;
  if (pair >= n_pairs || 16 * qt >= Fq) return;
  const bf16* qs = smem + slot * 3 * FP * LD;
  const bf16* ks = qs + FP * LD;
  const bf16* vs = ks + FP * LD;
  const int g = lane / 4, t = lane % 4;

  // s[j] is rows g and g + 8 of this warp's query tile against keys 8 j ..
  // 8 j + 7: s[j][0..1] row g, keys 8 j + 2 t + {0, 1}; s[j][2..3] row g + 8
  float s[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* qa = qs + (16 * qt + g) * LD + 16 * kk + 2 * t;
    const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD), ld_pair(qa + 8),
                           ld_pair(qa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const bf16* kb = ks + (8 * j + g) * LD + 16 * kk + 2 * t;
      mma_16816(s[j], a, ld_pair(kb), ld_pair(kb + 8));
    }
  }
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = 8 * j + 2 * t + (e & 1) < F;
      s[j][e] = valid ? __fmul_rn(s[j][e], scale) : -INFINITY;
      m[e / 2] = fmaxf(m[e / 2], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e / 2]);
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], sum[e / 2]);

  // O = P V: the score layout is the A-operand layout of the next product
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const uint32_t a[4] = {pack_pair(s[2 * kk][0], s[2 * kk][1]),
                           pack_pair(s[2 * kk][2], s[2 * kk][3]),
                           pack_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_pair(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    // V fragments of n-tiles j, j + 1 in one ldmatrix.x4.trans: lane l
    // addresses row 16 kk + 8 ((l / 8) & 1) + l % 8, columns 8 (j + l / 16)
    const uint32_t vrow = smem_u32(vs + (16 * kk + 8 * ((lane / 8) & 1) + lane % 8) * LD +
                                   8 * (lane / 16));
#pragma unroll
    for (int j = 0; j < HD / 8; j += 2) {
      uint32_t b[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(vrow + 16 * j));
      mma_16816(o[j], a, b[0], b[1]);
      mma_16816(o[j + 1], a, b[2], b[3]);
    }
  }
  const int b = pair / nh, hi = pair % nh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 16 * qt + g + 8 * hh;
    if (row >= Fq) continue;
    bf16* dst = out + (static_cast<size_t>(b) * Fq + row) * H + hi * hd + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (8 * j < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * hh], o[j][2 * hh + 1]);
  }
}

// ---- head: one warp per output scalar ---------------------------------------
// h holds F rows per sample; the first Sd of each are read
template <typename T>
__global__ void head_kernel(const T* __restrict__ h, const T* __restrict__ w_head, float b_out,
                            float* __restrict__ out, int B, int F, int Sd, int H) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= B * Sd) return;
  const T* src = h + (static_cast<size_t>(o / Sd) * F + o % Sd) * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += rnd<T>(__fmul_rn(tof(src[c]), tof(w_head[c])));
  s = warp_sum(s);
  if (lane == 0) out[o] = __fadd_rn(s, b_out);
}

// ---- launchers: one per kernel kind, shared by the forward and the
// stage-by-stage entry points below. Each returns 0 or a cudaError. --------
enum { kRowwise, kGemm, kAttention, kHead, kKinds };

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

// encode (x, enc, pos -> out) or LayerNorm (in, ln -> out), M rows
template <typename T>
int launch_rowwise(bool encode, const float* x, const T* in, const T* vecs, const T* pos, T* out,
                   int M, int F, int H, cudaStream_t st) {
  const int blocks = (M + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (encode)
    rowwise_kernel<T, true><<<blocks, kRowThreads, 0, st>>>(x, nullptr, vecs, pos, out, M, F, H);
  else
    rowwise_kernel<T, false><<<blocks, kRowThreads, 0, st>>>(nullptr, in, vecs, nullptr, out, M, F, H);
  return static_cast<int>(cudaGetLastError());
}

// C (M, N) = epilogue(A (M, K) W (N, K)^T); res, if given, holds rf rows per
// sample where C holds rq
int gemm(const float* A, const float* W, const float* bias, const float* res, float* C, int M,
         int N, int K, int relu, int rq, int rf, cudaStream_t st) {
  const dim3 grid((N + kSB - 1) / kSB, (M + kSB - 1) / kSB);
  gemm_f32_kernel<<<grid, 256, 0, st>>>(A, W, bias, res, C, M, N, K, relu, rq, rf);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (rows, K) row-major bf16 matrix, read in 64 x box_rows boxes with the
// 128-byte swizzle; rows past the end and columns past K read as zeros
bool tensor_map(CUtensorMap* map, const bf16* p, int rows, int K, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(bf16)};
  const cuuint32_t box[2] = {kGK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int gemm(const bf16* A, const bf16* W, const bf16* bias, const bf16* res, bf16* C, int M, int N,
         int K, int relu, int rq, int rf, cudaStream_t st) {
  CUtensorMap tm_a, tm_w;
  if (!tensor_map(&tm_a, A, M, K, kGM) || !tensor_map(&tm_w, W, N, K, kGN))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
  }
  const long tiles = static_cast<long>((N + kGN - 1) / kGN) * ((M + kGM - 1) / kGM);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one block per SM
  gemm_bf16_kernel<<<grid, kGemmThreads, kGemmSmem, st>>>(tm_a, tm_w, bias, res, C, M, N, K, relu,
                                                          rq, rf);
  return static_cast<int>(cudaGetLastError());
}

// qkv (B*F, 3H) -> out (B*Fq, H): query rows f < Fq of each sample
int launch_attention(const float* qkv, float* out, int B, int F, int Fq, int H, int nh,
                     float scale, cudaStream_t st) {
  const int hd = H / nh;
  const size_t smem = (3 * static_cast<size_t>(F) * (hd + 1) + static_cast<size_t>(F) * F) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_f32_kernel<<<dim3(B, nh), 256, smem, st>>>(qkv, out, F, Fq, H, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int HD>
int attention_bf16(const bf16* qkv, bf16* out, int B, int F, int Fq, int H, int nh, float scale,
                   cudaStream_t st) {
  // pairs per block: enough that a block moves >= 64 KB of q, k, v, within
  // attn_threads(HD) threads and ~110 KB of shared memory (two blocks per SM)
  const int pair_bytes = 3 * F * (H / nh) * 2;
  const int pair_smem = 3 * 16 * NT * attn_ld(HD) * 2;
  int per = (65536 + pair_bytes - 1) / pair_bytes;
  per = min(per, attn_threads(HD) / (32 * NT));
  per = min(per, max(1, 110 * 1024 / pair_smem));
  per = max(1, min(per, B * nh));
  const int smem = per * pair_smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bf16_kernel<NT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, 110 * 1024);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (B * nh + per - 1) / per;
  attention_bf16_kernel<NT, HD><<<blocks, 32 * NT * per, smem, st>>>(qkv, out, B, F, Fq, H, nh,
                                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int attention_bf16_hd(const bf16* qkv, bf16* out, int B, int F, int Fq, int H, int nh, float scale,
                      cudaStream_t st) {
  const int hd = H / nh;
  if (hd % 8 != 0 || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 16) return attention_bf16<NT, 16>(qkv, out, B, F, Fq, H, nh, scale, st);
  if (hd <= 32) return attention_bf16<NT, 32>(qkv, out, B, F, Fq, H, nh, scale, st);
  if (hd <= 64) return attention_bf16<NT, 64>(qkv, out, B, F, Fq, H, nh, scale, st);
  return attention_bf16<NT, 128>(qkv, out, B, F, Fq, H, nh, scale, st);
}

// bf16 attention takes F <= 64 tokens and head widths that are multiples
// of 8 up to 128 (padded to 16, 32, 64 or 128)
int launch_attention(const bf16* qkv, bf16* out, int B, int F, int Fq, int H, int nh, float scale,
                     cudaStream_t st) {
  switch ((F + 15) / 16) {
    case 1: return attention_bf16_hd<1>(qkv, out, B, F, Fq, H, nh, scale, st);
    case 2: return attention_bf16_hd<2>(qkv, out, B, F, Fq, H, nh, scale, st);
    case 3: return attention_bf16_hd<3>(qkv, out, B, F, Fq, H, nh, scale, st);
    case 4: return attention_bf16_hd<4>(qkv, out, B, F, Fq, H, nh, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_head(const T* h, const T* w_head, float b_out, float* out, int B, int F, int Sd, int H,
                cudaStream_t st) {
  const int blocks = (B * Sd + kRowThreads / 32 - 1) / (kRowThreads / 32);
  head_kernel<T><<<blocks, kRowThreads, 0, st>>>(h, w_head, b_out, out, B, F, Sd, H);
  return static_cast<int>(cudaGetLastError());
}

// ---- the forward ------------------------------------------------------------
// w: [enc (5,H), pos (F,H)] then per layer [ln1 (2,H), w_qkv (3H,H),
// b_qkv (3H), w_o (H,H), b_o (H), ln2 (2,H), w1 (4H,H), b1 (4H),
// w2 (H,4H), b2 (H)]; scratch h ((M + B*Sd) * H: the residual stream, then
// the last layer's compacted state rows), y (M*H) and big (M*4H), M = B*F.
template <typename T>
int forward(const float* x, float* out, const void* const* w, T* h, T* y, T* big, int B, int F,
            int Sd, int H, int nh, int L, float b_out, float scale, cudaStream_t st, int* counts) {
  const int M = B * F;
  T* hc = h + static_cast<size_t>(M) * H;
  auto wt = [&](int i) { return static_cast<const T*>(w[i]); };
  auto count = [&](int kind, int e) {
    ++counts[kind];
    return e;
  };
  if (int e = count(kRowwise, launch_rowwise<T>(true, x, nullptr, wt(0), wt(1), h, M, F, H, st)))
    return e;
  T* cur = h;
  int Fc = F;
  for (int l = 0; l < L; ++l) {
    const int p = 2 + 10 * l;
    const int Fq = l == L - 1 ? Sd : F, Mq = B * Fq;
    T* hn = l == L - 1 ? hc : h;
    if (int e = count(kRowwise, launch_rowwise<T>(false, nullptr, h, wt(p), nullptr, y, M, F, H, st)))
      return e;
    if (int e = count(kGemm, gemm(y, wt(p + 1), wt(p + 2), static_cast<const T*>(nullptr), big, M,
                                  3 * H, H, 0, F, F, st)))
      return e;
    if (int e = count(kAttention, launch_attention(big, y, B, F, Fq, H, nh, scale, st))) return e;
    if (int e = count(kGemm, gemm(y, wt(p + 3), wt(p + 4), h, hn, Mq, H, H, 0, Fq, F, st)))
      return e;
    if (int e = count(kRowwise, launch_rowwise<T>(false, nullptr, hn, wt(p + 5), nullptr, y, Mq, F,
                                                  H, st)))
      return e;
    if (int e = count(kGemm, gemm(y, wt(p + 6), wt(p + 7), static_cast<const T*>(nullptr), big, Mq,
                                  4 * H, H, 1, Fq, Fq, st)))
      return e;
    if (int e = count(kGemm, gemm(big, wt(p + 8), wt(p + 9), hn, hn, Mq, H, 4 * H, 0, Fq, Fq, st)))
      return e;
    cur = hn;
    Fc = Fq;
  }
  return count(kHead, launch_head<T>(cur, wt(0) + 4 * H, b_out, out, B, Fc, Sd, H, st));
}

}  // namespace

extern "C" {

// Number of kernel kinds counted in `counts` (rowwise, gemm, attention, head).
int hmr_estimator_kinds() { return kKinds; }

// Launches the whole forward on `stream`; returns the first nonzero
// cudaError (0 = every kernel launched). counts[kind] += launches.
int hmr_estimator_forward(int is_bf16, const void* x, void* out, const void* const* w, int n_w,
                          void* h, void* y, void* big, int B, int F, int Sd, int H, int nh, int L,
                          float b_out, float scale, void* stream, int* counts) {
  if (n_w != 2 + 10 * L || H % 8 != 0 || H % nh != 0 || B <= 0 || Sd > F)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (is_bf16)
    return forward<bf16>(xf, of, w, static_cast<bf16*>(h), static_cast<bf16*>(y),
                         static_cast<bf16*>(big), B, F, Sd, H, nh, L, b_out, scale, st, counts);
  return forward<float>(xf, of, w, static_cast<float*>(h), static_cast<float*>(y),
                        static_cast<float*>(big), B, F, Sd, H, nh, L, b_out, scale, st, counts);
}

// One kernel of the forward on the caller's buffers, so that each can be
// held against its plain version alone. Each returns 0 or a cudaError.
int hmr_estimator_rowwise(int is_bf16, int encode, const float* x, const void* in,
                          const void* vecs, const void* pos, void* out, int M, int F, int H,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rowwise<bf16>(encode, x, static_cast<const bf16*>(in),
                                static_cast<const bf16*>(vecs), static_cast<const bf16*>(pos),
                                static_cast<bf16*>(out), M, F, H, st);
  return launch_rowwise<float>(encode, x, static_cast<const float*>(in),
                               static_cast<const float*>(vecs), static_cast<const float*>(pos),
                               static_cast<float*>(out), M, F, H, st);
}

// C (M, N) = epilogue(A (M, K) W (N, K)^T); res holds rf rows per sample
// where C holds rq (rq == rf: row for row)
int hmr_estimator_gemm(int is_bf16, const void* A, const void* W, const void* bias,
                       const void* res, void* C, int M, int N, int K, int relu, int rq, int rf,
                       void* stream) {
  if (N % 8 != 0 || K % 8 != 0 || rq <= 0 || rq > rf) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return gemm(static_cast<const bf16*>(A), static_cast<const bf16*>(W),
                static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
                static_cast<bf16*>(C), M, N, K, relu, rq, rf, st);
  return gemm(static_cast<const float*>(A), static_cast<const float*>(W),
              static_cast<const float*>(bias), static_cast<const float*>(res),
              static_cast<float*>(C), M, N, K, relu, rq, rf, st);
}

int hmr_estimator_attention(int is_bf16, const void* qkv, void* out, int B, int F, int Fq, int H,
                            int nh, float scale, void* stream) {
  if (H % nh != 0 || Fq > F) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), B, F, Fq, H,
                            nh, scale, st);
  return launch_attention(static_cast<const float*>(qkv), static_cast<float*>(out), B, F, Fq, H,
                          nh, scale, st);
}

int hmr_estimator_head(int is_bf16, const void* h, const void* w_head, float b_out, float* out,
                       int B, int F, int Sd, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_head<bf16>(static_cast<const bf16*>(h), static_cast<const bf16*>(w_head), b_out,
                             out, B, F, Sd, H, st);
  return launch_head<float>(static_cast<const float*>(h), static_cast<const float*>(w_head), b_out,
                            out, B, F, Sd, H, st);
}

}  // extern "C"
