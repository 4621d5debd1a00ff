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
// Design: a few kernels per layer, launched in order on one stream by
// hmr_estimator_forward (2 + 7 L launches per forward):
//   rowwise    one warp per token row: the encode, or a LayerNorm
//   gemm       C = epilogue(A W): bf16 on tensor cores (nvcuda::wmma
//              16x16x16 tiles, 128x128x32 block tiles, cp.async double
//              buffering); f32 as a plain FMA tiled product (no TF32)
//   attention  one block per (sample, head): q, k, v of the sample in
//              shared memory, the F x F scores too
//   head       one warp per output scalar
// The epilogue fuses the bias, the ReLU and the residual add, with the
// same roundings as the TPU kernel. Each kind also has an entry point of
// its own (hmr_estimator_rowwise/gemm/attention/head), through the same
// launcher, so a check can hold one kernel at a time against its plain
// version on inputs whose sums are exact in any order.
//
// What bounds it: the operations. A forward of quadruped_attention at
// B=2048 needs 1.15 TFLOP of products (12 H^2 MACs per token per layer,
// except that in the last layer the action tokens need only their K and V),
// 1.16 ms at the card's 989 TFLOP/s bf16 peak. This design computes every
// token through the last layer as well, 10% more products than needed.
// Its own inputs and outputs are
// ~0.8 MB and the weights 12.6 MB (L2-resident). This layer-wise design also
// moves its activations through device memory (26 row-widths of H per
// token per layer, ~5.4 GB at B=2048), which takes ~1.6 ms at 3.35 TB/s,
// so as built it is held by those bytes before the products. What the
// design does about the products: every GEMM runs on tensor cores, the N
// tiles of one row block run next to each other so the A rows come from L2,
// and the weights (<= 2 MB per matrix) stay in L2. Attention (1.6% of the
// products) stays on CUDA cores, padded shared rows keep it free of bank
// conflicts. A fused kernel that keeps each block's residual stream on chip
// (as the TPU kernel does) would drop those activation bytes: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstddef>

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

// ---- f32 GEMM: C (M,N) = A (M,K) W (K,N), plain FMA, 64x64 tiles ------------
constexpr int kSB = 64, kSK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* res, float* C,
                int M, int N, int K, int relu) {
  __shared__ float As[kSK][kSB + 1];
  __shared__ float Bs[kSK][kSB];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int m0 = blockIdx.y * kSB, n0 = blockIdx.x * kSB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSK) {
    for (int e = tid; e < kSB * kSK; e += 256) {
      const int r = e / kSK, ka = e % kSK;
      As[ka][r] = (m0 + r < M && k0 + ka < K) ? A[static_cast<size_t>(m0 + r) * K + k0 + ka] : 0.f;
      const int kb = e / kSB, n = e % kSB;
      Bs[kb][n] = (k0 + kb < K && n0 + n < N) ? W[static_cast<size_t>(k0 + kb) * N + n0 + n] : 0.f;
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
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tc * 4 + j;
      if (c >= N) continue;
      const size_t o = static_cast<size_t>(r) * N + c;
      C[o] = epilogue<float>(acc[i][j], bias[c], res ? res + o : nullptr, relu);
    }
  }
}

// ---- bf16 GEMM on tensor cores ----------------------------------------------
// Block tile 128x128x32, 8 warps of 64x32, wmma 16x16x16 with f32
// accumulators; K and N are multiples of 8 so a 16-byte chunk is wholly in
// or out of range, and out-of-range chunks are zero-filled by cp.async.
constexpr int kBM = 128, kBN = 128, kBK = 32, kLDA = kBK + 8, kLDB = kBN + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const bf16* __restrict__ bias, const bf16* res, bf16* C,
                 int M, int N, int K, int relu) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][kBM][kLDA];
  __shared__ __align__(128) bf16 Bs[2][kBK][kLDB];
  __shared__ __align__(128) float Cs[8][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int stage, int k0) {
    for (int c = tid; c < kBM * kBK / 8; c += 256) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(&As[stage][r][kc], ok ? A + static_cast<size_t>(m0 + r) * K + k0 + kc : A,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < kBK * kBN / 8; c += 256) {
      const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(&Bs[stage][r][nc], ok ? W + static_cast<size_t>(k0 + r) * N + n0 + nc : W,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  const int nk = (K + kBK - 1) / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[s][wm * 64 + i * 16][kk], kLDA);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[s][kk][wn * 32 + j * 16], kLDB);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through a per-warp 16x16 staging tile: lane -> row lane/2,
  // 8 columns starting at (lane % 2) * 8, one 16-byte store
  float* cs = Cs[warp];
  const int r = lane / 2, c0 = (lane % 2) * 8;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r, gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < N) {
        const size_t o = static_cast<size_t>(gr) * N + gc;
        __align__(16) bf16 rv[8];
        __align__(16) bf16 ov[8];
        if (res != nullptr) *reinterpret_cast<uint4*>(rv) = *reinterpret_cast<const uint4*>(res + o);
        for (int e = 0; e < 8; ++e)
          ov[e] = __float2bfloat16_rn(epilogue<bf16>(cs[r * 16 + c0 + e], tof(bias[gc + e]),
                                                     res != nullptr ? rv + e : nullptr, relu));
        *reinterpret_cast<uint4*>(C + o) = *reinterpret_cast<const uint4*>(ov);
      }
      __syncwarp();
    }
  }
}

// ---- attention: one block per (sample, head) --------------------------------
// qkv rows are [q | k | v] (3H wide), head hi owns columns hi*hd .. +hd of
// each. Scores s = (q k^T) * scale in f32, softmax in f32, weights rounded
// to T, then (w v) with f32 sums, rounded to T, into out[:, hi*hd ..].
template <typename T>
__global__ void attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int F, int H,
                                 int nh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, hi = blockIdx.y, hd = H / nh;
  const int ld = hd + 4 / static_cast<int>(sizeof(T));  // odd word stride: no bank conflicts
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + F * ld;
  T* vs = ks + F * ld;
  float* S = reinterpret_cast<float*>(vs + F * ld + (F * ld) % 2);
  const size_t base = static_cast<size_t>(b) * F * 3 * H + static_cast<size_t>(hi) * hd;
  for (int e = threadIdx.x; e < F * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const T* src = qkv + base + static_cast<size_t>(i) * 3 * H + d;
    qs[i * ld + d] = src[0];
    ks[i * ld + d] = src[H];
    vs[i * ld + d] = src[2 * H];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < F * F; e += blockDim.x) {
    const int i = e / F, j = e % F;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(tof(qs[i * ld + d]), tof(ks[j * ld + d]), acc);
    S[e] = __fmul_rn(acc, scale);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarp = blockDim.x / 32;
  for (int i = warp; i < F; i += nwarp) {
    float* row = S + i * F;
    float m = -INFINITY;
    for (int j = lane; j < F; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < F; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < F; j += 32) row[j] = rnd<T>(__fdiv_rn(expf(row[j] - m), sum));
  }
  __syncthreads();
  T* dst = out + static_cast<size_t>(b) * F * H + static_cast<size_t>(hi) * hd;
  for (int e = threadIdx.x; e < F * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    float acc = 0.f;
    for (int j = 0; j < F; ++j) acc = fmaf(S[i * F + j], tof(vs[j * ld + d]), acc);
    dst[static_cast<size_t>(i) * H + d] = fromf<T>(acc);
  }
}

// ---- head: one warp per output scalar ---------------------------------------
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
// stage-by-stage entry points below ------------------------------------------
enum { kRowwise, kGemm, kAttention, kHead, kKinds };

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

// encode (x, enc, pos -> out) or LayerNorm (in, ln -> out), M = B * F rows
template <typename T>
void launch_rowwise(bool encode, const float* x, const T* in, const T* vecs, const T* pos, T* out,
                    int M, int F, int H, cudaStream_t st) {
  const int blocks = (M + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (encode)
    rowwise_kernel<T, true><<<blocks, kRowThreads, 0, st>>>(x, nullptr, vecs, pos, out, M, F, H);
  else
    rowwise_kernel<T, false><<<blocks, kRowThreads, 0, st>>>(nullptr, in, vecs, nullptr, out, M, F, H);
}

void gemm(const float* A, const float* W, const float* bias, const float* res, float* C, int M,
          int N, int K, int relu, cudaStream_t st) {
  const dim3 grid((N + kSB - 1) / kSB, (M + kSB - 1) / kSB);
  gemm_f32_kernel<<<grid, 256, 0, st>>>(A, W, bias, res, C, M, N, K, relu);
}

void gemm(const bf16* A, const bf16* W, const bf16* bias, const bf16* res, bf16* C, int M, int N,
          int K, int relu, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<<<grid, 256, 0, st>>>(A, W, bias, res, C, M, N, K, relu);
}

// qkv (B*F, 3H) -> out (B*F, H); shared memory above 48 KB is opted into
template <typename T>
int launch_attention(const T* qkv, T* out, int B, int F, int H, int nh, float scale,
                     cudaStream_t st) {
  const int hd = H / nh;
  const int ld = hd + 4 / static_cast<int>(sizeof(T));
  const size_t smem = (3 * static_cast<size_t>(F) * ld + (F * ld) % 2) * sizeof(T) +
                      static_cast<size_t>(F) * F * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_kernel<T><<<dim3(B, nh), 256, smem, st>>>(qkv, out, F, H, nh, scale);
  return 0;
}

template <typename T>
void launch_head(const T* h, const T* w_head, float b_out, float* out, int B, int F, int Sd, int H,
                 cudaStream_t st) {
  const int blocks = (B * Sd + kRowThreads / 32 - 1) / (kRowThreads / 32);
  head_kernel<T><<<blocks, kRowThreads, 0, st>>>(h, w_head, b_out, out, B, F, Sd, H);
}

// ---- the forward ------------------------------------------------------------
// w: [enc (5,H), pos (F,H)] then per layer [ln1 (2,H), w_qkv (H,3H),
// b_qkv (3H), w_o (H,H), b_o (H), ln2 (2,H), w1 (H,4H), b1 (4H),
// w2 (4H,H), b2 (H)]; scratch h, y (M*H) and big (M*4H), M = B*F.
template <typename T>
int forward(const float* x, float* out, const void* const* w, T* h, T* y, T* big, int B, int F,
            int Sd, int H, int nh, int L, float b_out, float scale, cudaStream_t st, int* counts) {
  const int M = B * F;
  auto wt = [&](int i) { return static_cast<const T*>(w[i]); };
  auto check = [&](int kind) {
    ++counts[kind];
    return static_cast<int>(cudaGetLastError());
  };
  launch_rowwise<T>(true, x, nullptr, wt(0), wt(1), h, M, F, H, st);
  if (int e = check(kRowwise)) return e;
  for (int l = 0; l < L; ++l) {
    const int p = 2 + 10 * l;
    launch_rowwise<T>(false, nullptr, h, wt(p), nullptr, y, M, F, H, st);
    if (int e = check(kRowwise)) return e;
    gemm(y, wt(p + 1), wt(p + 2), static_cast<const T*>(nullptr), big, M, 3 * H, H, 0, st);
    if (int e = check(kGemm)) return e;
    if (int e = launch_attention<T>(big, y, B, F, H, nh, scale, st)) return e;
    if (int e = check(kAttention)) return e;
    gemm(y, wt(p + 3), wt(p + 4), h, h, M, H, H, 0, st);
    if (int e = check(kGemm)) return e;
    launch_rowwise<T>(false, nullptr, h, wt(p + 5), nullptr, y, M, F, H, st);
    if (int e = check(kRowwise)) return e;
    gemm(y, wt(p + 6), wt(p + 7), static_cast<const T*>(nullptr), big, M, 4 * H, H, 1, st);
    if (int e = check(kGemm)) return e;
    gemm(big, wt(p + 8), wt(p + 9), h, h, M, H, 4 * H, 0, st);
    if (int e = check(kGemm)) return e;
  }
  launch_head<T>(h, wt(0) + 4 * H, b_out, out, B, F, Sd, H, st);
  return check(kHead);
}

}  // namespace

extern "C" {

// Number of kernel kinds counted in `counts` (rowwise, gemm, attention, head).
int hmr_estimator_kinds() { return kKinds; }

// Launches the whole forward on `stream`; returns the first nonzero
// cudaGetLastError() (0 = every kernel launched). counts[kind] += launches.
int hmr_estimator_forward(int is_bf16, const void* x, void* out, const void* const* w, int n_w,
                          void* h, void* y, void* big, int B, int F, int Sd, int H, int nh, int L,
                          float b_out, float scale, void* stream, int* counts) {
  if (n_w != 2 + 10 * L || H % 8 != 0 || H % nh != 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
// held against its plain version alone. Each returns cudaGetLastError().
int hmr_estimator_rowwise(int is_bf16, int encode, const float* x, const void* in,
                          const void* vecs, const void* pos, void* out, int M, int F, int H,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_rowwise<bf16>(encode, x, static_cast<const bf16*>(in), static_cast<const bf16*>(vecs),
                         static_cast<const bf16*>(pos), static_cast<bf16*>(out), M, F, H, st);
  else
    launch_rowwise<float>(encode, x, static_cast<const float*>(in), static_cast<const float*>(vecs),
                          static_cast<const float*>(pos), static_cast<float*>(out), M, F, H, st);
  return static_cast<int>(cudaGetLastError());
}

int hmr_estimator_gemm(int is_bf16, const void* A, const void* W, const void* bias,
                       const void* res, void* C, int M, int N, int K, int relu, void* stream) {
  if (N % 8 != 0 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    gemm(static_cast<const bf16*>(A), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
         static_cast<const bf16*>(res), static_cast<bf16*>(C), M, N, K, relu, st);
  else
    gemm(static_cast<const float*>(A), static_cast<const float*>(W),
         static_cast<const float*>(bias), static_cast<const float*>(res), static_cast<float*>(C),
         M, N, K, relu, st);
  return static_cast<int>(cudaGetLastError());
}

int hmr_estimator_attention(int is_bf16, const void* qkv, void* out, int B, int F, int H, int nh,
                            float scale, void* stream) {
  if (H % nh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = is_bf16 ? launch_attention<bf16>(static_cast<const bf16*>(qkv),
                                                 static_cast<bf16*>(out), B, F, H, nh, scale, st)
                        : launch_attention<float>(static_cast<const float*>(qkv),
                                                  static_cast<float*>(out), B, F, H, nh, scale, st);
  return e ? e : static_cast<int>(cudaGetLastError());
}

int hmr_estimator_head(int is_bf16, const void* h, const void* w_head, float b_out, float* out,
                       int B, int F, int Sd, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_head<bf16>(static_cast<const bf16*>(h), static_cast<const bf16*>(w_head), b_out, out, B,
                      F, Sd, H, st);
  else
    launch_head<float>(static_cast<const float*>(h), static_cast<const float*>(w_head), b_out, out,
                       B, F, Sd, H, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
