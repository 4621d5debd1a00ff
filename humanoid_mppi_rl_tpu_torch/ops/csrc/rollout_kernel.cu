// MPPI rollout kernel for Hopper (sm_90a), one warp per sample.
//
// Replaces the TPU kernel ops/rollout_kernel.py::build_rollout_kernel of the
// JAX package (the Pallas `kernel` launched by pl.pallas_call): every sample
// runs all T horizon steps -- ctrl = clip(U[t] + noise[t]), the penalty-tier
// physics step, FK, the running cost at the step's end time -- and then the
// terminal cost, with the state kept on chip. Device memory sees only the
// initial state and start time, the noise stream, U, the 16 runtime
// parameters, and the outputs. It carries every robot of the JAX registry:
// the humanoid (three costs), the Go1 (quadruped and quadruped_jl costs:
// frictionloss, box corners and exact cylinder rims, a clock-driven trot
// phase), the cartpole and the planar hopper (slide joints; the cartpole
// cost, and the hopper cost with its hop clock), and arm5 (ball joints with
// quaternion springs and a rotation-angle limit, ball/free motors with gear
// vectors, plane-vs-mesh contacts; the arm5 cost), with fixed-tendon and
// site transmissions besides.
//
// What bounds it: the work, not the bytes. The humanoid step is ~24k scalar
// operations, so a replan at K=8192, T=64 is ~1.2e10 (0.185 ms at the f32
// peak), against 44 MB of noise read (13 us). The TPU kernel puts samples
// in the vector lanes with a 1024-sample block in VMEM; on this card 8192
// samples are far too few threads, and one sample's working set (~1.7k
// scalars) far too much for one thread's registers. The first port ran one
// thread per sample: ~2 warps per SM and a 10.6 KB stack frame in local
// memory, 35 ms, idle for latency.
//
// What this design does: a warp cooperates on one sample (rollout_body.cuh:
// the step's phases as loops over bodies, dofs, actuators and mass-matrix
// entries spread over the 32 lanes, tree recursions level by level, a
// __syncwarp between dependent phases), so the threads in flight grow 32x.
// The sample's whole working set lives in dynamic shared memory, sized to
// the model by pack_tables (1,572 scalars for the humanoid), beside one
// copy of the model tables per block; registers hold only the lane's
// current items, so the f32 kernel has no stack frame at 64 registers a
// thread. A block holds S samples (S warps), chosen by the wrapper from the
// occupancy query to maximise the samples resident per SM: shared memory
// holds 32 (one block of 32 warps), so K=8192 runs in two waves. Noise is
// staged per block with cp.async one step ahead (noise[t+1, :, k0:k0+S]
// while step t runs), and state in and out moves through shared memory in
// whole rows. What bounds it now: each warp's chain of dependent phases
// (one sample alone per SM takes ~55% of the full card's time per wave),
// most of it the tree's depth: 15 dof levels in the Cholesky and the two
// solves (the floating base's six run in registers on one lane), 6 body
// levels in the kinematics and the accumulation, at ~1 shared-memory round
// trip and a sync each.
#include <cuda_runtime.h>

#include "rollout_body.cuh"

namespace {

constexpr int kLanes = 32;  // G, the lanes per sample: a whole warp

// f32: up to 32 warps a block, so ptxas holds a thread to 64 registers and a
// full SM can keep 32 samples; f64: up to 8 warps a block
template <typename T> struct Bounds;
template <> struct Bounds<float> { static constexpr int threads = 1024; };
template <> struct Bounds<double> { static constexpr int threads = 256; };

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// noise[t, :, k0:k0+S] into buf (nu, S); samples past K read sample K-1
template <typename T>
__device__ __forceinline__ void stage_noise(T* buf, const T* __restrict__ noise, int t,
                                            int nu, int S, int k0, int K) {
  for (int i = threadIdx.x; i < nu * S; i += blockDim.x) {
    const int a = i / S, j = i - a * S;
    const int k = min(k0 + j, K - 1);
    cp_async<sizeof(T)>(buf + i, noise + ((size_t)t * nu + a) * K + k);
  }
  cp_async_commit();
}

// Shared memory: [Tables][params (NPARAM)][noise (2, nu, S)][workspace (S, ws_size)]
template <typename T, int G>
__global__ void __launch_bounds__(Bounds<T>::threads)
rollout_kernel(const hmr::Tables<T>* __restrict__ tab, const T* __restrict__ qpos0,
               const T* __restrict__ qvel0, const T* __restrict__ time0, const T* __restrict__ U,
               const T* __restrict__ noise, const T* __restrict__ params,
               T* __restrict__ cost, T* __restrict__ qpos_out,
               T* __restrict__ qvel_out, int K, int horizon) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& m = *reinterpret_cast<hmr::Tables<T>*>(smem);
  {
    const int* src = reinterpret_cast<const int*>(tab);
    int* dst = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < int(sizeof(hmr::Tables<T>) / 4); i += blockDim.x)
      dst[i] = src[i];
  }
  T* prm = reinterpret_cast<T*>(smem + sizeof(hmr::Tables<T>));
  if (threadIdx.x < hmr::NPARAM) prm[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  static_assert(G == 32, "hmr::Lanes syncs a whole warp per sample");
  const int S = blockDim.x / G, k0 = blockIdx.x * S;
  const int nu = m.nu;
  T* nz = prm + hmr::NPARAM;
  T* ws = nz + 2 * nu * S;
  const int s = threadIdx.x / G;
  const hmr::Lanes<G> g{static_cast<int>(threadIdx.x % G)};
  T* w = ws + s * m.ws_size;

  // state and start time in, row by row; samples past K run on sample
  // K-1's and write nothing
  {
    const int nq = m.nq, nv = m.nv, wsz = m.ws_size;
    const int oq = m.off[hmr::WS_QPOS], ov = m.off[hmr::WS_QVEL], ot = m.off[hmr::WS_TIME];
    for (int i = threadIdx.x; i < (nq + nv + 1) * S; i += blockDim.x) {
      const int r = i / S, j = i - r * S;
      const int k = min(k0 + j, K - 1);
      ws[j * wsz + (r < nq ? oq + r : r < nq + nv ? ov + r - nq : ot)] =
          r < nq ? qpos0[(size_t)r * K + k]
                 : r < nq + nv ? qvel0[(size_t)(r - nq) * K + k] : time0[k];
    }
  }
  stage_noise(nz, noise, 0, nu, S, k0, K);
  cp_async_wait_all();
  __syncthreads();

  hmr::begin(g, m, w);
  for (int t = 0; t < horizon; ++t) {
    T* cur = nz + (t & 1) * nu * S;
    if (t + 1 < horizon) stage_noise(nz + ((t + 1) & 1) * nu * S, noise, t + 1, nu, S, k0, K);
    hmr::advance(g, m, w, t, U + (size_t)t * nu, cur + s, S, prm);
    cp_async_wait_all();
    __syncthreads();
  }
  hmr::terminal(g, m, w, prm, horizon);

  // outputs, row by row; the sizes and offsets read afresh from the tables
  // (held in registers across the rollout, they would spill)
  __syncthreads();
  {
    const int nq = m.nq, nv = m.nv, wsz = m.ws_size;
    const int oq = m.off[hmr::WS_QPOS], ov = m.off[hmr::WS_QVEL], oc = m.off[hmr::WS_COST];
    for (int j = threadIdx.x; j < S; j += blockDim.x)
      if (k0 + j < K) cost[k0 + j] = ws[j * wsz + oc];
    for (int i = threadIdx.x; i < (nq + nv) * S; i += blockDim.x) {
      const int r = i / S, j = i - r * S;
      if (k0 + j >= K) continue;
      if (r < nq) qpos_out[(size_t)r * K + k0 + j] = ws[j * wsz + oq + r];
      else qvel_out[(size_t)(r - nq) * K + k0 + j] = ws[j * wsz + ov + r - nq];
    }
  }
}

// lets the kernel take up to the card's opt-in shared memory per block
template <typename T, int G>
cudaError_t allow_shared() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rollout_kernel<T, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  }();
  return err;
}

template <typename T, int G = kLanes>
int launch(const void* tab, const void* qpos0, const void* qvel0, const void* time0,
           const void* U, const void* noise, const void* params, void* cost,
           void* qpos_out, void* qvel_out, int K, int horizon, void* stream,
           int samples_per_block, int smem_bytes) {
  const cudaError_t e = allow_shared<T, G>();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (samples_per_block < 1 || samples_per_block * G > Bounds<T>::threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (K + samples_per_block - 1) / samples_per_block;
  rollout_kernel<T, G><<<blocks, samples_per_block * G, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const hmr::Tables<T>*>(tab), static_cast<const T*>(qpos0),
      static_cast<const T*>(qvel0), static_cast<const T*>(time0), static_cast<const T*>(U),
      static_cast<const T*>(noise), static_cast<const T*>(params),
      static_cast<T*>(cost), static_cast<T*>(qpos_out), static_cast<T*>(qvel_out),
      K, horizon);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G = kLanes>
int occupancy(int samples_per_block, int smem_bytes) {
  const cudaError_t e = allow_shared<T, G>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (samples_per_block < 1 || samples_per_block * G > Bounds<T>::threads) return 0;
  int blocks = 0;
  const cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rollout_kernel<T, G>, samples_per_block * G, smem_bytes);
  return o == cudaSuccess ? blocks : -static_cast<int>(o);
}

}  // namespace

extern "C" {

int hmr_tables_size(int is_double) {
  return is_double ? int(sizeof(hmr::Tables<double>)) : int(sizeof(hmr::Tables<float>));
}

// lanes per sample, and the most samples a block may hold
int hmr_rollout_lanes() { return kLanes; }
int hmr_rollout_max_samples_per_block(int is_double) {
  return (is_double ? Bounds<double>::threads : Bounds<float>::threads) / kLanes;
}

// Blocks of `samples_per_block` samples and `smem_bytes` of dynamic shared
// memory that one SM holds at once (< 0: -cudaError).
int hmr_rollout_occupancy(int is_double, int samples_per_block, int smem_bytes) {
  return is_double ? occupancy<double>(samples_per_block, smem_bytes)
                   : occupancy<float>(samples_per_block, smem_bytes);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). A
// block holds samples_per_block samples; smem_bytes is its dynamic shared
// memory: the tables, NPARAM + 2 nu S scalars, and S workspaces.
int hmr_rollout_f32(const void* tab, const void* qpos0, const void* qvel0,
                    const void* time0, const void* U, const void* noise,
                    const void* params, void* cost, void* qpos_out, void* qvel_out,
                    int K, int horizon, void* stream, int samples_per_block,
                    int smem_bytes) {
  return launch<float>(tab, qpos0, qvel0, time0, U, noise, params, cost, qpos_out,
                       qvel_out, K, horizon, stream, samples_per_block, smem_bytes);
}

int hmr_rollout_f64(const void* tab, const void* qpos0, const void* qvel0,
                    const void* time0, const void* U, const void* noise,
                    const void* params, void* cost, void* qpos_out, void* qvel_out,
                    int K, int horizon, void* stream, int samples_per_block,
                    int smem_bytes) {
  return launch<double>(tab, qpos0, qvel0, time0, U, noise, params, cost, qpos_out,
                        qvel_out, K, horizon, stream, samples_per_block, smem_bytes);
}

}  // extern "C"
