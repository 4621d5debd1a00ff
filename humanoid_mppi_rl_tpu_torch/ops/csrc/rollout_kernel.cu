// MPPI rollout kernel for Hopper (sm_90a), one thread per sample.
//
// Replaces the TPU kernel ops/rollout_kernel.py::build_rollout_kernel of the
// JAX package (the Pallas `kernel` launched by pl.pallas_call): every sample
// runs all T horizon steps -- ctrl = clip(U[t] + noise[t]), the penalty-tier
// physics step, FK, the running cost -- and then the terminal cost, with the
// state kept on chip. Device memory sees only the initial state, the noise
// stream, U, the 16 runtime parameters, and the outputs.
//
// What bounds it: the work, not the bytes. The humanoid step is ~23k scalar
// equations, so a replan at K=8192, T=64 is ~1.2e10 scalar operations,
// against 44 MB of noise read (f32). One thread per sample puts only 8192
// threads on the card -- about 2 warps per SM on 132 SMs -- so there is
// little latency hiding, and each thread's working arrays (kinematics,
// composite inertias, the packed mass matrix: ~15 KB in f32) live in local
// memory. The model tables are copied into shared memory once per block and
// read as broadcasts.
//
// What a later version should change: let a warp cooperate on one sample
// (bodies and dofs across lanes, the level-synchronous tree sweeps of
// physics/engine.py), which multiplies the threads in flight by 32 and
// moves the working arrays into registers and shared memory.
#include <cuda_runtime.h>

#include "rollout_body.cuh"

namespace {

constexpr int kThreads = 64;  // 8192 samples -> 128 blocks, one per SM

template <typename T>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const hmr::Tables<T>* __restrict__ tab, const T* __restrict__ qpos0,
               const T* __restrict__ qvel0, const T* __restrict__ U,
               const T* __restrict__ noise, const T* __restrict__ params,
               T* __restrict__ cost, T* __restrict__ qpos_out,
               T* __restrict__ qvel_out, int K, int horizon) {
  __shared__ hmr::Tables<T> m;
  const int* src = reinterpret_cast<const int*>(tab);
  int* dst = reinterpret_cast<int*>(&m);
  for (int i = threadIdx.x; i < int(sizeof(hmr::Tables<T>) / 4); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  hmr::Kin<T> kin;
  hmr::Work<T> work;
  hmr::rollout_sample(m, k, K, horizon, qpos0, qvel0, U, noise, params, cost,
                      qpos_out, qvel_out, kin, work);
}

template <typename T>
int launch(const void* tab, const void* qpos0, const void* qvel0, const void* U,
           const void* noise, const void* params, void* cost, void* qpos_out,
           void* qvel_out, int K, int horizon, void* stream) {
  const int blocks = (K + kThreads - 1) / kThreads;
  rollout_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const hmr::Tables<T>*>(tab), static_cast<const T*>(qpos0),
      static_cast<const T*>(qvel0), static_cast<const T*>(U),
      static_cast<const T*>(noise), static_cast<const T*>(params),
      static_cast<T*>(cost), static_cast<T*>(qpos_out), static_cast<T*>(qvel_out),
      K, horizon);
  return static_cast<int>(cudaGetLastError());
}

static_assert(sizeof(hmr::Tables<double>) <= 48 * 1024, "tables exceed static smem");

}  // namespace

extern "C" {

int hmr_tables_size(int is_double) {
  return is_double ? int(sizeof(hmr::Tables<double>)) : int(sizeof(hmr::Tables<float>));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int hmr_rollout_f32(const void* tab, const void* qpos0, const void* qvel0,
                    const void* U, const void* noise, const void* params,
                    void* cost, void* qpos_out, void* qvel_out, int K,
                    int horizon, void* stream) {
  return launch<float>(tab, qpos0, qvel0, U, noise, params, cost, qpos_out,
                       qvel_out, K, horizon, stream);
}

int hmr_rollout_f64(const void* tab, const void* qpos0, const void* qvel0,
                    const void* U, const void* noise, const void* params,
                    void* cost, void* qpos_out, void* qvel_out, int K,
                    int horizon, void* stream) {
  return launch<double>(tab, qpos0, qvel0, U, noise, params, cost, qpos_out,
                        qvel_out, K, horizon, stream);
}

}  // extern "C"
