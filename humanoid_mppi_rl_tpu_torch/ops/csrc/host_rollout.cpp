// Host build of the rollout kernel's per-sample body, for the CPU tests
// only: g++ -O2 -std=c++17 -shared -fPIC host_rollout.cpp. Runs
// rollout_sample for every sample in turn, in double precision.
#include <memory>

#include "rollout_body.cuh"

extern "C" {

int hmr_tables_size(int is_double) {
  return is_double ? int(sizeof(hmr::Tables<double>)) : int(sizeof(hmr::Tables<float>));
}

void hmr_rollout_host_f64(const void* tab, const double* qpos0, const double* qvel0,
                          const double* U, const double* noise, const double* params,
                          double* cost, double* qpos_out, double* qvel_out, int K,
                          int horizon) {
  const auto& m = *static_cast<const hmr::Tables<double>*>(tab);
  auto kin = std::make_unique<hmr::Kin<double>>();
  auto work = std::make_unique<hmr::Work<double>>();
  for (int k = 0; k < K; ++k)
    hmr::rollout_sample(m, k, K, horizon, qpos0, qvel0, U, noise, params, cost,
                        qpos_out, qvel_out, *kin, *work);
}

}  // extern "C"
