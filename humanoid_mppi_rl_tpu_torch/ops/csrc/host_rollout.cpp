// Host build of the rollout kernel's per-sample body, for the CPU tests
// only: g++ -O2 -std=c++17 -shared -fPIC host_rollout.cpp. Runs the body
// with one lane (G = 1, the group sync a no-op) for every sample in turn,
// in double precision.
#include <vector>

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
  const hmr::Lanes<1> g{0};
  std::vector<double> ws(m.ws_size);
  for (int k = 0; k < K; ++k) {
    double* w = ws.data();
    for (int i = 0; i < m.nq; ++i) w[m.off[hmr::WS_QPOS] + i] = qpos0[(size_t)i * K + k];
    for (int i = 0; i < m.nv; ++i) w[m.off[hmr::WS_QVEL] + i] = qvel0[(size_t)i * K + k];
    hmr::begin(g, m, w);
    double c = 0;
    for (int t = 0; t < horizon; ++t)
      hmr::advance(g, m, w, U + (size_t)t * m.nu, noise + (size_t)t * m.nu * K + k, K,
                   params, c);
    hmr::terminal(g, m, w, params, c);
    cost[k] = c;
    for (int i = 0; i < m.nq; ++i) qpos_out[(size_t)i * K + k] = w[m.off[hmr::WS_QPOS] + i];
    for (int i = 0; i < m.nv; ++i) qvel_out[(size_t)i * K + k] = w[m.off[hmr::WS_QVEL] + i];
  }
}

}  // extern "C"
