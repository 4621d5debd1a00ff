"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (with its own `seconds`):
  device  -- requires CUDA; prints the card's name and power limit
  build   -- nvcc-builds every kernel of the port from csrc/, prints the
             ptxas register/stack/spill lines
  check   -- each kernel against its plain PyTorch version on the card
             (humanoid_bench model and cost, K=256, T=4, seeded inputs):
             f64 to rtol 1e-9; f32 median relative cost error < 1e-3, max < 1e-2
  main    -- the port's main path at full width: load_task("humanoid_bench")
             (K=8192, H=64, f32) + make_kernel_mppi, 2 warm-up and 20 timed
             chained replans; finite outputs, one kernel launch per replan
  time    -- each kernel alone at the main path's shapes beside its plain
             version (outputs compared too: f32 cost rel median < 1e-3)
             and its bound
then a `kernels` line, the nvidia-smi line, and the final status line.
Any failed check raises, and the script exits non-zero without the status
line. It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): device memory rate and f32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
CHECK_K, CHECK_T = 256, 4
WARMUP, TIMED = 2, 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean device time of fn() over n back-to-back calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def seeded_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Perturbed standing states sunk 0.25 m so the feet are in contact,
    random velocities, plan and noise: numpy, from a seed."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.qpos0[:, None], (1, K)) + rng.normal(0, 0.05, (model.nq, K))
    qpos[2] -= 0.25
    qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
    qvel = rng.normal(0, 0.3, (model.nv, K))
    U = rng.normal(0, 0.3, (T, model.nu))
    noise = rng.normal(0, 0.5, (T, model.nu, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return (as_t(qpos), as_t(qvel), torch.zeros(1, K, dtype=dtype, device=device),
            as_t(U), as_t(noise))


def ops_per_rollout(spec, model, T) -> int:
    """Scalar operations one sample's rollout needs: the plain version's
    arithmetic ops (0/1 constants already folded away), counted on the CPU
    at T=1 and T=2 and extended linearly to T."""
    from torch.utils._python_dispatch import TorchDispatchMode

    not_arith = {"select", "view", "expand", "stack", "clone", "copy_", "_to_copy",
                 "zeros_like", "zeros", "empty", "slice", "unsqueeze", "alias",
                 "detach", "lift_fresh", "cat", "squeeze", "unbind", "full",
                 "scalar_tensor", "fill_", "constant_pad_nd"}
    k = 3

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (isinstance(out, torch.Tensor) and out.numel() == k
                    and func.overloadpacket.__name__ not in not_arith):
                Count.n += 1
            return out

    def count(t):
        from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import build_rollout_kernel
        ro = build_rollout_kernel(model, spec.cost_factory, t,
                                  cost_kwargs=spec.cost_kwargs, device="cpu")
        x = seeded_inputs(model, k, t, torch.float64, device="cpu")
        Count.n = 0
        with Count():
            ro(*x)
        return Count.n

    n1, n2 = count(1), count(2)
    return n1 + (T - 1) * (n2 - n1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import _build
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

    # float32 products on the card in full precision (the PyTorch default,
    # stated: the weighting's noise @ w is a product)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    built = _build.build("rollout_kernel.cu")
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if any(s in ln for s in ("rollout_kernel", "stack frame", "registers"))]
    emit({"phase": "build", "source": "rollout_kernel.cu", "cached": built["cached"],
          "nvcc_seconds": built["seconds"], "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})

    # ---- check: kernel against its plain version on the card -------------
    t0 = time.perf_counter()
    spec, model, cfg, _ = load_task("humanoid_bench", dtype=torch.float64)
    ro = rk.build_rollout_kernel(model, spec.cost_factory, CHECK_T,
                                 cost_kwargs=spec.cost_kwargs)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        x = seeded_inputs(model, CHECK_K, CHECK_T, dtype, seed=1)
        n0 = rk.launches
        ck, qk, vk = ro(*x)
        torch.cuda.synchronize()
        if rk.launches != n0 + 1:
            raise AssertionError("rollout kernel launch was not counted")
        cp, qp, vp = ro.plain(*x)
        rel = ((ck - cp).abs() / cp.abs()).double()
        e = {"cost_max_abs": float((ck - cp).abs().max()),
             "cost_rel_max": float(rel.max()), "cost_rel_median": float(rel.median()),
             "qpos_max_abs": float((qk - qp).abs().max()),
             "qvel_max_abs": float((vk - vp).abs().max())}
        for name, a in (("costs", ck), ("qpos_T", qk), ("qvel_T", vk)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{dtype}: non-finite kernel {name}")
        if dtype == torch.float64:
            for a, b, name in ((ck, cp, "costs"), (qk, qp, "qpos_T"), (vk, vp, "qvel_T")):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9, msg=name)
        elif not (e["cost_rel_median"] < 1e-3 and e["cost_rel_max"] < 1e-2):
            raise AssertionError(f"f32 kernel vs plain: {e}")
        errs[str(dtype).replace("torch.", "")] = e
    emit({"phase": "check", "kernel": "rollout", "K": CHECK_K, "T": CHECK_T,
          "tolerance": {"float64": "rtol=atol=1e-9",
                        "float32": "cost rel median<1e-3, max<1e-2"},
          "errors": errs, "seconds": time.perf_counter() - t0})

    # ---- main path at full width -------------------------------------------
    t0 = time.perf_counter()
    spec, model, cfg, init = load_task("humanoid_bench")
    plan = make_kernel_mppi(model, spec.cost_factory, cfg, spec.cost_kwargs)
    ms = MPPIState.seeded(0, cfg.T, model.nu)
    rk.launches = 0
    times = []
    for i in range(WARMUP + TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        action, ms, diag = plan(ms, init)
        b.record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(a.elapsed_time(b))
    main_launches = rk.launches
    if main_launches != WARMUP + TIMED:
        raise AssertionError(f"{main_launches} kernel launches for {WARMUP + TIMED} replans")
    outs = {"action": action, "U": ms.U, **dataclasses.asdict(diag)}
    for name, v in outs.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    if tuple(action.shape) != (model.nu,) or tuple(ms.U.shape) != (cfg.T, model.nu):
        raise AssertionError("unexpected output shapes")
    q1, q3 = np.percentile(times, [25, 75])
    med = statistics.median(times)
    emit({"phase": "main", "task": "humanoid_bench", "K": cfg.K, "H": cfg.T,
          "dtype": "float32", "replans": TIMED, "launches": main_launches,
          "replan_ms_median": med, "replan_ms_q1": float(q1), "replan_ms_q3": float(q3),
          "replan_ms_min": min(times), "replan_ms_max": max(times),
          "rollouts_per_s": cfg.K / (med / 1e3),
          "beta": float(diag.beta), "ess": float(diag.ess),
          "seconds": time.perf_counter() - t0})

    # ---- each kernel alone at the main path's shapes -----------------------
    t0 = time.perf_counter()
    x = seeded_inputs(model, cfg.K, cfg.T, torch.float32, seed=2)
    ro = plan.rollouts
    kernel_ms = cuda_ms(lambda: ro(*x), 5)
    out = {}
    plain_ms = cuda_ms(lambda: out.setdefault("plain", ro.plain(*x)), 1)
    # the same full-shape inputs through both: 64 f32 steps let rounding
    # reach contact switching in a few samples, so only the median is held
    ck, cp = ro(*x)[0].double(), out["plain"][0].double()
    rel = (ck - cp).abs() / cp.abs()
    full = {"cost_rel_median": float(rel.median()), "cost_rel_max": float(rel.max()),
            "cost_max_abs": float((ck - cp).abs().max())}
    if not (torch.isfinite(ck).all() and full["cost_rel_median"] < 1e-3):
        raise AssertionError(f"full-shape f32 kernel vs plain: {full}")
    n_ops = cfg.K * ops_per_rollout(spec, model, cfg.T)
    n_bytes = 4 * (cfg.K * (2 * model.nq + 2 * model.nv + 1)
                   + cfg.T * model.nu * (cfg.K + 1) + rk.NP)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_OPS_PER_S * 1e3
    emit({"phase": "time", "kernel": "rollout", "K": cfg.K, "T": cfg.T,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "ops": n_ops, "bytes": n_bytes,
          "kernel_vs_plain": full, "tolerance": "cost rel median<1e-3",
          "seconds": time.perf_counter() - t0})

    emit({"kernels": [{
        "name": "rollout",
        "route": "cuda",
        "source": "humanoid_mppi_rl_tpu_torch/ops/csrc/rollout_kernel.cu",
        "replaces": "humanoid_mppi_rl_tpu/ops/rollout_kernel.py:86",
        "launches": main_launches,
        "max_abs_err": errs["float32"]["cost_max_abs"],
        "max_abs_err_f64": errs["float64"]["cost_max_abs"],
        "cost_rel_median_f32": errs["float32"]["cost_rel_median"],
        "full_shape_cost_rel_median_f32": full["cost_rel_median"],
        "full_shape_cost_rel_max_f32": full["cost_rel_max"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
