"""Shared pieces of the cartpole and hopper port tests
(tests/test_torch_port_cartpole.py, tests/test_torch_port_hopper.py): the
JAX models, the host build of the rollout kernel's body, and the JAX
references of a kernel replan and of a control loop at matched noise.

The JAX replan reference is the rollout kernel's body as a plain loop of
ops/scalar_physics plus the kernel cost (ops/rollout_kernel.py:86-126:
clip(U + noise), time = t0 + t h, the running cost at time + h, the
terminal at t0 + T h) followed by solver/kernel_mppi.py's weighting,
accumulate update and shift (no control clamps: neither robot's task has
one)."""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = Path(rk.__file__).resolve().parent / "csrc"


def xml(robot: str) -> str:
    return os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", f"{robot}.xml")


def jax_models(robot: str):
    """(planner model, plant model) of the JAX package."""
    return build_from_mjcf(xml(robot)), build_from_mjcf(xml(robot), include_self_collisions=True)


def j(a):
    return [jnp.asarray(a[i]) for i in range(a.shape[0])]


def t(a):
    return [torch.tensor(a[i]) for i in range(a.shape[0])]


def stack(xs, B):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs])


def host_library(tmp_dir: Path) -> ctypes.CDLL:
    """csrc/host_rollout.cpp built with g++ (the rollout body at one lane)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_dir / "libhost_rollout.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(CSRC / "host_rollout.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.hmr_rollout_host_f64.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    lib.hmr_rollout_host_f64.restype = None
    lib.hmr_tables_size.argtypes = [ctypes.c_int]
    lib.hmr_tables_size.restype = ctypes.c_int
    return lib


def host_rollout(lib, model, cost_factory, kw, x, params, T):
    """The host-built body on inputs x (qpos0, qvel0, time0, U, noise
    tensors, f64): (costs, qpos_T, qvel_T) numpy arrays."""
    tables = rk.pack_tables(model, cost_factory, kw, None, None, True, torch.float64)
    assert lib.hmr_tables_size(1) == len(tables)
    buf = ctypes.create_string_buffer(tables, len(tables))
    ins = [np.ascontiguousarray(a.numpy()) for a in (*x, params)]
    K = x[0].shape[1]
    outs = [np.zeros(K), np.zeros((model.nq, K)), np.zeros((model.nv, K))]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hmr_rollout_host_f64(ctypes.cast(buf, ctypes.c_void_p), *[ptr(a) for a in ins + outs],
                             K, T)
    return outs


def jax_plan(jm, cost, kw, cfg, qpos, qvel, t0, U, noise, params):
    """The JAX replan reference (module docstring): (action, U')."""
    running, terminal = getattr(jkc, cost)(jm, **kw)
    T, nu, K = noise.shape
    h = jm.timestep
    qp = [jnp.full(K, qpos[i]) for i in range(jm.nq)]
    qv = [jnp.full(K, qvel[i]) for i in range(jm.nv)]
    t0 = jnp.full(K, t0)
    prm = [jnp.asarray(x) for x in params]
    fwd = jsph.scalar_forward(jm, qp, qv)
    cost_acc = jnp.zeros(K)
    for s in range(T):
        u = [U[s, i] + jnp.asarray(noise[s, i]) for i in range(nu)]
        time = t0 + s * h
        qp, qv, _ = jsph.scalar_step(jm, qp, qv, u, time, fwd=fwd)
        fwd = jsph.scalar_forward(jm, qp, qv)
        ctx = jsph.ctx_from(jm, fwd, qp, qv, u, time + h)
        ctx.params = prm
        cost_acc = cost_acc + running(ctx, s)
    ctx = jsph.ctx_from(jm, fwd, qp, qv, [0.0] * nu, t0 + T * h)
    ctx.params = prm
    costs = cost_acc + terminal(ctx)
    w = jnp.exp(-(costs - jnp.min(costs)) / cfg.temperature)
    w = w / (jnp.sum(w) + cfg.weight_eps)
    U_new = U + jnp.einsum("tuk,k->tu", jnp.asarray(noise), w)
    return U_new[0], jnp.concatenate([U_new[1:], cfg.tail_decay * U_new[-1:]], axis=0)


def jax_episode(jm, jpm, cost, kw, cfg, qpos0, noises, params):
    """The EpisodeRunner loop in JAX: log [qpos; qvel] and the time, replan
    (jax_plan), step the coupled plant. Returns rows, actions, times."""
    step = jax.jit(lambda s, u: jeng.step(jpm, s, u))
    plant = jeng.forward(jpm, jnp.asarray(qpos0, jnp.float64), jnp.zeros(jm.nv))
    U = jnp.zeros((cfg.T, jm.nu))
    rows, actions, times = [], [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
        times.append(float(plant.time))
        action, U = jax_plan(jm, cost, kw, cfg, np.asarray(plant.qpos), np.asarray(plant.qvel),
                             float(plant.time), U, noise, params)
        actions.append(np.asarray(action))
        plant = step(plant, action)
    return np.stack(rows), np.stack(actions), np.array(times)
