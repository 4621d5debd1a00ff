"""PyTorch port: the humanoid's remaining costs and the Go1's array costs
against the JAX package on the CPU.

- The rollout kernel's `humanoid_v1` and `humanoid_hard` (ops/kernel_costs,
  csrc/rollout_body.cuh): the plain rollout (rollouts_plain) and the CUDA
  body built for the host, against a JAX reference loop (JAX scalar_step +
  the JAX kernel cost, the body of ops/rollout_kernel.py:86-126) in f64 at
  1e-10. humanoid_v1 runs with step_period 2 over T=6, so that both swing
  sides occur in the running cost and the terminal reads the injected
  horizon on the right side; humanoid_hard on chip_smoke.humanoid_hard_inputs,
  which take every branch of the cost both ways.
- The kernel costs against their array oracles in f32 at rtol 2e-4
  (tests/test_kernel.py:205-245).
- The array costs (costs/humanoid make_costs_v1, make_costs_hard_penalty,
  make_costs_v2py; costs/quadruped make_costs, make_costs_mppi_jl) on
  batched states against the JAX costs per sample, f64 at 1e-10; the gait
  wrapper's hysteresis and advance_goal_v2py against JAX's."""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hard_cost_branches, humanoid_hard_inputs, seeded_inputs
from humanoid_mppi_rl_tpu.costs import humanoid as jhum
from humanoid_mppi_rl_tpu.costs import quadruped as jquad
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.costs import humanoid as phum
from humanoid_mppi_rl_tpu_torch.costs import quadruped as pquad
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as pkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as psph
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import load_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = Path(rk.__file__).resolve().parent / "csrc"
F64 = torch.float64
K = 16

# (kernel cost, kwargs, inputs, T)
_ROLLOUTS = {
    "v1_period2": ("humanoid_v1", dict(step_period=2), seeded_inputs, 6),
    "v1_period100": ("humanoid_v1", dict(), seeded_inputs, 3),
    "hard": ("humanoid_hard", dict(target=(2.5, 0.3, 1.2), target_vel=(0.4, 0.1)),
             humanoid_hard_inputs, 3),
}


def _xml(robot):
    return os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", f"{robot}.xml")


@pytest.fixture(scope="module")
def jm():
    return build_from_mjcf(_xml("humanoid"))


@pytest.fixture(scope="module")
def pm():
    return load_model("humanoid")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/host_rollout.cpp built with g++ (the rollout body at one lane)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("host_rollout") / "libhost_rollout.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(CSRC / "host_rollout.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.hmr_rollout_host_f64.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    lib.hmr_rollout_host_f64.restype = None
    lib.hmr_tables_size.argtypes = [ctypes.c_int]
    lib.hmr_tables_size.restype = ctypes.c_int
    return lib


def _jax_rollout(jm, cost, kw, x):
    """The rollout kernel's body as a plain JAX loop: (costs, qpos_T, qvel_T)."""
    qpos, qvel, t0, U, noise = [a.numpy() for a in x]
    T, nu, Kn = noise.shape
    running, terminal = getattr(jkc, cost)(jm, **dict(kw, **(
        {"horizon": T} if cost == "humanoid_v1" else {})))
    h = jm.timestep
    qp = [jnp.asarray(qpos[i]) for i in range(jm.nq)]
    qv = [jnp.asarray(qvel[i]) for i in range(jm.nv)]
    t0 = jnp.asarray(t0[0])
    fwd = jsph.scalar_forward(jm, qp, qv)
    acc = jnp.zeros(Kn)
    for s in range(T):
        u = [jnp.asarray(U[s, i] + noise[s, i]) for i in range(nu)]
        time = t0 + s * h
        qp, qv, _ = jsph.scalar_step(jm, qp, qv, u, time, fwd=fwd)
        fwd = jsph.scalar_forward(jm, qp, qv)
        ctx = jsph.ctx_from(jm, fwd, qp, qv, u, time + h)
        ctx.params = [jnp.zeros(Kn)] * 16
        acc = acc + running(ctx, s)
    ctx = jsph.ctx_from(jm, fwd, qp, qv, [0.0] * nu, t0 + T * h)
    ctx.params = [jnp.zeros(Kn)] * 16
    acc = acc + terminal(ctx)
    return np.asarray(acc), np.stack([np.asarray(a) for a in qp]), \
        np.stack([np.asarray(a) for a in qv])


def _host_rollout(lib, model, factory, kw, x):
    T = x[3].shape[0]
    kw = dict(kw, horizon=T) if factory is pkc.humanoid_v1 else kw
    tables = rk.pack_tables(model, factory, kw, None, None, True, F64)
    assert lib.hmr_tables_size(1) == len(tables)
    buf = ctypes.create_string_buffer(tables, len(tables))
    ins = [np.ascontiguousarray(a.numpy()) for a in (*x, torch.zeros(16, dtype=F64))]
    Kn = x[0].shape[1]
    outs = [np.zeros(Kn), np.zeros((model.nq, Kn)), np.zeros((model.nv, Kn))]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hmr_rollout_host_f64(ctypes.cast(buf, ctypes.c_void_p), *[ptr(a) for a in ins + outs],
                             Kn, T)
    return outs


@pytest.mark.parametrize("case", list(_ROLLOUTS))
def test_kernel_cost_rollouts_match_jax(jm, pm, host_lib, case):
    cost, kw, inputs, T = _ROLLOUTS[case]
    x = inputs(pm, K, T, F64, seed=5, device="cpu")
    want = _jax_rollout(jm, cost, kw, x)
    factory = pkc.KERNEL_COSTS[cost]
    ro = rk.build_rollout_kernel(pm, factory, T, cost_kwargs=kw, device="cpu")
    got = ro(*x)
    host = _host_rollout(host_lib, pm, factory, kw, x)
    for name, w, g, hb in zip(("costs", "qpos_T", "qvel_T"), want, got, host):
        atol = 1e-8 if name == "qvel_T" else 1e-10
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=atol, err_msg=f"plain {name}")
        np.testing.assert_allclose(hb, w, rtol=1e-10, atol=atol, err_msg=f"host body {name}")
    if cost == "humanoid_hard":
        # every branch of the hard cost is taken and left at the start
        branches = hard_cost_branches(pm, x[0], x[1])
        assert min(min(v) for v in branches.values()) > 0, branches


def test_humanoid_v1_gait_clock_sides(pm):
    """With step_period 2 the running cost's swing side alternates every
    two steps and the terminal reads the horizon: the same state costs
    differently on the two sides, and t = T picks the side of T."""
    x = seeded_inputs(pm, 4, 1, F64, seed=6, device="cpu")
    qp = [x[0][i] for i in range(pm.nq)]
    qv = [x[1][i] for i in range(pm.nv)]
    fwd = psph.scalar_forward(pm, qp, qv)
    ctx = psph.ctx_from(pm, fwd, qp, qv, [torch.zeros(4, dtype=F64)] * pm.nu,
                        torch.zeros(4, dtype=F64))
    running, terminal = pkc.humanoid_v1(pm, step_period=2, horizon=6)
    left, right = running(ctx, 0), running(ctx, 2)
    assert torch.equal(left, running(ctx, 1)) and torch.equal(right, running(ctx, 3))
    assert not torch.equal(left, right)
    torch.testing.assert_close(terminal(ctx), 10.0 * right, rtol=1e-15, atol=0)


def _ctx(model, qpos, qvel, ctrl, dtype, jax_side):
    if jax_side:
        cast = lambda a: [jnp.asarray(a[:, i], jnp.float32) for i in range(a.shape[1])]
        qp, qv, uu = cast(qpos), cast(qvel), cast(ctrl)
        fwd = jsph.scalar_forward(model, qp, qv)
        return jsph.ctx_from(model, fwd, qp, qv, uu, jnp.full(qpos.shape[0], 0.37, jnp.float32))
    cast = lambda a: [torch.tensor(a[:, i], dtype=dtype) for i in range(a.shape[1])]
    qp, qv, uu = cast(qpos), cast(qvel), cast(ctrl)
    fwd = psph.scalar_forward(model, qp, qv)
    return psph.ctx_from(model, fwd, qp, qv, uu, torch.full((qpos.shape[0],), 0.37, dtype=dtype))


def _poses(model, B, seed):
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.qpos0, (B, 1)) + rng.normal(0, 0.05, (B, model.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return qpos, rng.normal(0, 0.2, (B, model.nv)), rng.uniform(-0.5, 0.5, (B, model.nu))


def _port_states(model, qpos, qvel, dtype):
    eng = Engine(model, "cpu", dtype)
    return eng.forward(torch.tensor(qpos, dtype=dtype), torch.tensor(qvel, dtype=dtype),
                       torch.full((qpos.shape[0],), 0.37, dtype=dtype))


def _jax_states(jm, qpos, qvel, dtype):
    return [jeng.forward(jm, jnp.asarray(qpos[b], dtype), jnp.asarray(qvel[b], dtype),
                         jnp.asarray(0.37, dtype)) for b in range(qpos.shape[0])]


def test_kernel_costs_match_their_array_oracles(jm, pm):
    """f32, rtol 2e-4 (the kernel's polynomial atan2/asin): the port's
    kernel costs against its array costs and JAX's on the same states, v1
    on both gait phases and its terminal at the horizon 150."""
    qpos, qvel, ctrl = _poses(pm, 6, seed=7)
    f32 = torch.float32
    ctx = _ctx(pm, qpos, qvel, ctrl, f32, jax_side=False)
    st = _port_states(pm, qpos, qvel, f32)
    jst = _jax_states(jm, qpos, qvel, jnp.float32)
    u = torch.tensor(ctrl, dtype=f32)
    run_k, term_k = pkc.humanoid_v1(pm, horizon=150)
    run_a, term_a = phum.make_costs_v1(pm)
    run_j, term_j = jhum.make_costs_v1(jm)
    for t in (0, 137):
        want = [float(run_j(s, jnp.asarray(ctrl[b], jnp.float32), t)) for b, s in enumerate(jst)]
        np.testing.assert_allclose(run_k(ctx, t).numpy(), want, rtol=2e-4)
        np.testing.assert_allclose(run_a(st, u, t).numpy(), want, rtol=2e-4)
    want = [float(term_j(s, 150)) for s in jst]
    np.testing.assert_allclose(term_k(_ctx(pm, qpos, qvel, ctrl, f32, False)).numpy(), want,
                               rtol=2e-4)
    np.testing.assert_allclose(term_a(st, 150).numpy(), want, rtol=2e-4)
    run_k, term_k = pkc.humanoid_hard(pm)
    run_a, _ = phum.make_costs_hard_penalty(pm)
    run_j, _ = jhum.make_costs_hard_penalty(jm)
    want = [float(run_j(s, jnp.asarray(ctrl[b], jnp.float32), 0)) for b, s in enumerate(jst)]
    np.testing.assert_allclose(run_k(ctx, 0).numpy(), want, rtol=2e-4)
    np.testing.assert_allclose(run_a(st, u, 0).numpy(), want, rtol=2e-4)


def _v2py_states(jm, pm, B, seed):
    """(port GaitFDState batch, JAX GaitFDStates): FD velocities of a few
    cm/s, both committed sides, goals around the root."""
    rng = np.random.default_rng(seed)
    qpos, qvel, ctrl = _poses(pm, B, seed)
    prev = qpos + 0.005 * rng.normal(size=qpos.shape)
    committed = (np.arange(B) % 2).astype(float)
    last = rng.integers(0, 2, B).astype(float)
    count = rng.integers(0, 4, B).astype(float)
    goal = np.array([2.0, 0.0, 1.28]) + rng.normal(0, 0.3, (B, 3))
    t = lambda a: torch.tensor(a, dtype=F64)
    pst = phum.GaitFDState(phys=_port_states(pm, qpos, qvel, F64), prev_qpos=t(prev),
                           committed_left=t(committed), last_left=t(last), count=t(count),
                           goal=t(goal))
    jsts = [jhum.GaitFDState(phys=s, prev_qpos=jnp.asarray(prev[b]),
                             committed_left=jnp.asarray(committed[b]),
                             last_left=jnp.asarray(last[b]), count=jnp.asarray(count[b]),
                             goal=jnp.asarray(goal[b]))
            for b, s in enumerate(_jax_states(jm, qpos, qvel, jnp.float64))]
    return pst, jsts, ctrl


def test_array_costs_match_jax(jm, pm):
    """make_costs_v1 (both phases, terminal), make_costs_hard_penalty and
    make_costs_v2py (FD velocity at t = 0 and after, terminal) on batched
    f64 states against the JAX costs sample by sample: 1e-10."""
    qpos, qvel, ctrl = _poses(pm, 5, seed=8)
    qpos[1, [12, 13]] = (-1.0, -2.2)      # a lifted leg: the hard cost's knee band
    qpos[2, [10, 16]] = (-0.35, -0.35)    # spread legs: outside the dead zone
    st = _port_states(pm, qpos, qvel, F64)
    jst = _jax_states(jm, qpos, qvel, jnp.float64)
    u = torch.tensor(ctrl)
    cases = [(phum.make_costs_v1(pm, target=(1.5, 0.2), target_vel=0.4, step_period=3),
              jhum.make_costs_v1(jm, target=(1.5, 0.2), target_vel=0.4, step_period=3),
              (0, 4, 8)),
             (phum.make_costs_hard_penalty(pm), jhum.make_costs_hard_penalty(jm), (0,))]
    for (run_p, term_p), (run_j, term_j), ts in cases:
        for t in ts:
            want = [float(run_j(s, jnp.asarray(ctrl[b]), t)) for b, s in enumerate(jst)]
            np.testing.assert_allclose(run_p(st, u, t).numpy(), want, rtol=1e-10, atol=1e-10)
        want = [float(term_j(s, 7)) for s in jst]
        np.testing.assert_allclose(term_p(st, 7).numpy(), want, rtol=1e-10, atol=1e-10)
    pst, jsts, ctrl = _v2py_states(jm, pm, 6, seed=9)
    run_p, term_p = phum.make_costs_v2py(pm, target_vel=(0.35, -0.05))
    run_j, term_j = jhum.make_costs_v2py(jm, target_vel=(0.35, -0.05))
    for t in (0, 3):
        want = [float(run_j(s, jnp.asarray(ctrl[b]), jnp.asarray(t))) for b, s in enumerate(jsts)]
        np.testing.assert_allclose(run_p(pst, torch.tensor(ctrl), t).numpy(), want,
                                   rtol=1e-10, atol=1e-10)
    want = [float(term_j(s, 75)) for s in jsts]
    np.testing.assert_allclose(term_p(pst, 75).numpy(), want, rtol=1e-10, atol=1e-10)


def test_gait_fd_wrapper_hysteresis_matches_jax(jm, pm):
    """The committed side flips only after phase_delay consecutive frames of
    the same instantaneous side (reference src/Humanoid_datacollection_v2.py:
    139-162), frame by frame as JAX's wrapper, one sample and a batch whose
    samples see different foot heights."""
    id_fl, id_fr = pm.body_id("foot_left"), pm.body_id("foot_right")
    sequences = ("RRRLRRLLLR", "LLRRRRLRLL", "RLRLRRRRLL")

    def scripted(seq, port):
        def base(phys, ctrl, t):
            left = [c == "L" for c in (seq[t] if isinstance(seq[t], str) else seq[t])]
            if port:
                xpos = phys.xpos.clone()
                hi = torch.tensor(left, dtype=F64).reshape(xpos.shape[:-2])
                xpos[..., id_fl, 2] = 0.1 + 0.2 * hi
                xpos[..., id_fr, 2] = 0.3 - 0.2 * hi
                return type(phys)(**{**phys.__dict__, "xpos": xpos})
            xpos = phys.xpos.at[id_fl, 2].set(0.3 if left[0] else 0.1)
            return phys.replace(xpos=xpos.at[id_fr, 2].set(0.1 if left[0] else 0.3))
        return base

    jphys = jeng.forward(jm, jnp.asarray(jm.qpos0), jnp.zeros(jm.nv))
    eng = Engine(pm, "cpu", F64)
    pphys = eng.forward(torch.tensor(pm.qpos0), torch.zeros(pm.nv, dtype=F64))
    for seq in sequences:
        jdyn, jst = jhum.make_gait_fd_wrapper(jm, phase_delay=3)(scripted(seq, False), jphys)
        pdyn, pst = phum.make_gait_fd_wrapper(pm, phase_delay=3)(scripted(seq, True), pphys)
        for t in range(len(seq)):
            jst, pst = jdyn(jst, jnp.zeros(jm.nu), t), pdyn(pst, torch.zeros(pm.nu), t)
            for f in ("committed_left", "last_left", "count"):
                assert float(getattr(pst, f)) == float(getattr(jst, f)), (seq, t, f)
    # a batch: sample k follows sequences[k]
    batch_phys = eng.forward(torch.tensor(pm.qpos0).expand(3, -1).contiguous(),
                             torch.zeros(3, pm.nv, dtype=F64), torch.zeros(3, dtype=F64))
    cols = ["".join(s[t] for s in sequences) for t in range(len(sequences[0]))]
    pdyn, pst = phum.make_gait_fd_wrapper(pm, phase_delay=3)(scripted(cols, True), batch_phys)
    from humanoid_mppi_rl_tpu_torch.solver.mppi import broadcast_state
    pst = broadcast_state(pst, 3)
    pst.phys = batch_phys
    singles = []
    for seq in sequences:
        jdyn, jst = jhum.make_gait_fd_wrapper(jm, phase_delay=3)(scripted(seq, False), jphys)
        for t in range(len(seq)):
            jst = jdyn(jst, jnp.zeros(jm.nu), t)
        singles.append(jst)
    for t in range(len(cols)):
        pst = pdyn(pst, torch.zeros(3, pm.nu), t)
    for f in ("committed_left", "last_left", "count"):
        assert getattr(pst, f).tolist() == [float(getattr(s, f)) for s in singles], f


def test_advance_goal_v2py_matches_jax(jm, pm):
    """The goal moves on by (2, 0, 0) only when the full 3D root-to-goal
    distance is under 0.15 m (reference :307-312), one sample and a batch."""
    eng = Engine(pm, "cpu", F64)
    cases = (([2.0, 0.0, 0.98], [2.0, 0.0, 1.28]), ([2.0, 0.05, 1.30], [2.0, 0.0, 1.28]),
             ([0.3, -0.1, 1.2], [0.35, -0.05, 1.25]))
    got = []
    for root, goal in cases:
        qpos = np.array(pm.qpos0)
        qpos[0:3] = root
        jphys = jeng.forward(jm, jnp.asarray(qpos), jnp.zeros(jm.nv))
        z = jnp.asarray(0.0)
        jst = jhum.GaitFDState(phys=jphys, prev_qpos=jnp.asarray(qpos), committed_left=z + 1,
                               last_left=z, count=z, goal=jnp.asarray(goal))
        want = np.asarray(jhum.advance_goal_v2py(jst).goal)
        pphys = eng.forward(torch.tensor(qpos), torch.zeros(pm.nv, dtype=F64))
        one = torch.zeros((), dtype=F64)
        pst = phum.GaitFDState(phys=pphys, prev_qpos=pphys.qpos, committed_left=one + 1,
                               last_left=one, count=one, goal=torch.tensor(goal, dtype=F64))
        out = phum.advance_goal_v2py(pst).goal
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-15)
        got.append(want)
    np.testing.assert_allclose(got[0], [2.0, 0.0, 1.28])
    np.testing.assert_allclose(got[1], [4.0, 0.0, 1.28])
    # the three as one batch
    qpos = np.tile(pm.qpos0, (3, 1))
    qpos[:, 0:3] = [c[0] for c in cases]
    st = phum.GaitFDState(phys=eng.forward(torch.tensor(qpos), torch.zeros(3, pm.nv, dtype=F64)),
                          prev_qpos=torch.tensor(qpos), committed_left=torch.ones(3, dtype=F64),
                          last_left=torch.zeros(3, dtype=F64), count=torch.zeros(3, dtype=F64),
                          goal=torch.tensor([c[1] for c in cases], dtype=F64))
    np.testing.assert_allclose(phum.advance_goal_v2py(st).goal.numpy(), np.stack(got), atol=1e-15)


def test_quadruped_array_costs_match_jax():
    """costs/quadruped make_costs (trot clock at several times, its [sic]
    indices) and make_costs_mppi_jl on batched Go1 states against JAX's."""
    jm = build_from_mjcf(_xml("go1"))
    pm = load_model("go1")
    rng = np.random.default_rng(10)
    B = 5
    home = np.asarray(dict(pm.keyframes)["home"])
    qpos = np.tile(home, (B, 1)) + rng.normal(0, 0.1, (B, pm.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qvel = rng.normal(0, 0.4, (B, pm.nv))
    ctrl = rng.normal(0, 2.0, (B, pm.nu))
    times = np.array([0.0, 0.13, 0.49, 1.77, 23.4])
    eng = Engine(pm, "cpu", F64)
    st = eng.forward(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(times))
    jst = [jeng.forward(jm, jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jnp.asarray(times[b]))
           for b in range(B)]
    for (run_p, term_p), (run_j, term_j) in (
            (pquad.make_costs(pm, goal_xy=(1.5, 0.3)), jquad.make_costs(jm, goal_xy=(1.5, 0.3))),
            (pquad.make_costs_mppi_jl(pm, 0.7), jquad.make_costs_mppi_jl(jm, 0.7))):
        want = [float(run_j(s, jnp.asarray(ctrl[b]), 0)) for b, s in enumerate(jst)]
        np.testing.assert_allclose(run_p(st, torch.tensor(ctrl), 0).numpy(), want,
                                   rtol=1e-10, atol=1e-8)
        assert torch.equal(term_p(st, 30), torch.zeros(B, dtype=F64))
        assert all(float(term_j(s, 30)) == 0.0 for s in jst)
