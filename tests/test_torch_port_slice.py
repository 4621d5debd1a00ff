"""PyTorch port: the kernel planner slice against a JAX reference, and the
CUDA kernel's per-sample body against the plain rollout.

(e) make_kernel_mppi(...).plan(..., noise=...) on the CPU (the plain
rollout) vs a reference built here from the JAX package: a loop over
scalar_step + scalar_forward + the JAX humanoid kernel cost (the body of
ops/rollout_kernel.py:86-126), then the weighting, update and shift lines
of solver/kernel_mppi.py:80-100, with the same noise. Not through Pallas
interpret mode, which takes minutes for the humanoid on the CPU.

(f) csrc/rollout_body.cuh compiled for the host with g++ (through the
test-only entry csrc/host_rollout.cpp, one lane per sample), loaded with
ctypes, vs rollouts_plain in f64; and the lane-parallel schedule that
pack_tables gives the kernel (level lists, Cholesky updates, shared-memory
layout).

(g) `slow`: the JAX package's own Pallas kernel in interpret mode against
rollouts_plain on the humanoid at the smallest size (K=2, T=1).

The CUDA kernel itself is checked on the card by chip_smoke.py and by
tests/test_torch_port_cuda.py."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.physics.state import PhysicsState
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

CSRC = Path(rk.__file__).resolve().parent / "csrc"
K = 16

# (cost kwargs, runtime params or None, update_mode)
_CASES = {
    "bench": (dict(), None, "accumulate"),
    "runtime_params": (dict(param_target=True, param_gait=True), "random", "accumulate"),
    "walk_replace": (None, None, "replace"),
}


def _params(kind, rng):
    if kind is None:
        return None
    p = rng.normal(0, 0.3, 16)
    p[0:3] = (3.0, 0.5, 1.2)     # goal
    p[11], p[12] = -0.3, 0.4     # log sigma / log temperature scales
    return p


def _plant(model, rng, sink=0.2):
    qpos = model.qpos0 + rng.normal(0, 0.05, model.nq)
    qpos[3:7] /= np.linalg.norm(qpos[3:7])
    qpos[2] -= sink
    return qpos, rng.normal(0, 0.3, model.nv)


def _jax_plan(jm, kw, cfg, qpos, qvel, U, noise, params):
    """JAX reference: the rollout kernel's body as a plain loop, then
    solver/kernel_mppi.py:80-100."""
    running, terminal = jkc.humanoid(jm, **kw)
    T, nu = U.shape
    h = jm.timestep
    qp = [jnp.full(K, qpos[i]) for i in range(jm.nq)]
    qv = [jnp.full(K, qvel[i]) for i in range(jm.nv)]
    prm = [jnp.asarray(x) for x in (np.zeros(16) if params is None else params)]
    fwd = jsph.scalar_forward(jm, qp, qv)
    cost = jnp.zeros(K)
    for t in range(T):
        u = [U[t, i] + jnp.asarray(noise[t, i]) for i in range(nu)]
        qp, qv, _ = jsph.scalar_step(jm, qp, qv, u, jnp.zeros(K) + t * h, fwd=fwd)
        fwd = jsph.scalar_forward(jm, qp, qv)
        ctx = jsph.ctx_from(jm, fwd, qp, qv, u, (t + 1) * h)
        ctx.params = prm
        cost = cost + running(ctx, t)
    ctx = jsph.ctx_from(jm, fwd, qp, qv, [0.0] * nu, T * h)
    ctx.params = prm
    costs = cost + terminal(ctx)

    temperature = cfg.temperature * (1.0 if params is None else np.exp(params[12]))
    beta = jnp.min(costs)
    w = jnp.exp(-(costs - beta) / temperature)
    w = w / (jnp.sum(w) + cfg.weight_eps)
    update = jnp.einsum("tuk,k->tu", jnp.asarray(noise), w)
    U_new = update if cfg.update_mode == "replace" else U + update
    action = U_new[0]
    U_shifted = jnp.concatenate([U_new[1:], cfg.tail_decay * U_new[-1:]], axis=0)
    diag = dict(beta=beta, mean_cost=jnp.mean(costs), ess=1.0 / jnp.sum(w * w),
                weight_entropy=-jnp.sum(w * jnp.where(w > 0, jnp.log(w + 1e-30), 0.0)),
                update_norm=jnp.linalg.norm(update))
    return costs, action, U_shifted, diag


@pytest.fixture(scope="module")
def jax_model():
    return build_from_mjcf(str(Path(__file__).parent.parent / "humanoid_mppi_rl_tpu"
                               / "assets" / "humanoid.xml"))


@pytest.mark.parametrize("case", list(_CASES))
def test_kernel_mppi_plan_matches_jax_reference(jax_model, case):
    task = "humanoid_walk" if case == "walk_replace" else "humanoid_bench"
    kw_override, pkind, mode = _CASES[case]
    spec, model, *_, cfg = load_task(task, device="cpu", dtype=torch.float64)
    kw = spec.cost_kwargs if kw_override is None else kw_override
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=3, update_mode=mode)
    rng = np.random.default_rng(11)
    qpos, qvel = _plant(model, rng)
    U = rng.normal(0, 0.2, (cfg.T, model.nu))
    params = _params(pkind, rng)
    sigma = cfg.sigma * (1.0 if params is None else np.exp(params[11]))
    noise = sigma * rng.normal(0, 1, (cfg.T, model.nu, K))

    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, kw, device="cpu")
    st = MPPIState(U=torch.tensor(U), generator=torch.Generator())
    plant = PhysicsState(torch.tensor(qpos), torch.tensor(qvel),
                         torch.zeros((), dtype=torch.float64))
    action, st2, diag = plan(st, plant, params=None if params is None
                             else torch.tensor(params), noise=torch.tensor(noise))
    costs, _, _ = plan.rollouts(
        plant.qpos[:, None].expand(model.nq, K).contiguous(),
        plant.qvel[:, None].expand(model.nv, K).contiguous(),
        torch.zeros(1, K, dtype=torch.float64), torch.tensor(U),
        torch.tensor(noise), params=None if params is None else torch.tensor(params))

    jc, ja, jU, jd = _jax_plan(jax_model, kw, cfg, qpos, qvel, U, noise, params)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=1e-8)
    np.testing.assert_allclose(action.numpy(), np.asarray(ja), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(st2.U.numpy(), np.asarray(jU), rtol=1e-8, atol=1e-12)
    for name, v in jd.items():
        np.testing.assert_allclose(float(getattr(diag, name)), float(v), rtol=1e-8,
                                   err_msg=name)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
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


def _rollout_inputs(model, T, seed, K=K):
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.qpos0[:, None], (1, K)) + rng.normal(0, 0.05, (model.nq, K))
    qpos[2] -= 0.25
    qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
    qvel = rng.normal(0, 0.3, (model.nv, K))
    U = rng.normal(0, 0.3, (T, model.nu))
    noise = rng.normal(0, 0.5, (T, model.nu, K))
    return qpos, qvel, U, noise, rng


# (case, K): the three cost cases at K=16, and the bench case at a K that
# no block of samples divides
_HOST_CASES = [(case, K) for case in _CASES] + [("bench", 7)]


@pytest.mark.parametrize("case, K", _HOST_CASES,
                         ids=[c if k == K else f"{c}-K{k}" for c, k in _HOST_CASES])
def test_kernel_body_on_host_matches_plain_rollout(host_lib, case, K):
    spec, model, *_, cfg = load_task("humanoid_walk" if case == "walk_replace"
                                    else "humanoid_bench", device="cpu",
                                    dtype=torch.float64)
    kw_override, pkind, _ = _CASES[case]
    kw = spec.cost_kwargs if kw_override is None else kw_override
    T = 3
    qpos, qvel, U, noise, rng = _rollout_inputs(model, T, seed=4, K=K)
    params = _params(pkind, rng)
    p = np.zeros(16) if params is None else params
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, cost_kwargs=kw, device="cpu")
    tt = lambda a: torch.tensor(np.ascontiguousarray(a))
    cost, qpos_T, qvel_T = ro(tt(qpos), tt(qvel), torch.zeros(1, K, dtype=torch.float64),
                              tt(U), tt(noise), params=tt(p))

    tables = rk.pack_tables(model, spec.kernel_cost_factory, kw, None, None, True, torch.float64)
    assert host_lib.hmr_tables_size(1) == len(tables)
    buf = ctypes.create_string_buffer(tables, len(tables))
    ins = [np.ascontiguousarray(a, dtype=np.float64) for a in (qpos, qvel, np.zeros((1, K)), U,
                                                              noise, p)]
    outs = [np.zeros(K), np.zeros((model.nq, K)), np.zeros((model.nv, K))]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    host_lib.hmr_rollout_host_f64(ctypes.cast(buf, ctypes.c_void_p),
                                  *[ptr(a) for a in ins + outs], K, T)
    np.testing.assert_allclose(outs[0], cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(outs[1], qpos_T.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(outs[2], qvel_T.numpy(), rtol=1e-9, atol=1e-9)


def _schedule(tables) -> dict:
    """The schedule in packed tables (a Tables struct) as lists: body levels,
    dof levels, mass-matrix entries, each dof level's Cholesky updates."""
    lv = list(tables.lvl_adr[:tables.nlvl + 1])
    dl = list(tables.dlvl_adr[:tables.ndlvl + 1])
    ca = list(tables.chol_adr[:tables.ndlvl + 1])
    pair = lambda e: (e & 0xff, e >> 8)
    return {"body_levels": [list(tables.lvl_body[a:b]) for a, b in zip(lv, lv[1:])],
            "dof_levels": [list(tables.dlvl_dof[a:b]) for a, b in zip(dl, dl[1:])],
            "entries": [pair(e) for e in tables.ent[:tables.nent]],
            "cholesky_updates": [[pair(e) for e in tables.chol_ent[a:b]]
                                 for a, b in zip(ca, ca[1:])]}


def _humanoid_tables(dtype=torch.float64):
    spec, model, *_ = load_task("humanoid_bench", device="cpu", dtype=torch.float64)
    raw = rk.pack_tables(model, spec.kernel_cost_factory, spec.cost_kwargs, None, None, True, dtype)
    return model, raw, rk.tables_struct(dtype).from_buffer_copy(raw)


def test_schedule_levels_cover_the_tree_in_order():
    """Every body (world excluded) and every dof stands in exactly one level;
    a body's parent (when not the world) and every dof on a dof's chain
    stand in lower levels."""
    model, _, t = _humanoid_tables()
    sched = _schedule(t)
    level_of = {b: lv for lv, bodies in enumerate(sched["body_levels"]) for b in bodies}
    assert sorted(level_of) == list(range(1, model.nbody))
    assert sum(map(len, sched["body_levels"])) == model.nbody - 1
    assert len(sched["body_levels"]) == 6     # torso .. foot
    for b in range(1, model.nbody):
        p = int(model.body_parent[b])
        if p:
            assert level_of[p] < level_of[b]
    dlevel = {d: lv for lv, dofs in enumerate(sched["dof_levels"]) for d in dofs}
    assert sorted(dlevel) == list(range(model.nv))
    assert sum(map(len, sched["dof_levels"])) == model.nv
    for d in range(model.nv):
        chain = np.nonzero(model.ancestor_mask[int(model.dof_bodyid[d])])[0]
        for e in chain[chain < d]:
            assert dlevel[int(e)] < dlevel[d], (e, d)
        assert t.dlvl_mask[dlevel[d]] >> d & 1
    # the floating base's six dofs: the top chain one lane factors in registers
    assert t.ntop == 6 and sched["dof_levels"][:6] == [[d] for d in range(6)]


def test_schedule_cholesky_updates_are_the_chain_entries():
    """Level l's Cholesky updates are exactly the lower-triangle entries
    (i, j) with i and j on the chain above one of the level's dofs, once
    each; the mass-matrix entries are each dof's chain and diagonal."""
    model, _, t = _humanoid_tables()
    sched = _schedule(t)
    anc = [{e for e in range(d) if t.dof_anc[d] >> e & 1} for d in range(model.nv)]
    assert sorted(sched["entries"]) == sorted(
        (d, e) for d in range(model.nv) for e in anc[d] | {d})
    for dofs, updates in zip(sched["dof_levels"], sched["cholesky_updates"]):
        want = {(i, j) for p in dofs for i in anc[p] for j in anc[p] if j <= i}
        assert len(updates) == len(set(updates)) and set(updates) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_workspace_layout_fits_its_byte_count(dtype):
    """Each workspace array lies inside ws_size scalars; arrays that are live
    at the same time do not overlap (forward's scratch and the bias
    accelerations share the mass matrix's space, the contact scratch W's);
    and the block's shared memory is the tables, the parameters, two noise
    steps and S workspaces."""
    model, raw, t = _humanoid_tables(dtype)
    off, size = rk.workspace_layout(model, t.nten)
    assert t.ws_size == size and list(t.off) == [off[f] for f in rk.WS_FIELDS]
    nb, nv, nq, nu, nj = model.nbody, model.nv, model.nq, model.nu, len(model.joints)
    lengths = {"qpos": nq, "qvel": nv, "u": nu, "time": 1, "cost": 1, "xpos": 3 * nb,
               "xquat": 4 * nb,
               "V": 6 * nb, "S": 6 * nv, "W": 6 * nv, "IC": 21 * nb, "F": 6 * nb,
               "ab": 6 * nb, "A": nv * (nv + 1) // 2, "tau": nv, "gdiag": nv, "rhs": nv,
               "dinv": nv, "ten_f": t.nten, "ten_c": t.nten, "qloc": 4 * nj,
               "cscr": 27 * t.nxpair, "loc": 7 * nb, "hinge": 6 * nj,
               "ball": 7 * t.nball, "trn": 7 * t.ntrn}
    assert set(lengths) == set(rk.WS_FIELDS)
    span = {f: (off[f], off[f] + n) for f, n in lengths.items()}
    assert all(0 <= a and b <= size for a, b in span.values())
    host = {"ab": "A", "qloc": "A", "loc": "A", "hinge": "A", "cscr": "W"}
    forward = ("qloc", "loc", "hinge")
    for f in lengths:
        for g in lengths:
            if f >= g:
                continue
            shares = host.get(f) == g or host.get(g) == f or (
                f in host and g in host and host[f] == host[g]
                and not (f in forward and g in forward))
            (a, b), (c, d) = span[f], span[g]
            assert shares or b <= c or d <= a, (f, g)
    es = torch.empty((), dtype=dtype).element_size()
    assert size <= 1600                       # sized to the model: 1,572 scalars
    for S in (1, 7, 32):
        assert rk.shared_bytes(model, dtype, size, S) == (
            len(raw) + es * (rk.NP + 2 * nu * S + S * size))


@pytest.mark.slow
def test_pallas_interpret_kernel_matches_plain_rollout(jax_model):
    """The JAX package's own kernel (build_rollout_kernel in Pallas
    interpret mode) against the port's rollouts_plain on the same numpy
    inputs, f64, at the smallest size: K=2, T=1, block_k=2. XLA compiles
    the whole kernel body into one CPU program here, which takes well over
    12 GB of memory and many minutes: run it only on a machine that has
    them (pytest -m slow)."""
    from humanoid_mppi_rl_tpu.ops.rollout_kernel import build_rollout_kernel as jbuild

    spec, model, *_ = load_task("humanoid_bench", device="cpu", dtype=torch.float64)
    Kp, T = 2, 1
    qpos, qvel, U, noise, _ = _rollout_inputs(model, T, seed=9, K=Kp)
    jro = jbuild(jax_model, jkc.humanoid, T, block_k=Kp, cost_kwargs=spec.cost_kwargs,
                 interpret=True)
    jc, jq, jv = jro(*[jnp.asarray(a) for a in (qpos, qvel, np.zeros((1, Kp)), U, noise)])
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, cost_kwargs=spec.cost_kwargs,
                                 device="cpu")
    tt = lambda a: torch.tensor(np.ascontiguousarray(a))
    c, q, v = ro(tt(qpos), tt(qvel), torch.zeros(1, Kp, dtype=torch.float64), tt(U), tt(noise))
    print("max |diff| cost, qpos, qvel:",
          *[float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in ((c, jc), (q, jq), (v, jv))])
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-9)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-9, atol=1e-9)
