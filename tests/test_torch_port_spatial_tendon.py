"""PyTorch port, slice 15: spatial (site-chain) tendons in every array
tier, against the JAX package on the CPU in f64.

Model: tests/test_engine_generality.py's SPATIAL_TENDON_XML, a two-link
arm with a three-site tendon limited to 0.62 m (0.66 m at rest, so the
limit is active from the start) and driven by a motor with gear 2,
committed as assets/spatial_tendon_plant.json. Inputs come from numpy
seeds. Tolerances: the tendon's length and moment rows, the actuator
forces and moments 1e-12; steps qpos 1e-10, qvel 5e-8 (as
tests/test_torch_port_transmissions.py); inverse dynamics 1e-9; A and B of
`linearize` against JAX's jitted linearize 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SPATIAL_START, spatial_inputs
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import rollout_kernel as jrk
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics import newton as jnewton
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver import lqr as jlqr
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics import newton as pnewton
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from humanoid_mppi_rl_tpu_torch.solver import lqr as tlqr
from test_engine_generality import SPATIAL_TENDON_XML

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

F64 = torch.float64
NAME = "spatial_tendon_plant"
NS = 8
START = tuple(np.array(a) for a in SPATIAL_START)   # the JAX test's start


@pytest.fixture(scope="module")
def models():
    """(JAX model, port engine on the committed snapshot)."""
    jm = build_from_mjcf(xml=SPATIAL_TENDON_XML, include_self_collisions=True)
    return jm, peng.Engine(load_model(NAME), "cpu", F64)


@pytest.fixture(scope="module")
def jax_fns(models):
    """JAX's forward and steps under jax.jit, one compile each."""
    jm, _ = models
    fwd = jax.jit(lambda q, v: jeng.forward(jm, q, v))
    return dict(
        forward=fwd,
        step=jax.jit(lambda s, u: jeng.step(jm, s, u)),
        batch=jax.jit(jax.vmap(fwd)),
        penalty_k=jax.jit(jax.vmap(lambda s, u: jeng.step(jm, s, u, solver="penalty"))),
        coupled_k=jax.jit(jax.vmap(lambda s, u: jeng.step(jm, s, u))),
    )


def _np(x):
    return np.asarray(x)


def test_spatial_snapshot_equals_fresh_mjcf_export(models):
    """assets/spatial_tendon_plant.json equals a fresh export, survives a
    round trip and carries the JAX model's tendon: the sites' bodies and
    local positions, the spatial flag and MuJoCo's invweight0 as meff."""
    jm, eng = models
    fresh = snapshot_json(export_model_arrays(jm, plant=True))
    with open(snapshot_path(NAME)) as f:
        assert f.read() == fresh, (
            f"assets/{NAME}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            "build_from_mjcf(xml=SPATIAL_TENDON_XML, include_self_collisions=True), plant=True))")
    m = eng.model
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    (tid, bodies, lpos), = m.spatial_tendons
    (jtid, jbodies, jlpos), = jm.spatial_tendons
    assert (tid, bodies) == (jtid, tuple(jbodies)) == (0, (0, 1, 2))
    np.testing.assert_array_equal(lpos, jlpos)
    np.testing.assert_array_equal(m.tendon_is_spatial, jm.tendon_is_spatial)
    np.testing.assert_array_equal(m.tendon_limit_meff, jm.tendon_limit_meff)
    assert m.tendon_limit_meff[0] == pytest.approx(1.0 / jm.tendon_invweight0[0])


def test_spatial_tendon_geometry_matches_jax(models, jax_fns):
    """L and the moment row at 8 seeded states, one sample at a time and
    over the K batch (which equals its one-sample rows)."""
    jm, eng = models
    qpos, qvel, _ = spatial_inputs(NS, 0)
    batch = eng.forward(torch.tensor(qpos), torch.tensor(qvel), torch.zeros(NS, dtype=F64))
    Lk, Mk = peng.spatial_tendon_geometry(eng, batch)
    assert Lk.shape == (NS, 1) and Mk.shape == (NS, 1, 2)
    active = 0
    for k in range(NS):
        js = jax_fns["forward"](jnp.asarray(qpos[k]), jnp.asarray(qvel[k]))
        jL, jM = jeng.spatial_tendon_geometry(jm, js)
        L, M = peng.spatial_tendon_geometry(eng, eng.forward(torch.tensor(qpos[k]),
                                                             torch.tensor(qvel[k])))
        np.testing.assert_allclose(L.numpy(), _np(jL), rtol=0, atol=1e-12)
        np.testing.assert_allclose(M.numpy(), _np(jM), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Lk[k].numpy(), L.numpy(), rtol=0, atol=1e-15)
        np.testing.assert_allclose(Mk[k].numpy(), M.numpy(), rtol=0, atol=1e-15)
        active += float(L[0]) > 0.62
    assert 0 < active < NS


def test_spatial_actuator_forces_and_moment_match_jax(models, jax_fns):
    """The motor on the tendon (gear-scaled length, velocity and moment row)
    and actuator_moment(state); without a state the moment refuses as
    JAX's does."""
    jm, eng = models
    qpos, qvel, ctrl = spatial_inputs(NS, 1)
    for k in range(NS):
        js = jax_fns["forward"](jnp.asarray(qpos[k]), jnp.asarray(qvel[k]))
        ps = eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k]))
        jf = jeng._actuator_forces(jm, js.qpos, js.qvel, jnp.asarray(ctrl[k]), state=js)
        tf = peng.actuator_forces(eng, ps.qpos, ps.qvel, torch.tensor(ctrl[k]), ps)
        np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=0, atol=1e-12)
        np.testing.assert_allclose(peng.actuator_moment(eng, ps).numpy(),
                                   _np(jeng.actuator_moment(jm, js)), rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError) as jerr:
        jeng.actuator_moment(jm)
    with pytest.raises(NotImplementedError) as terr:
        peng.actuator_moment(eng)
    assert str(terr.value) == str(jerr.value).replace("(model, state)", "(eng, state)")
    with pytest.raises(ValueError, match="spatial-tendon actuators need state kinematics"):
        peng.actuator_forces(eng, ps.qpos, ps.qvel, torch.tensor(ctrl[0]))


def test_spatial_coupled_steps_match_jax(models, jax_fns):
    """50 coupled (Newton) steps from the JAX test's start, where the limit
    row is active, under seeded controls; the first step's constraint rows
    against JAX build_rows."""
    jm, eng = models
    js = jax_fns["forward"](*(jnp.asarray(a) for a in START))
    ps = eng.forward(*(torch.tensor(a) for a in START))
    assert float(peng.spatial_tendon_geometry(eng, ps)[0][0]) > 0.62
    jr = jnewton.build_rows(jm, js, js.S, jnp.float64)
    pr = pnewton.build_rows(eng.rows, ps, ps.S)
    assert pr.J.shape == jr.J.shape == (2, 2)   # the masked fixed row, then the spatial row
    np.testing.assert_allclose(pr.J.numpy(), _np(jr.J), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pr.aref.numpy(), _np(jr.aref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pr.R.numpy(), _np(jr.R), rtol=1e-12)
    np.testing.assert_array_equal(pr.active.numpy(), _np(jr.active))
    assert pr.active.tolist() == [0.0, 1.0]
    ctrls = np.random.default_rng(2).uniform(-1.5, 1.5, (50, 1))
    for u in ctrls:
        js = jax_fns["step"](js, jnp.asarray(u))
        ps = eng.step(ps, torch.tensor(u))
        np.testing.assert_allclose(ps.qpos.numpy(), _np(js.qpos), rtol=0, atol=1e-10)
        np.testing.assert_allclose(ps.qvel.numpy(), _np(js.qvel), rtol=0, atol=5e-8)


@pytest.mark.parametrize("solver", ["penalty", "coupled"])
def test_spatial_batched_step_matches_jax(models, jax_fns, solver):
    """One step over K=8 against jax.vmap of JAX's step: the penalty tier's
    limit force and implicit damping from the moment row, and the coupled
    tier's batched Newton rows."""
    _, eng = models
    qpos, qvel, ctrl = spatial_inputs(NS, 3)
    want = jax_fns[f"{solver}_k"](jax_fns["batch"](jnp.asarray(qpos), jnp.asarray(qvel)),
                                  jnp.asarray(ctrl))
    got = eng.step(eng.forward(torch.tensor(qpos), torch.tensor(qvel),
                               torch.zeros(NS, dtype=F64)), torch.tensor(ctrl), solver=solver)
    np.testing.assert_allclose(got.qpos.numpy(), _np(want.qpos), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.qvel.numpy(), _np(want.qvel), rtol=0, atol=5e-8)


def test_spatial_inverse_dynamics_matches_jax(models, jax_fns):
    """inverse_dynamics (the limit row in its inverse reading) at 8 seeded
    states with seeded accelerations, and at zero acceleration."""
    jm, eng = models
    qpos, qvel, _ = spatial_inputs(NS, 4)
    qacc = np.random.default_rng(5).normal(0, 5, (NS, 2))
    jid = jax.jit(lambda q, v, a: jeng.inverse_dynamics(jm, jeng.forward(jm, q, v), a))
    for k in range(NS):
        ps = eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k]))
        for a in (qacc[k], np.zeros(2)):
            want = _np(jid(jnp.asarray(qpos[k]), jnp.asarray(qvel[k]), jnp.asarray(a)))
            got = peng.inverse_dynamics(eng, ps, torch.tensor(a)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_spatial_linearize_matches_jax(models):
    """A and B of the coupled step by autograd through the moment row, at
    the limit-active start, against JAX's jitted linearize."""
    jm, eng = models
    u0 = np.array([0.7])
    jA, jB = jax.jit(lambda q, v, u: jlqr.linearize(jm, q, v, u))(
        *(jnp.asarray(a) for a in (*START, u0)))
    A, B = tlqr.linearize(eng, *START, u0)
    np.testing.assert_allclose(A.numpy(), _np(jA), rtol=0, atol=1e-8)
    np.testing.assert_allclose(B.numpy(), _np(jB), rtol=0, atol=1e-8)
    assert np.abs(_np(jB)).max() > 1e-4


def test_spatial_refusals_match_jax(models, jax_fns):
    """coupled_pgs refuses a limited spatial tendon and the rollout kernel
    refuses any spatial tendon, each in JAX's words."""
    jm, eng = models
    js = jax_fns["forward"](*(jnp.asarray(a) for a in START))
    with pytest.raises(NotImplementedError) as jerr:   # raised while tracing
        jax.jit(lambda s: jeng.step(jm, s, jnp.zeros(1), solver="coupled_pgs"))(js)
    with pytest.raises(NotImplementedError) as terr:
        eng.step(eng.forward(*(torch.tensor(a) for a in START)), torch.zeros(1, dtype=F64),
                 solver="coupled_pgs")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as jerr:
        jrk.build_rollout_kernel(jm, jkc.KERNEL_COSTS["cartpole"], 3)
    with pytest.raises(NotImplementedError) as terr:
        rk.build_rollout_kernel(eng.model, tkc.cartpole, 3, device="cpu")
    assert str(terr.value) == str(jerr.value)
