"""PyTorch port vs the JAX package, module by module, in f64.

Inputs come from a numpy seed and go through both sides: kernel_math
(atan2/asin polynomials), the plain scalar physics step and forward, and
the humanoid kernel cost. Tolerances: 1e-12 for the polynomials, the JAX
kernel tests' qpos 1e-10 / qvel 1e-8 for the step (tests/test_kernel.py),
rtol 1e-10 for the cost."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import kernel_math as jkm
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import kernel_math as tkm
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import check_kernel_supported
from humanoid_mppi_rl_tpu_torch.physics.model import HINGE, SLIDE, load_model

HUMANOID_XML = os.path.join(os.path.dirname(__file__), "..", "humanoid_mppi_rl_tpu",
                            "assets", "humanoid.xml")
B = 4


@pytest.fixture(scope="module")
def models():
    return build_from_mjcf(HUMANOID_XML), load_model("humanoid")


def _state(pm, sink, seed=3):
    """qpos0 + noise (unit root quaternion), sunk `sink` m into the floor,
    random velocities and controls."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(pm.qpos0, (B, 1)) + rng.normal(0, 0.1, (B, pm.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 2] -= sink
    qvel = rng.normal(0, 0.3, (B, pm.nv))
    ctrl = rng.uniform(-0.5, 0.5, (B, pm.nu))
    return qpos, qvel, ctrl


def _j(a):
    return [jnp.asarray(a[:, i]) for i in range(a.shape[1])]


def _t(a):
    return [torch.tensor(a[:, i]) for i in range(a.shape[1])]


def _np(xs):
    return np.stack([np.asarray(x) for x in xs], 1)


@pytest.mark.parametrize("fn", ["atan2", "atan2_precise", "asin"])
def test_kernel_math_matches_jax(fn):
    rng = np.random.default_rng(0)
    y, x = rng.normal(0, 2, 512), rng.normal(0, 2, 512)
    x[:8] = 0.0
    s = rng.uniform(-1.2, 1.2, 512)
    if fn == "asin":
        got, want = tkm.asin(torch.tensor(s)), jkm.asin(jnp.asarray(s))
    else:
        precise = fn == "atan2_precise"
        got = tkm.atan2(torch.tensor(y), torch.tensor(x), precise=precise)
        want = jkm.atan2(jnp.asarray(y), jnp.asarray(x), precise=precise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("sink", [0.0, 0.25])
def test_scalar_step_matches_jax(models, sink):
    """sink=0.25 puts feet, shins and hands into the floor, so the contact,
    joint-limit and implicit-damping terms are all live."""
    jm, pm = models
    qpos, qvel, ctrl = _state(pm, sink)
    jq, jv, _ = jsph.scalar_step(jm, _j(qpos), _j(qvel), _j(ctrl), jnp.zeros(B))
    tq, tv, _ = tsph.scalar_step(pm, _t(qpos), _t(qvel), _t(ctrl),
                                 torch.zeros(B, dtype=torch.float64))
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-10)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=1e-8)
    assert not np.allclose(_np(tv), qvel)


def test_scalar_forward_matches_jax(models):
    jm, pm = models
    qpos, qvel, _ = _state(pm, 0.25)
    jf = jsph.scalar_forward(jm, _j(qpos), _j(qvel))
    tf = tsph.scalar_forward(pm, _t(qpos), _t(qvel))
    for key in ("xpos", "xquat", "V"):
        for b in range(1, pm.nbody):
            np.testing.assert_allclose(
                np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in tf[key][b]]),
                np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in jf[key][b]]),
                atol=1e-12, err_msg=f"{key}[{b}]")


_COST_CASES = {
    "baked": (dict(), False),
    "walk_weights": (dict(target=(10.0, 0.0, 1.28), w_height=22.0, w_orient=17.0,
                          w_goal_xy=1.0, w_clearance=1.0, w_foot_lift=10.0,
                          w_swing_vel=0.20, target_vel=(0.5, 0.0)), False),
    "runtime_params": (dict(param_target=True, param_gait=True), True),
}


@pytest.mark.parametrize("case", list(_COST_CASES))
def test_humanoid_cost_matches_jax(models, case):
    jm, pm = models
    kw, random_params = _COST_CASES[case]
    qpos, qvel, ctrl = _state(pm, 0.1, seed=5)
    rng = np.random.default_rng(7)
    params = rng.normal(0, 0.5, 16) if random_params else np.zeros(16)
    jf = jsph.scalar_forward(jm, _j(qpos), _j(qvel))
    tf = tsph.scalar_forward(pm, _t(qpos), _t(qvel))
    jctx = jsph.ctx_from(jm, jf, _j(qpos), _j(qvel), _j(ctrl), 0.0)
    jctx.params = [jnp.asarray(p) for p in params]
    tctx = tsph.ctx_from(pm, tf, _t(qpos), _t(qvel), _t(ctrl), 0.0)
    tctx.params = [torch.tensor(p) for p in params]
    jrun, jterm = jkc.humanoid(jm, **kw)
    trun, tterm = tkc.humanoid(pm, **kw)
    np.testing.assert_allclose(trun(tctx, 0).numpy(), np.asarray(jrun(jctx, 0)),
                               rtol=1e-10)
    np.testing.assert_allclose(tterm(tctx).numpy(), np.asarray(jterm(jctx)),
                               rtol=1e-10)


def test_features_outside_the_port_are_refused(models):
    _, pm = models
    assert tsph.unsupported_features(pm) == []
    check_kernel_supported(pm)
    j = next(i for i, jt in enumerate(pm.joints) if jt.jtype == HINGE)
    joints = list(pm.joints)
    joints[j] = dataclasses.replace(joints[j], jtype=SLIDE)
    slid = dataclasses.replace(pm, joints=tuple(joints))
    with pytest.raises(NotImplementedError, match="joint type"):
        check_kernel_supported(slid)
    qpos, qvel, ctrl = _state(pm, 0.0)
    with pytest.raises(NotImplementedError):
        tsph.scalar_forward(slid, _t(qpos), _t(qvel))
    fl = dataclasses.replace(pm, dof_frictionloss=np.full(pm.nv, 0.1))
    with pytest.raises(NotImplementedError, match="frictionloss"):
        check_kernel_supported(fl)
