"""Humanoid locomotion costs (costs/humanoid.py counterpart), batched over
K: `running(state, u, t) -> (K,)` for a state whose fields carry a leading
K axis (Engine.forward on (K, nq) inputs).

`make_costs` is the v2/v3 collection cost (reference
src/Humanoid_datacollection_v2.jl:90-160) with the JAX package's fix: the
body-frame gait terms read each rollout's own state.
`make_costs_hard_penalty` is the hard-penalty variant (reference
src/Humanoid_datacollection.py), `make_costs_v1` the time-phased gait
(src/Humanoid_mppi.jl), and `make_costs_v2py` the FD-velocity cost of
src/Humanoid_datacollection_v2.py on a `GaitFDState`, the state that
`make_gait_fd_wrapper` threads through the plant and the rollouts.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import device_constant
from ..physics import spatial as sp
from ..physics.model import PhysicsModel
from ..physics.state import PhysicsState
from .base import EngineCache, body_com_linvel, quat_rpy

# Weight presets for make_costs / ops.kernel_costs.humanoid: the reference
# v3 weights (src/Humanoid_mppi_v3.jl), and "walk", the JAX package's tuned
# walking posture (the velocity-gait terms off, posture over goal distance;
# the humanoid_walk task).
WEIGHTS_V3 = dict(w_orient=5.0, w_goal_xy=12.5, w_height=5.0,
                  w_swing_x=8.0, w_swing_vel=0.15, w_knee_x=3.0,
                  w_clearance=2.0)
WEIGHTS_WALK = dict(w_orient=15.0, w_goal_xy=2.5, w_height=20.0,
                    w_swing_x=0.0, w_swing_vel=0.0, w_knee_x=0.0,
                    w_clearance=0.0)


def make_costs(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
               w_orient=5.0, w_goal_xy=12.5, w_height=5.0, w_swing_x=8.0,
               w_swing_vel=0.15, w_knee_x=3.0, w_clearance=2.0,
               w_foot_lift=0.0, **_unused):
    """(running, terminal); terminal = 10 x running with zero control. Each
    per-sample choice of a body (swing or stance foot, swing knee) is a
    torch.where between the two gathered rows."""
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty, tz = (float(v) for v in target)
    tvx, tvy = (float(v) for v in target_vel)
    engine = EngineCache(model)

    def running(state, u, t):
        eng = engine(state.qpos)
        qpos, qvel, xpos = state.qpos, state.qvel, state.xpos
        root = qpos[:, 0:3]

        roll, pitch, yaw = quat_rpy(qpos[:, 3:7])
        cost = w_orient * (roll ** 2 + pitch ** 2) + 0.075 * yaw ** 2

        goal_xy = torch.stack([root[:, 0] - tx, root[:, 1] - ty], dim=-1)
        cost = cost + w_goal_xy * torch.linalg.vector_norm(goal_xy, dim=-1)
        cost = cost + w_height * torch.abs(tz - root[:, 2])
        vel_xy = torch.stack([qvel[:, 0] - tvx, qvel[:, 1] - tvy], dim=-1)
        cost = cost + 1.0 * torch.linalg.vector_norm(vel_xy, dim=-1)

        # gait phase from the shins' forward com velocities
        vx_l = body_com_linvel(state, eng, id_shin_l)[:, 0]
        vx_r = body_com_linvel(state, eng, id_shin_r)[:, 0]
        left_swings = vx_l > vx_r
        pick = lambda a, b: torch.where(left_swings[:, None], xpos[:, a], xpos[:, b])

        foot_targetx = root[:, 0] + 0.5
        swing_foot = pick(id_foot_l, id_foot_r)
        stance_foot = pick(id_foot_r, id_foot_l)
        cost = cost + w_swing_x * torch.abs(swing_foot[:, 0] - foot_targetx)

        vx_swing = torch.where(left_swings,
                               body_com_linvel(state, eng, id_foot_l)[:, 0],
                               body_com_linvel(state, eng, id_foot_r)[:, 0])
        cost = cost - w_swing_vel * vx_swing

        swing_knee_x = pick(id_shin_l, id_shin_r)[:, 0]
        cost = cost + w_knee_x * (swing_knee_x - foot_targetx) ** 2

        clearance = swing_foot[:, 2] - stance_foot[:, 2]
        cost = cost + torch.where(clearance < 0.05, w_clearance * clearance ** 2,
                                  torch.zeros_like(clearance))

        leg_clearance = xpos[:, id_foot_l, 1] - xpos[:, id_foot_r, 1]
        cost = cost + torch.where(leg_clearance < 0.0, 0.5 * leg_clearance ** 2,
                                  torch.zeros_like(leg_clearance))

        # foot lift above a walking band (no reference analog, weight 0 by
        # default)
        lift_l = torch.clamp(xpos[:, id_foot_l, 2] - 0.25, min=0.0)
        lift_r = torch.clamp(xpos[:, id_foot_r, 2] - 0.25, min=0.0)
        cost = cost + w_foot_lift * (lift_l ** 2 + lift_r ** 2)

        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        zeros = torch.zeros(state.qpos.shape[0], model.nu, dtype=state.qpos.dtype,
                            device=state.qpos.device)
        return 10.0 * running(state, zeros, t)

    return running, terminal


def make_costs_walk(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
                    **kw):
    """The humanoid_walk preset: make_costs with WEIGHTS_WALK, `kw` on top."""
    merged = dict(WEIGHTS_WALK)
    merged.update(kw)
    return make_costs(model, target=target, target_vel=target_vel, **merged)


def _zero_ctrl(model: PhysicsModel, state):
    q = state.qpos
    return torch.zeros(q.shape[:-1] + (model.nu,), dtype=q.dtype, device=q.device)


def make_costs_hard_penalty(model: PhysicsModel, target=(2.0, 0.0, 1.28),
                            target_vel=(0.3, 0.0), **_unused):
    """The hard-penalty gait cost (reference src/Humanoid_datacollection.py:
    57-186, its live branch): the v2/v3 base terms plus 1000 x the swing
    foot's forward velocity, 10000 x the swing foot above its knee band, and
    100 x the clearance and lateral bands. The reference's quirks are kept:
    the height term is LINEAR (5 (h_t - z)), and the lateral bands have a
    [0.15, 0.21] dead zone."""
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty, tz = (float(v) for v in target)
    tvx, tvy = (float(v) for v in target_vel)
    engine = EngineCache(model)

    def running(state, u, t):
        eng = engine(state.qpos)
        qpos, qvel, xpos = state.qpos, state.qvel, state.xpos
        root = qpos[:, 0:3]
        roll, pitch, yaw = quat_rpy(qpos[:, 3:7])
        cost = 5.0 * (roll ** 2 + pitch ** 2) + 0.075 * yaw ** 2
        goal_xy = torch.stack([root[:, 0] - tx, root[:, 1] - ty], dim=-1)
        cost = cost + 12.5 * torch.linalg.vector_norm(goal_xy, dim=-1)
        cost = cost + 5.0 * (tz - root[:, 2])          # [sic] linear, not abs
        vel_xy = torch.stack([qvel[:, 0] - tvx, qvel[:, 1] - tvy], dim=-1)
        cost = cost + 1.0 * torch.linalg.vector_norm(vel_xy, dim=-1)

        vx_l = body_com_linvel(state, eng, id_shin_l)[:, 0]
        vx_r = body_com_linvel(state, eng, id_shin_r)[:, 0]
        left_swings = vx_l > vx_r
        pick = lambda a, b: torch.where(left_swings[:, None], xpos[:, a], xpos[:, b])
        swing_foot = pick(id_foot_l, id_foot_r)
        stance_foot = pick(id_foot_r, id_foot_l)
        knee = pick(id_shin_l, id_shin_r)

        foot_targetx = root[:, 0] + 0.5
        cost = cost + 8.0 * torch.abs(swing_foot[:, 0] - foot_targetx)
        vx_swing = torch.where(left_swings,
                               body_com_linvel(state, eng, id_foot_l)[:, 0],
                               body_com_linvel(state, eng, id_foot_r)[:, 0])
        cost = cost - 1000.0 * vx_swing
        cost = cost + 3.0 * (knee[:, 0] - foot_targetx) ** 2

        swing_knee_z = knee[:, 2]
        cost = cost + torch.where(swing_foot[:, 2] >= swing_knee_z - 0.3,
                                  10000.0 * (swing_foot[:, 2] - swing_knee_z) ** 2, 0.0)
        clearance = swing_foot[:, 2] - stance_foot[:, 2]
        cost = cost + torch.where(clearance < 0.005, 100.0 * clearance ** 2, 0.0)

        leg_cl = torch.abs(xpos[:, id_foot_l, 1] - xpos[:, id_foot_r, 1])
        cost = cost + torch.where((leg_cl <= 0.15) | (leg_cl >= 0.21), 100.0 * leg_cl ** 2, 0.0)
        knee_cl = torch.abs(xpos[:, id_shin_l, 1] - xpos[:, id_shin_r, 1])
        cost = cost + torch.where((knee_cl <= 0.15) | (knee_cl >= 0.21),
                                  100.0 * knee_cl ** 2, 0.0)
        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        return 10.0 * running(state, _zero_ctrl(model, state), t)

    return running, terminal


def make_costs_v1(model: PhysicsModel, target=(2.0, 0.0), target_vel=0.5, step_period=100):
    """Time-phased gait cost (reference src/Humanoid_mppi.jl:31-121): a
    square-wave gait clock alternates the swing and stance targets every
    `step_period` rollout steps (t, an int: the same side for every
    sample)."""
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty = (float(v) for v in target)
    tv = float(target_vel)

    def running(state, u, t):
        qpos, qvel, xpos = state.qpos, state.qvel, state.xpos
        root = qpos[:, 0:3]
        roll, pitch, yaw = quat_rpy(qpos[:, 3:7])
        cost = 5.0 * (roll ** 2 + pitch ** 2) + 0.1 * yaw ** 2
        goal_xy = torch.stack([root[:, 0] - tx, root[:, 1] - ty], dim=-1)
        cost = cost + 10.0 * torch.linalg.vector_norm(goal_xy, dim=-1)
        cost = cost + 5.0 * torch.abs(1.28 - root[:, 2])
        cost = cost + 1.0 * torch.abs(qvel[:, 0] - tv)

        left_swings = (int(t) // step_period) % 2 == 0
        swing, stance = (id_foot_l, id_foot_r) if left_swings else (id_foot_r, id_foot_l)
        clearance = xpos[:, swing, 2] - xpos[:, stance, 2]
        cost = cost + torch.where(clearance < 0.05, 5.0 * (0.05 - clearance) ** 2, 0.0)
        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        return 10.0 * running(state, _zero_ctrl(model, state), t)

    return running, terminal


# ---------------------------------------------------------------------------
# the v2.py variant: finite-difference velocities and a hysteresis gait
# phase (reference src/Humanoid_datacollection_v2.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GaitFDState:
    """A PhysicsState with the v2.py controller's extras (JAX GaitFDState):

    - `prev_qpos`: the previous step's qpos, for the finite-difference
      velocity (qpos - prev_qpos) / dt that the reference uses in place of
      qvel (:68-83, :250-256);
    - the hysteresis gait phase (:45-55, :133-162): the higher foot is the
      candidate swing side, and the committed side switches only after
      `phase_delay` consecutive frames agree. The reference keeps it in
      module globals mutated in the cost (one side per replan); here it is
      state threaded through the dynamics, so each rollout carries its own;
    - `goal` (3,): the target, moved at run time by `advance_goal_v2py`.

    The extras are tensors of the state's dtype; a planner's state carries
    a leading K axis on every field (solver/mppi.broadcast_state)."""

    phys: PhysicsState
    prev_qpos: torch.Tensor       # (nq,)
    committed_left: torch.Tensor  # 1.0 = left swing committed
    last_left: torch.Tensor       # the last instantaneous side
    count: torch.Tensor           # consecutive frames in agreement
    goal: torch.Tensor            # (3,)

    # passthroughs, so that the collection loops treat it as a PhysicsState
    @property
    def qpos(self):
        return self.phys.qpos

    @property
    def qvel(self):
        return self.phys.qvel

    @property
    def time(self):
        return self.phys.time

    @property
    def xpos(self):
        return self.phys.xpos

    @property
    def xquat(self):
        return self.phys.xquat

    def to(self, device=None, dtype=None) -> "GaitFDState":
        """Every tensor field on `device` in `dtype` (None keeps it)."""
        return GaitFDState(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})


def make_gait_fd_wrapper(model: PhysicsModel, phase_delay: int = 3, target=(2.0, 0.0, 1.28)):
    """(base_dynamics, init_phys) -> (dynamics, init) over GaitFDState.

    After every step (plant and rollout alike): inst = the left foot is
    higher; count + 1 where inst agrees with the last frame, else 1; the
    committed side becomes inst once count >= phase_delay (reference
    src/Humanoid_datacollection_v2.py:139-162)."""
    id_fl = model.body_id("foot_left")
    id_fr = model.body_id("foot_right")

    def wrap(base_dynamics, init_phys):
        def dynamics(st: GaitFDState, ctrl, t=None):
            phys = base_dynamics(st.phys, ctrl, t)
            inst_left = (phys.xpos[..., id_fl, 2] > phys.xpos[..., id_fr, 2]).to(phys.qpos.dtype)
            count = torch.where(inst_left == st.last_left, st.count + 1.0,
                                torch.ones_like(st.count))
            committed = torch.where(count >= phase_delay, inst_left, st.committed_left)
            return GaitFDState(phys=phys, prev_qpos=st.phys.qpos, committed_left=committed,
                               last_left=inst_left, count=count, goal=st.goal)

        q = init_phys.qpos
        z = torch.zeros((), dtype=q.dtype, device=q.device)
        init = GaitFDState(phys=init_phys, prev_qpos=q, committed_left=z + 1.0, last_left=z,
                           count=z, goal=torch.as_tensor(target, dtype=q.dtype, device=q.device))
        return dynamics, init

    return wrap


def advance_goal_v2py(st: GaitFDState, goal_step=(2.0, 0.0, 0.0),
                      threshold: float = 0.15) -> GaitFDState:
    """The reference's goal advance (:307-312): when the full 3D root-to-goal
    distance (z included) drops below `threshold`, the goal moves on by
    `goal_step`. Applied to the plant once per control step, on the device."""
    root = st.phys.qpos[..., 0:3]
    near = torch.linalg.vector_norm(root - st.goal, dim=-1) < threshold
    step = device_constant(tuple(float(x) for x in goal_step), st.goal.dtype, st.goal.device)
    return dataclasses.replace(st, goal=torch.where(near[..., None], st.goal + step, st.goal))


def make_costs_v2py(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
                    **_unused):
    """The cost of reference src/Humanoid_datacollection_v2.py:86-216 (its
    live branch), term by term, on a (K,)-batched GaitFDState.

    The reference's quirks are kept:
    - velocities are the FD estimate (qpos - prev_qpos) / dt (nq-sized, not
      qvel), zero at rollout step 0 (:250-256);
    - `knee_vel = vel_q[swing_foot_BODY_id]`: the reference indexes the FD
      velocity with a body id (:185), so an arbitrary qpos row is rewarded;
    - the forward axis is the torso rotation's first column, the targets
      projected onto it (:167-194), not the world x of v3;
    - the weights differ from v3: 4/1/12/10 (:102-106).
    The gait side is the committed hysteresis side of the state; the goal
    is the state's (`target` is unused)."""
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_torso = model.body_id("torso")
    del target  # the live goal rides in GaitFDState.goal
    tvx, tvy = (float(v) for v in target_vel)
    inv_dt = 1.0 / model.timestep

    def _core(st: GaitFDState, vel_q, u):
        qpos, xpos = st.phys.qpos, st.phys.xpos
        root = qpos[:, 0:3]
        tgt = st.goal
        roll, pitch, yaw = quat_rpy(qpos[:, 3:7])
        cost = 4.0 * (roll ** 2 + pitch ** 2) + 1.0 * yaw ** 2
        cost = cost + 12.0 * torch.linalg.vector_norm(root[:, 0:2] - tgt[:, 0:2], dim=-1)
        cost = cost + 10.0 * torch.abs(tgt[:, 2] - root[:, 2])
        vel_xy = torch.stack([vel_q[:, 0] - tvx, vel_q[:, 1] - tvy], dim=-1)
        cost = cost + 1.0 * torch.linalg.vector_norm(vel_xy, dim=-1)

        left = st.committed_left > 0.5
        pick = lambda x, a, b: torch.where(left[:, None], x[:, a], x[:, b])
        swing, stance = pick(xpos, id_foot_l, id_foot_r), pick(xpos, id_foot_r, id_foot_l)
        knee = pick(xpos, id_shin_l, id_shin_r)

        fwd = sp.quat_to_mat(st.phys.xquat[:, id_torso])[:, :, 0]
        root_proj = torch.sum(fwd * root, -1)
        desired = root_proj + 0.5
        cost = cost + 8.0 * torch.abs(torch.sum(fwd * swing, -1) - desired)

        knee_vel = torch.where(left, vel_q[:, id_foot_l], vel_q[:, id_foot_r])  # [sic]
        cost = cost + torch.where(knee_vel > 0, -0.25 * knee_vel, 0.05 * (-knee_vel))

        cost = cost + 4.0 * torch.abs(torch.sum(fwd * knee, -1) - desired)
        cost = cost + 0.005 * torch.abs(stance[:, 2])

        leg_clearance = xpos[:, id_foot_l, 1] - xpos[:, id_foot_r, 1]
        cost = cost + torch.where(leg_clearance < 0.05, 1.0 * leg_clearance ** 2, 0.0)
        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def running(st: GaitFDState, u, t):
        if int(t) == 0:
            vel_q = torch.zeros_like(st.phys.qpos)
        else:
            vel_q = (st.phys.qpos - st.prev_qpos) * inv_dt
        return _core(st, vel_q, u)

    def terminal(st: GaitFDState, t):
        # the reference's terminal passes zero velocities (:215-216)
        return 10.0 * _core(st, torch.zeros_like(st.phys.qpos), _zero_ctrl(model, st.phys))

    return running, terminal
