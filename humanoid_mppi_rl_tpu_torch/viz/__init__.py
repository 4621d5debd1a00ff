"""Trajectory replay (viz counterpart, without the mujoco renderer)."""

from .replay import (  # noqa: F401
    kinematic_replay,
    load_trajectory,
    open_loop_model_rollout,
)
