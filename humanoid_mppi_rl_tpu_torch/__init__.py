"""PyTorch/CUDA port of humanoid_mppi_rl_tpu.

Module names follow the JAX package so each counterpart is easy to find.
The port imports torch and never jax, mujoco or humanoid_mppi_rl_tpu; the
humanoid model it runs is a committed snapshot (assets/humanoid.json).
"""
