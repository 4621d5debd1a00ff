"""Go1 quadruped cost constants (costs/quadruped.py counterpart).

Only GAIT_TUNED is carried across so far; the array cost functions wait
for the batched array engine (ROADMAP A3)."""

# The kernel planner tier's runtime gait deltas for kernel_costs.quadruped
# (param_gait slots 4..12): w_height 500 -> 10k, home-posture shaping 3k on
# the true 12 leg joints, sigma x0.6 (slot 11, read by the solver). The
# reference cost verbatim (all-zero deltas) belly-crawls against the
# penalty planner model at large K; these restore a trot
# (scripts/dev_quad_gait.py).
GAIT_TUNED = (0.0, 0.0,            # d_target_vel_x, d_target_height
              3.0, 0.0, 0.0, 0.0,  # ln(w_h/500)=ln 20, w_v, w_tr, w_g logs
              3000.0,              # home-posture weight (true 12 joints)
              -0.5108256237659907,  # ln 0.6: sigma scale
              0.0)                 # temperature scale
