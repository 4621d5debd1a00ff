"""The one-command pipelines (the JAX repo's scripts/*_pipeline.py), each
run as ``python -m humanoid_mppi_rl_tpu_torch.scripts.<name>``."""
