"""K-sharded MPPI over torch.distributed (parallel/ counterpart)."""

from .mesh import make_mesh, make_sharded_mppi, sharded_update_op  # noqa: F401
