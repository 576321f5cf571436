"""The fit+evolve step and point sharding (counterpart of ``gple_tpu.parallel``)."""

from gple_tpu_torch.parallel.sharding import (
    make_mesh,
    make_step_fn,
    shard_density,
    sharded_step_fn,
)

__all__ = ["make_mesh", "make_step_fn", "shard_density", "sharded_step_fn"]
