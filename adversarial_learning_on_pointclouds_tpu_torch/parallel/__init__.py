"""Parallelism on ``torch.distributed``: data parallelism (``dist``) and
point sharding (``point``).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/parallel``: the
JAX package's mesh and shardings become a process group and the
collectives its partitioner would have inserted. ``point_sharded_eval``
and ``point_sharded_train_step`` load on first use (``point`` imports the
models, which import ``dist``).
"""

from adversarial_learning_on_pointclouds_tpu_torch.parallel.dist import (  # noqa: F401
    all_reduce_grads, broadcast_module, host_major_rank, point_sharding,
    rank, resolve_world, shard_rows, spawn, world_size,
)


def __getattr__(name):
    if name in ("point_sharded_eval", "point_sharded_train_step"):
        from adversarial_learning_on_pointclouds_tpu_torch.parallel import (
            point,
        )
        return getattr(point, name)
    raise AttributeError(name)
