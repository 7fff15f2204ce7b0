from pffdtd_jax.parallel.sharded_engine import (  # noqa: F401
    ShardedEngine, make_mesh, make_sharded_engine)
