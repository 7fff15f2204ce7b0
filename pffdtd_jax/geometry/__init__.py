from pffdtd_jax.geometry.tris import TriPre, tris_precompute  # noqa: F401
from pffdtd_jax.geometry.predicates import (  # noqa: F401
    tri_ray_intersect,
    tri_box_intersect,
)
from pffdtd_jax.geometry.room import RoomGeo  # noqa: F401
from pffdtd_jax.geometry.box import Box  # noqa: F401
