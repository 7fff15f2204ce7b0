from pffdtd_jax.voxelizer.grid import CartGrid  # noqa: F401
from pffdtd_jax.voxelizer.vox import VoxScene, NEIGHBOR_VECTORS  # noqa: F401
