"""pffdtd_jax — a 3D room-acoustics FDTD framework in JAX.

A from-scratch reimplementation of the capabilities of PFFDTD (bsxfun/pffdtd):
the 7-point Cartesian / 13-point FCC wave-equation updates,
frequency-dependent RLC impedance boundaries, staircase surface-area (SAF)
corrections, first-order Engquist-Majda ABCs and machine-precision energy
accounting all run inside a single jitted timestep over device-resident grids,
compiled by XLA (NVIDIA GPUs; the CPU for tests), with `shard_map` slab
decomposition + `ppermute` halo exchange across several GPUs.  File formats
(the HDF5 "sim folder") are byte-compatible with the reference so existing
PFFDTD simulation folders run unchanged.

Subpackages
-----------
- ``consts``      simulation constants (CFL, grid spacing, sample rate)
- ``geometry``    triangle precompute + ray/box predicates + room geometry
- ``voxelizer``   Cartesian grid, voxel BVH, adjacency builder (the "compiler")
- ``materials``   RLC admittance fitting and DEF triplet tools
- ``io``          HDF5 sim-folder readers/writers
- ``engine``      the JAX engine (jitted step, energy oracle), numpy reference
- ``parallel``    mesh/sharding utilities and the sharded engine
- ``analysis``    air absorption models/filters and output post-processing
"""

__version__ = "0.1.0"
