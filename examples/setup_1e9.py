"""Billion-voxel setup + sharded-engine compile demonstration.

The reference voxelizes up to 32.4e9 nodes using disk-spill multiprocessing
and a memmap'd full-grid adjacency check (vox_scene.py:127-314, 496-529).
This framework instead keeps every setup stage O(boundary) or O(chunk):
the native voxelizer emits boundary nodes per x-slab, and check_adj_full
resolves partners sparsely by searchsorted (no dense grid ever exists).

This script runs the REAL pipeline at >= 1e9 grid points:
  RoomGeo (box mesh) -> CartGrid -> VoxGrid.fill -> VoxScene.calc_adj
  (native, OpenMP) -> sparse check_adj_full -> ShardedEngine on an 8-device
  CPU mesh -> jit-compile + run 2 steps on the full 1e9 grid.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/setup_1e9.py [--quick]
(--quick drops to ~1e8 points for CI-sized machines.)
"""

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="~1e8 points instead of 1e9")
    ap.add_argument("--h", type=float, default=None)
    args = ap.parse_args()

    from pffdtd_jax.geometry.room import RoomGeo
    from pffdtd_jax.scene_setup import mats_from_DEF_list, sim_setup_from_room
    from pffdtd_jax.parallel.sharded_engine import ShardedEngine

    # 32 x 25 x 20 m hall; h chosen so Npts >= target
    L = np.array([32.0, 25.0, 20.0])
    h = args.h or (0.055 if args.quick else 0.025)
    v = np.array([[0, 0, 0], [L[0], 0, 0], [0, L[1], 0], [L[0], L[1], 0],
                  [0, 0, L[2]], [L[0], 0, L[2]], [0, L[1], L[2]],
                  [L[0], L[1], L[2]]], float)
    tris = np.array([(0, 4, 6), (0, 6, 2), (1, 3, 7), (1, 7, 5),
                     (0, 1, 5), (0, 5, 4), (2, 6, 7), (2, 7, 3),
                     (0, 2, 3), (0, 3, 1), (4, 5, 7), (4, 7, 6)])
    rg = RoomGeo.from_arrays(v, tris, np.zeros(12, np.int8),
                             np.ones(12, np.int8), ["walls"],
                             [[12.0, 11.0, 9.0]], [[20.0, 14.0, 11.0]])
    mats = mats_from_DEF_list([np.array([[2.0, 5.0, 30.0]])])

    # nudge h so Nx divides the 8-shard mesh (the reference instead rotates
    # axes / regenerates; a sub-0.5% h change is inside the PPW tolerance)
    from pffdtd_jax.voxelizer.grid import CartGrid
    for _ in range(64):
        cg = CartGrid(h=h, offset=3.5, bmin=rg.bmin, bmax=rg.bmax)
        if cg.Nx % 8 == 0:
            break
        h *= 0.9995
    print(f"h={h:.6f} -> Nx={cg.Nx}")

    t0 = time.time()
    sim = sim_setup_from_room(rg, mats, duration=0.001, insig_type="impulse",
                              h=h, check_adj=True)
    t1 = time.time()
    g = sim.vox
    npts = g.Nx * g.Ny * g.Nz
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"setup: {g.Nx}x{g.Ny}x{g.Nz} = {npts / 1e9:.3f} Gvox, "
          f"Nb={g.Nb / 1e6:.2f}M, {t1 - t0:.1f}s, peak RSS {rss:.1f} GB",
          flush=True)

    eng = ShardedEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                        mats=sim.mats, dtype=np.float32)
    t2 = time.time()
    eng.run(nt=2, verbose=False)
    t3 = time.time()
    assert np.isfinite(eng.u_out).all()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"sharded D={eng.D} compile+2 steps: {t3 - t2:.1f}s, "
          f"peak RSS {rss:.1f} GB", flush=True)
    print("OK")


if __name__ == "__main__":
    main()
