"""Synthetic scenes for tests, benchmarks and the graft entry points.

Two levels:
- `make_shoebox_room`: a 12-triangle box RoomGeo that runs through the real
  voxelizer (exercises the full setup pipeline).
- `synthetic_box_sim`: constructs the boundary-node data of an axis-aligned
  box *analytically* (no ray casts), so benchmark-sized grids (1e8+ voxels)
  can be generated in seconds.  The adjacency equals what the voxelizer
  produces for an axis-aligned box: legs crossing a wall plane are cut.
"""

from __future__ import annotations

import numpy as np

from pffdtd_jax.geometry.room import RoomGeo
from pffdtd_jax.io.h5 import SimConstsData, VoxData
from pffdtd_jax.scene_setup import SimData, mats_from_DEF_list
from pffdtd_jax.consts import SimConsts

DEMO_DEF = np.array([[2.0, 5.0, 30.0],
                     [1.0, 10.0, 300.0],
                     [0.5, 8.0, 3000.0]])


def make_shoebox_room(Lx=2.0, Ly=3.0, Lz=2.5, mats=None, sides=None) -> RoomGeo:
    """A 12-triangle box room with outward normals.

    mats: list of 6 material names per face pair (-x,+x,-y,+y,-z,+z) or None
    for all-rigid; sides: per-face sidedness flags (default 1 = interior live).
    """
    v = np.array([[0, 0, 0], [Lx, 0, 0], [0, Ly, 0], [Lx, Ly, 0],
                  [0, 0, Lz], [Lx, 0, Lz], [0, Ly, Lz], [Lx, Ly, Lz]],
                 np.float64)
    faces = {
        "xm": [(0, 4, 6), (0, 6, 2)],
        "xp": [(1, 3, 7), (1, 7, 5)],
        "ym": [(0, 1, 5), (0, 5, 4)],
        "yp": [(2, 6, 7), (2, 7, 3)],
        "zm": [(0, 2, 3), (0, 3, 1)],
        "zp": [(4, 5, 7), (4, 7, 6)],
    }
    tris = np.array([t for key in faces for t in faces[key]], np.int64)

    if mats is None:
        mat_names = ["_RIGID"]
        mat_ind = np.full(12, -1, np.int8)
        mat_side = np.zeros(12, np.int8)
    else:
        names = sorted(set(m for m in mats if m != "_RIGID"))
        mat_names = names + (["_RIGID"] if "_RIGID" in mats else [])
        lookup = {m: i for i, m in enumerate(names)}
        lookup["_RIGID"] = -1
        mat_ind = np.array([lookup[mats[i // 2]] for i in range(12)], np.int8)
        if sides is None:
            sides = [1] * 6
        mat_side = np.array([sides[i // 2] if mat_ind[i] >= 0 else 0
                             for i in range(12)], np.int8)

    Sxyz = np.array([[0.55 * Lx, 0.6 * Ly, 0.5 * Lz]])
    Rxyz = np.array([[0.3 * Lx, 0.3 * Ly, 0.4 * Lz],
                     [0.7 * Lx, 0.45 * Ly, 0.6 * Lz]])
    return RoomGeo.from_arrays(v, tris, mat_ind, mat_side, mat_names,
                               Sxyz, Rxyz)


def synthetic_box_sim(Lx=8.0, Ly=6.0, Lz=5.0, h=0.02, duration=None, Nt=None,
                      fcc=False, lossy=True, Tc=20.0, rh=50.0,
                      insig_type="impulse", diff_source=None,
                      pad_x_to: int | None = None,
                      DEF: np.ndarray | None = None,
                      open_top: bool = False,
                      Rxyz: np.ndarray | None = None) -> SimData:
    """Analytic axis-aligned box sim data at arbitrary scale.

    Boundary adjacency: a leg from an in-room grid point is cut iff the
    neighbour point leaves the open box (0,Lx)x(0,Ly)x(0,Lz).  Exterior
    points are left as plain air (their waves never enter: rigid walls).
    For FCC only even-parity points are considered.

    Rxyz: (Nr, 3) receiver positions (default: two points at fixed
    fractions of the box, ~0.3 of its size from the source).

    open_top=True removes the z=Lz wall entirely: the field escapes
    through the opening and is absorbed by the Engquist-Majda ABCs at the
    grid extremes — the scene that exercises the ABC + lossy-ODE fp32
    paths together over production-length runs.
    """
    sc = SimConsts(Tc=Tc, rh=rh, h=h, fcc=fcc)
    from pffdtd_jax.voxelizer.grid import CartGrid
    from pffdtd_jax.voxelizer.vox import CART_VECTORS, FCC_VECTORS

    cg = CartGrid(h=h, offset=3.5, bmin=np.zeros(3),
                  bmax=np.array([Lx, Ly, Lz]), fcc=fcc)
    Nx, Ny, Nz = cg.Nx, cg.Ny, cg.Nz
    if pad_x_to and Nx % pad_x_to:
        add = pad_x_to - Nx % pad_x_to
        Nx += add
        cg.xv = np.r_[cg.xv, cg.xv[-1] + h * np.arange(1, add + 1)]
        cg.Nx = Nx
        cg.Nxyz = np.array([Nx, Ny, Nz])
        cg.Npts = int(Nx * Ny * Nz)

    VV = (FCC_VECTORS if fcc else CART_VECTORS).astype(np.int64)
    NN = VV.shape[0]

    # a leg p -> p+v is cut iff inside(p) != inside(p+v): symmetric by
    # construction (the mutual-adjacency stability precondition), and equal
    # to ray casting against the finite walls for all face nodes
    eps = 1e-9 * h
    xv, yv, zv = cg.xv, cg.yv, cg.zv
    inx = (xv > eps) & (xv < Lx - eps)
    iny = (yv > eps) & (yv < Ly - eps)
    inz = (zv > eps) & ((zv < Lz - eps) | open_top)

    # candidates: points within one step of a wall plane (either side),
    # excluding the outermost grid layer
    def near_wall(vals, L):
        return (np.abs(vals) <= h + eps) | (np.abs(vals - L) <= h + eps)

    nx_, ny_, nz_ = near_wall(xv, Lx), near_wall(yv, Ly), near_wall(zv, Lz)
    nx_[[0, -1]] = ny_[[0, -1]] = nz_[[0, -1]] = False

    bn_rows, adj_rows, in_rows = [], [], []
    iy_all = np.arange(1, Ny - 1)
    iz_all = np.arange(1, Nz - 1)
    yg, zg = np.meshgrid(iy_all, iz_all, indexing="ij")
    near_yz = nz_[None, iz_all] | ny_[iy_all, None]
    for ix in range(1, Nx - 1):
        sel = np.ones_like(yg, bool) if nx_[ix] else near_yz
        iy, iz = yg[sel], zg[sel]
        if fcc:
            par = (ix + iy + iz) % 2 == 0
            iy, iz = iy[par], iz[par]
        if iy.size == 0:
            continue
        px, py, pz = xv[ix], yv[iy], zv[iz]
        inside_p = (inx[ix] & iny[iy] & inz[iz])
        adj = np.ones((iy.size, NN), bool)
        for k, (dx, dy, dz) in enumerate(VV):
            qx, qy, qz = px + dx * h, py + dy * h, pz + dz * h
            inside_q = ((qx > eps) & (qx < Lx - eps)
                        & (qy > eps) & (qy < Ly - eps)
                        & (qz > eps) & ((qz < Lz - eps) | open_top))
            adj[:, k] = inside_p == inside_q
        is_bn = (~adj).any(-1)
        if not is_bn.any():
            continue
        bn_rows.append(((ix * Ny + iy[is_bn]) * Nz + iz[is_bn]))
        adj_rows.append(adj[is_bn])
        in_rows.append(inside_p[is_bn])

    bn_ixyz = np.concatenate(bn_rows) if bn_rows else np.zeros(0, np.int64)
    adj_bn = np.concatenate(adj_rows) if adj_rows else np.zeros((0, NN), bool)
    in_bn = np.concatenate(in_rows) if in_rows else np.zeros(0, bool)
    order = np.argsort(bn_ixyz)
    bn_ixyz, adj_bn, in_bn = bn_ixyz[order], adj_bn[order], in_bn[order]

    ncut = (~adj_bn).sum(-1).astype(np.float64)
    if lossy:
        # the reference's sidedness rule: only in-room (right-side) nodes
        # carry the material; wrong-side/exterior nodes are rigid
        # (vox_scene.py:392-410) - their region is acoustically decoupled
        mat_bn = np.where(in_bn, np.int8(0), np.int8(-1))
        mats = mats_from_DEF_list([DEMO_DEF if DEF is None else DEF])
    else:
        mat_bn = np.full(bn_ixyz.size, -1, np.int8)
        mats = mats_from_DEF_list([])
    # axis-aligned walls: |v_k . n| = 1 per cut face pair (Cartesian);
    # for FCC each cut leg sees the wall at 1/sqrt(2)
    saf_bn = ncut if not fcc else ncut / np.sqrt(2.0)

    vox = VoxData(Nx=Nx, Ny=Ny, Nz=Nz, bn_ixyz=bn_ixyz, adj_bn=adj_bn,
                  mat_bn=mat_bn, saf_bn=saf_bn, xv=cg.xv, yv=cg.yv, zv=cg.zv,
                  h=h)

    # source/receivers on grid points well inside the room
    from pffdtd_jax.comms import SimComms

    comms = SimComms(cg.xv, cg.yv, cg.zv, h, sc.Ts, sc.l2, fcc=fcc)
    comms.prepare_source_pts(np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz]))
    if Rxyz is None:
        Rxyz = np.array([[0.25 * Lx, 0.3 * Ly, 0.4 * Lz],
                         [0.7 * Lx, 0.6 * Ly, 0.55 * Lz]])
    comms.prepare_receiver_pts(np.asarray(Rxyz, np.float64))
    if Nt is not None:
        duration = Nt * sc.Ts
    assert duration is not None
    comms.prepare_source_signals(duration, sig_type=insig_type)
    if diff_source is None:
        diff_source = insig_type == "impulse"
    if diff_source:
        comms.diff_source()

    consts = SimConstsData(c=sc.c, h=sc.h, Ts=sc.Ts, SR=sc.SR, l=sc.l,
                           l2=sc.l2, fcc_flag=sc.fcc_flag, Tc=Tc, rh=rh)
    return SimData(consts=consts, vox=vox, comms=comms.to_comms_data(),
                   mats=mats)
