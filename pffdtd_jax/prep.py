"""Sim-folder preparation transforms: rotate, FCC-fold, sort, copy.

Semantics parity target: reference python/fdtd/rotate_sim_data.py:
- rotate_sim_data (30-130): permute grid dims to descending order (minimises
  the halo-slice area for slab decomposition) rewriting every index array and
  the adjacency column order;
- fold_fcc_sim_data (191-262): fold the FCC interleaved grid across mid-y
  into a dense half grid (Ny -> Ny/2+1), swapping the y-sign-flipped
  adjacency columns (0<->6, 1<->7, 2<->9, 3<->8) and setting fcc_flag=2;
- sort_sim_data (132-189): sort all index arrays ascending (a precondition
  for slab splitting) recording out_reorder;
- copy_sim_data (264-279).

These operate in-place on a sim folder's HDF5 files (cart_grid.h5 is never
touched — it keeps the original orientation).  In-memory variants operating
on SimData are provided for the pipeline API.
"""

from __future__ import annotations

import shutil
from dataclasses import replace
from pathlib import Path

import numpy as np

from pffdtd_jax.scene_setup import SimData
from pffdtd_jax.utils import ind2sub3d
from pffdtd_jax.voxelizer.vox import CART_VECTORS, FCC_VECTORS


def _permute_indices(ixyz, tr, N, Nt_dims):
    ix, iy, iz = ind2sub3d(ixyz, *N)
    subs = [ix, iy, iz]
    subs_t = [subs[t] for t in tr]
    Nxt, Nyt, Nzt = Nt_dims
    return (subs_t[0] * Nyt + subs_t[1]) * Nzt + subs_t[2]


def _adj_column_perm(tr, NN):
    """Column permutation of adj_bn under a dim permutation tr."""
    VV = (FCC_VECTORS if NN == 12 else CART_VECTORS).astype(np.int64)
    jj = np.array([np.flatnonzero((VV == v[list(tr)]).all(-1))[0] for v in VV])
    return np.argsort(jj)


def pad_x(sim: SimData, D: int, min_rows: int = 1) -> SimData:
    """Pad the grid's x extent to a multiple of D with at least min_rows
    rows per slab (ShardedEngine's D equal x-slabs).  Padding rows are
    plain exterior air past the high-x wall — they carry no boundary nodes
    and stay acoustically decoupled from a closed room, so its results are
    unchanged (the multi-GPU reference instead *requires* divisible splits,
    gpu_engine.h:516-662).
    """
    vox = sim.vox
    add = max(-(-vox.Nx // D), min_rows) * D - vox.Nx
    if not add:
        return sim
    return replace(sim, vox=replace(
        vox, Nx=vox.Nx + add,
        xv=np.r_[vox.xv, vox.xv[-1] + vox.h * np.arange(1, add + 1)]))


def rotate_sim(sim: SimData, tr=None) -> SimData:
    """Permute grid dims (the reference's rule, rotate_sim_data.py:30-130).

    By default the dims go in descending order, so x (the slab axis of the
    sharded engine) is the longest and the halo planes are the smallest.  A
    folded FCC grid (fcc_flag=2) keeps its half-y axis on y: the other two
    axes take x and z, longer first.
    """
    vox, comms = sim.vox, sim.comms
    N = (vox.Nx, vox.Ny, vox.Nz)
    if tr is None:
        if int(getattr(sim.consts, "fcc_flag", 0)) == 2:
            a, b = sorted((0, 2), key=lambda k: -N[k])
            tr = (a, 1, b)
        else:
            tr = tuple(sorted(range(3), key=lambda k: -N[k]))
    else:
        tr = tuple(tr)
    if tr == (0, 1, 2):
        return sim
    Nt_dims = tuple(N[t] for t in tr)
    vvecs = [vox.xv, vox.yv, vox.zv]

    ia = _adj_column_perm(tr, vox.NN)
    vox2 = replace(
        vox,
        Nx=Nt_dims[0], Ny=Nt_dims[1], Nz=Nt_dims[2],
        bn_ixyz=_permute_indices(vox.bn_ixyz, tr, N, Nt_dims),
        adj_bn=vox.adj_bn[:, ia],
        xv=vvecs[tr[0]], yv=vvecs[tr[1]], zv=vvecs[tr[2]],
    )
    comms2 = replace(
        comms,
        in_ixyz=_permute_indices(comms.in_ixyz, tr, N, Nt_dims),
        out_ixyz=_permute_indices(comms.out_ixyz, tr, N, Nt_dims),
    )
    return replace(sim, vox=vox2, comms=comms2)


def fold_fcc_sim(sim: SimData) -> SimData:
    """Fold the interleaved FCC grid (fcc_flag=1) across mid-y -> flag 2."""
    assert sim.consts.fcc_flag == 1
    vox, comms = sim.vox, sim.comms
    Nx, Ny, Nz = vox.Nx, vox.Ny, vox.Nz
    assert Ny % 2 == 0
    Nyh = Ny // 2 + 1

    def fold(ixyz):
        ix, iy, iz = ind2sub3d(ixyz, Nx, Ny, Nz)
        hi = iy >= Ny // 2
        iy2 = np.where(hi, Ny - iy - 1, iy)
        return (ix * Nyh + iy2) * Nz + iz, hi

    bn2, hi = fold(vox.bn_ixyz)
    adj2 = vox.adj_bn.copy()
    # folded nodes flip their y direction: swap +y-ish and -y-ish legs
    for a, b in ((0, 6), (1, 7), (2, 9), (3, 8)):
        adj2[hi, a], adj2[hi, b] = vox.adj_bn[hi, b], vox.adj_bn[hi, a]
    in2, _ = fold(comms.in_ixyz)
    out2, _ = fold(comms.out_ixyz)

    vox2 = replace(vox, Ny=Nyh, bn_ixyz=bn2, adj_bn=adj2,
                   yv=vox.yv[:Nyh])
    comms2 = replace(comms, in_ixyz=in2, out_ixyz=out2)
    consts2 = replace(sim.consts, fcc_flag=2)
    return replace(sim, vox=vox2, comms=comms2, consts=consts2)


def sort_sim(sim: SimData) -> SimData:
    """Sort boundary/io index arrays ascending; record out_reorder."""
    vox, comms = sim.vox, sim.comms
    ii = np.argsort(vox.bn_ixyz, kind="stable")
    vox2 = replace(vox, bn_ixyz=vox.bn_ixyz[ii], adj_bn=vox.adj_bn[ii],
                   mat_bn=vox.mat_bn[ii], saf_bn=vox.saf_bn[ii])
    jj = np.argsort(comms.in_ixyz, kind="stable")
    kk = np.argsort(comms.out_ixyz, kind="stable")
    comms2 = replace(
        comms,
        in_ixyz=comms.in_ixyz[jj], in_sigs=comms.in_sigs[jj],
        out_ixyz=comms.out_ixyz[kk],
        # compose with any pre-existing reorder (reference assumes arange)
        out_reorder=np.argsort(kk, kind="stable")[comms.out_reorder],
    )
    return replace(sim, vox=vox2, comms=comms2)


# ------------------------------------------------------------ file variants
def copy_sim_data(src, dst):
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    for f in Path(src).glob("*.h5"):
        shutil.copy(f, dst)


def _load(folder) -> SimData:
    from pffdtd_jax.io.h5 import read_comms, read_consts, read_mats, read_vox

    return SimData(consts=read_consts(folder), vox=read_vox(folder),
                   comms=read_comms(folder), mats=read_mats(folder))


def _store(folder, sim: SimData):
    from pffdtd_jax.io.h5 import H5File

    with H5File(Path(folder) / "vox_out.h5", "r+") as f:
        f["bn_ixyz"][...] = sim.vox.bn_ixyz
        f["adj_bn"][...] = sim.vox.adj_bn
        f["mat_bn"][...] = sim.vox.mat_bn
        f["saf_bn"][...] = sim.vox.saf_bn
        f["Nx"][()] = sim.vox.Nx
        f["Ny"][()] = sim.vox.Ny
        f["Nz"][()] = sim.vox.Nz
        for name, v in (("xv", sim.vox.xv), ("yv", sim.vox.yv),
                        ("zv", sim.vox.zv)):
            del f[name]
            f.create_dataset(name, data=v)
    with H5File(Path(folder) / "comms_out.h5", "r+") as f:
        f["in_ixyz"][...] = sim.comms.in_ixyz
        f["in_sigs"][...] = sim.comms.in_sigs
        f["out_ixyz"][...] = sim.comms.out_ixyz
        f["out_reorder"][...] = sim.comms.out_reorder
    with H5File(Path(folder) / "sim_consts.h5", "r+") as f:
        f["fcc_flag"][()] = np.int8(sim.consts.fcc_flag)


def rotate_sim_data(folder, tr=None):
    _store(folder, rotate_sim(_load(folder), tr=tr))


def fold_fcc_sim_data(folder):
    _store(folder, fold_fcc_sim(_load(folder)))


def sort_sim_data(folder):
    _store(folder, sort_sim(_load(folder)))
