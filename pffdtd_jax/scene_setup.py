"""One-call simulation setup: geometry -> voxelization -> sim folder.

API parity target: reference python/sim_setup.py:29-140 (sequence:
RoomGeo -> SimConsts -> SimMats -> CartGrid -> SimComms (+diff) -> voxelize ->
clash check -> optional GPU-prep rotate/fold/sort).  This version can also run
fully in-memory (save_folder=None) returning the data objects directly, which
the tests and the engine use without touching disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from pffdtd_jax.comms import SimComms
from pffdtd_jax.consts import SimConsts
from pffdtd_jax.geometry.room import RoomGeo
from pffdtd_jax.io.h5 import (CommsData, MatsData, MMb, SimConstsData, VoxData,
                              read_mat_file, write_mats)
from pffdtd_jax.voxelizer.grid import CartGrid
from pffdtd_jax.voxelizer.vox import VoxScene


@dataclass
class SimData:
    """In-memory equivalent of a sim folder."""

    consts: SimConstsData
    vox: VoxData
    comms: CommsData
    mats: MatsData


def pack_mats(mat_list, mat_files_dict, read_folder) -> MatsData:
    """Collect DEF triplets for the scene's material list (sorted order).

    Parity: reference python/fdtd/sim_mats.py:34-66.
    """
    mat_list = [m for m in mat_list if m != "_RIGID"]
    mat_list.sort()
    assert mat_list == sorted(mat_files_dict.keys())
    DEF_list = []
    for mat in mat_list:
        DEF_list.append(read_mat_file(Path(read_folder) / mat_files_dict[mat]))
    return mats_from_DEF_list(DEF_list)


def mats_from_DEF_list(DEF_list) -> MatsData:
    Nmat = len(DEF_list)
    Mb = np.array([np.atleast_2d(d).shape[0] for d in DEF_list], np.int8)
    DEF = np.zeros((Nmat, MMb, 3))
    for i, d in enumerate(DEF_list):
        d = np.atleast_2d(d)
        assert d.shape[1] == 3 and d.shape[0] <= MMb
        DEF[i, : d.shape[0]] = d
    return MatsData(Nmat=Nmat, Mb=Mb, DEF=DEF)


def sim_setup_from_room(
    room_geo: RoomGeo,
    mats: MatsData | None = None,
    *,
    duration: float,
    insig_type: str = "impulse",
    fmax: float | None = None,
    PPW: float | None = None,
    h: float | None = None,
    Tc: float = 20.0,
    rh: float = 50.0,
    fcc_flag: bool = False,
    diff_source: bool = False,
    source_num: int = 1,
    offset: float = 3.5,
    save_folder=None,
    compress=None,
    block_size: int = 32,
    vox_backend: str = "auto",
    check_adj: bool = True,
    draw_vox: bool = False,
    draw_backend: str = "save",
) -> SimData:
    """Voxelize a RoomGeo and build all simulation inputs.

    draw_vox: render the voxelized boundary nodes over the scene after
    adjacency is built (parity: reference python/sim_setup.py:44-45,
    draw hook at 127-140); draw_backend='save' writes a PNG next to
    save_folder (or ./voxelization.png), 'show' opens a window."""
    if mats is None:
        mats = mats_from_DEF_list([])

    consts = SimConsts(Tc=Tc, rh=rh, h=h, fmax=fmax, PPW=PPW, fcc=bool(fcc_flag))
    cg = CartGrid(h=consts.h, offset=offset, bmin=room_geo.bmin,
                  bmax=room_geo.bmax, fcc=bool(fcc_flag))

    comms = SimComms(cg.xv, cg.yv, cg.zv, cg.h, consts.Ts, consts.l2,
                     fcc=bool(fcc_flag))
    comms.prepare_source_pts(room_geo.Sxyz[source_num - 1])
    comms.prepare_receiver_pts(room_geo.Rxyz)
    comms.prepare_source_signals(duration, sig_type=insig_type)
    if diff_source:
        comms.diff_source()

    vs = VoxScene(room_geo, cg, fcc=bool(fcc_flag))
    vs.calc_adj(block_size=block_size, backend=vox_backend)
    if check_adj:
        vs.check_adj_full()
    comms.check_for_clashes(vs.bn_ixyz)

    if draw_vox:
        from pffdtd_jax.viz import plot_voxelization

        fname = None
        if draw_backend == "save":
            fname = (Path(save_folder) / "voxelization.png"
                     if save_folder is not None else Path("voxelization.png"))
            Path(fname).parent.mkdir(parents=True, exist_ok=True)
        plot_voxelization(vs, fname=fname, cut_legs=True, room=room_geo)

    consts_data = SimConstsData(
        c=consts.c, h=consts.h, Ts=consts.Ts, SR=consts.SR, l=consts.l,
        l2=consts.l2, fcc_flag=consts.fcc_flag, Tc=Tc, rh=rh)
    vox_data = VoxData(
        Nx=cg.Nx, Ny=cg.Ny, Nz=cg.Nz, bn_ixyz=vs.bn_ixyz, adj_bn=vs.adj_bn,
        mat_bn=vs.mat_bn, saf_bn=vs.saf_bn, xv=cg.xv, yv=cg.yv, zv=cg.zv,
        h=cg.h)
    sim = SimData(consts=consts_data, vox=vox_data,
                  comms=comms.to_comms_data(), mats=mats)

    if save_folder is not None:
        save_sim_data(sim, save_folder, compress=compress)
        cg.save(save_folder)
    return sim


def save_sim_data(sim: SimData, folder, compress=None):
    from pffdtd_jax.io.h5 import write_comms, write_vox

    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    sc = SimConsts(Tc=sim.consts.Tc, rh=sim.consts.rh, h=sim.consts.h,
                   fcc=sim.consts.fcc_flag > 0)
    # preserve the exact stored constants (fcc_flag may be 2 after folding)
    from pffdtd_jax.io.h5 import H5File

    sc.save(folder)
    with H5File(folder / "sim_consts.h5", "r+") as f:
        for k, v in (("c", sim.consts.c), ("Ts", sim.consts.Ts),
                     ("SR", sim.consts.SR), ("l", sim.consts.l),
                     ("l2", sim.consts.l2)):
            f[k][()] = v
        f["fcc_flag"][()] = np.int8(sim.consts.fcc_flag)
    write_vox(folder, sim.vox, compress=compress)
    write_comms(folder, sim.comms, compress=compress)
    write_mats(folder, [sim.mats.DEF[i, : sim.mats.Mb[i]]
                        for i in range(sim.mats.Nmat)], compress=compress)


def sim_setup(
    model_json_file,
    mat_folder,
    mat_files_dict,
    duration,
    insig_type,
    fmax,
    PPW,
    save_folder,
    Tc=20.0,
    rh=50.0,
    source_num=1,
    fcc_flag=False,
    diff_source=False,
    rot_az_el=(0.0, 0.0),
    bmin=None,
    bmax=None,
    compress=None,
    save_folder_gpu=None,
    **kw,
):
    """File-based setup entry point mirroring the reference sim_setup API."""
    rg = RoomGeo(model_json_file, az_el=rot_az_el, bmin=bmin, bmax=bmax)
    rg.print_stats()
    mats = pack_mats(rg.mat_str, mat_files_dict, mat_folder)
    sim = sim_setup_from_room(
        rg, mats, duration=duration, insig_type=insig_type, fmax=fmax,
        PPW=PPW, Tc=Tc, rh=rh, fcc_flag=fcc_flag, diff_source=diff_source,
        source_num=source_num, save_folder=save_folder, compress=compress,
        **kw)

    if save_folder_gpu is not None:
        from pffdtd_jax.prep import copy_sim_data, fold_fcc_sim_data, \
            rotate_sim_data, sort_sim_data

        if Path(save_folder_gpu) != Path(save_folder):
            copy_sim_data(save_folder, save_folder_gpu)
        rotate_sim_data(save_folder_gpu)
        if fcc_flag:
            fold_fcc_sim_data(save_folder_gpu)
        sort_sim_data(save_folder_gpu)
    return sim
