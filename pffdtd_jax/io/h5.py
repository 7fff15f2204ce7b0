"""The HDF5 sim-folder format — the framework's central file contract.

A "sim folder" holds five files (format parity: SURVEY.md §2.8; written/read at
reference python/fdtd/{sim_consts,sim_mats,sim_comms}.py,
reference python/voxelizer/{cart_grid,vox_scene}.py and consumed by
reference c_cuda/fdtd_data.h:99-718):

- sim_consts.h5 : c, h, Ts, SR, l, l2, fcc_flag(0/1/2), Tc, rh
- cart_grid.h5  : xv, yv, zv, h   (original grid, never rotated/folded)
- vox_out.h5    : Nx,Ny,Nz,Nb, bn_ixyz(i64), adj_bn(bool Nb x NN),
                  mat_bn(i8, -1 = rigid), saf_bn(f64), xv,yv,zv, h
- comms_out.h5  : Ns,Nr,Nt,diff, in_ixyz, out_ixyz, out_alpha(Nr,8),
                  out_reorder, in_sigs(Ns,Nt)
- sim_mats.h5   : Nmat, Mb(i8 per mat), mat_%02d_DEF (Mb x 3 f64)

plus the output file sim_outs.h5 : u_out(Nr,Nt) (post-processing adds r_out).

fcc_flag: 0 = Cartesian; 1 = FCC on the full interleaved grid (even parity
active); 2 = FCC folded across mid-y (dense half grid).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

try:
    import h5py

    H5File = h5py.File
except ImportError:
    # machines without h5py read and write sim folders through the
    # pure-NumPy subset (it reads only files it wrote itself)
    from pffdtd_jax.io.hdf5_lite import File as H5File

MMb = 12  # max RLC branches per material (reference: sim_fdtd.py:36, fdtd_data.h:33)


@dataclass
class SimConstsData:
    c: float
    h: float
    Ts: float
    SR: float
    l: float
    l2: float
    fcc_flag: int
    Tc: float = 20.0
    rh: float = 50.0

    @property
    def fcc(self) -> bool:
        return self.fcc_flag > 0


@dataclass
class CommsData:
    in_ixyz: np.ndarray    # (Ns,) i64
    out_ixyz: np.ndarray   # (Nr,) i64
    out_alpha: np.ndarray  # (Nr/8, 8) f64 trilinear weights
    out_reorder: np.ndarray  # (Nr,) i64
    in_sigs: np.ndarray    # (Ns, Nt) f64
    diff: bool

    @property
    def Ns(self) -> int:
        return int(self.in_ixyz.size)

    @property
    def Nr(self) -> int:
        return int(self.out_ixyz.size)

    @property
    def Nt(self) -> int:
        return int(self.in_sigs.shape[-1])


@dataclass
class VoxData:
    Nx: int
    Ny: int
    Nz: int
    bn_ixyz: np.ndarray   # (Nb,) i64
    adj_bn: np.ndarray    # (Nb, NN) bool
    mat_bn: np.ndarray    # (Nb,) i8, -1 = rigid
    saf_bn: np.ndarray    # (Nb,) f64
    xv: np.ndarray
    yv: np.ndarray
    zv: np.ndarray
    h: float

    @property
    def Nb(self) -> int:
        return int(self.bn_ixyz.size)

    @property
    def NN(self) -> int:
        return int(self.adj_bn.shape[1]) if self.adj_bn.ndim == 2 else 6


@dataclass
class MatsData:
    Nmat: int
    Mb: np.ndarray    # (Nmat,) i8
    DEF: np.ndarray   # (Nmat, MMb, 3) f64, zero-padded past Mb[i]


def read_consts(folder) -> SimConstsData:
    with H5File(Path(folder) / "sim_consts.h5", "r") as f:
        kw = {k: f[k][()] for k in ("c", "h", "Ts", "SR", "l", "l2", "fcc_flag")}
        for k in ("Tc", "rh"):
            if k in f:
                kw[k] = f[k][()]
    kw["fcc_flag"] = int(kw["fcc_flag"])
    return SimConstsData(**{k: (float(v) if k != "fcc_flag" else v) for k, v in kw.items()})


def read_comms(folder) -> CommsData:
    with H5File(Path(folder) / "comms_out.h5", "r") as f:
        return CommsData(
            in_ixyz=f["in_ixyz"][...].astype(np.int64),
            out_ixyz=f["out_ixyz"][...].reshape(-1).astype(np.int64),
            out_alpha=f["out_alpha"][...],
            out_reorder=f["out_reorder"][...].astype(np.int64),
            in_sigs=np.atleast_2d(f["in_sigs"][...]),
            diff=bool(f["diff"][()]) if "diff" in f else False,
        )


def write_comms(folder, comms: CommsData, compress=None):
    kw = {"compression": "gzip", "compression_opts": compress} if compress else {}
    with H5File(Path(folder) / "comms_out.h5", "w") as f:
        f.create_dataset("in_ixyz", data=comms.in_ixyz, **kw)
        f.create_dataset("out_ixyz", data=comms.out_ixyz, **kw)
        f.create_dataset("out_alpha", data=comms.out_alpha, **kw)
        f.create_dataset("out_reorder", data=comms.out_reorder, **kw)
        f.create_dataset("in_sigs", data=comms.in_sigs, **kw)
        f.create_dataset("Ns", data=np.int64(comms.Ns))
        f.create_dataset("Nr", data=np.int64(comms.Nr))
        f.create_dataset("Nt", data=np.int64(comms.Nt))
        f.create_dataset("diff", data=np.int8(comms.diff))


def read_vox(folder) -> VoxData:
    with H5File(Path(folder) / "vox_out.h5", "r") as f:
        return VoxData(
            Nx=int(f["Nx"][()]),
            Ny=int(f["Ny"][()]),
            Nz=int(f["Nz"][()]),
            bn_ixyz=f["bn_ixyz"][...].astype(np.int64),
            adj_bn=f["adj_bn"][...].astype(bool),
            mat_bn=f["mat_bn"][...].astype(np.int8),
            saf_bn=f["saf_bn"][...].astype(np.float64),
            xv=f["xv"][...],
            yv=f["yv"][...],
            zv=f["zv"][...],
            h=float(f["h"][()]),
        )


def write_vox(folder, vox: VoxData, compress=None):
    kw = {"compression": "gzip", "compression_opts": compress} if compress else {}
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    with H5File(folder / "vox_out.h5", "w") as f:
        f.create_dataset("bn_ixyz", data=vox.bn_ixyz, **kw)
        f.create_dataset("adj_bn", data=vox.adj_bn, **kw)
        f.create_dataset("mat_bn", data=vox.mat_bn, **kw)
        f.create_dataset("saf_bn", data=vox.saf_bn, **kw)
        f.create_dataset("xv", data=vox.xv, **kw)
        f.create_dataset("yv", data=vox.yv, **kw)
        f.create_dataset("zv", data=vox.zv, **kw)
        f.create_dataset("h", data=np.float64(vox.h))
        f.create_dataset("Nx", data=np.int64(vox.Nx))
        f.create_dataset("Ny", data=np.int64(vox.Ny))
        f.create_dataset("Nz", data=np.int64(vox.Nz))
        f.create_dataset("Nb", data=np.int64(vox.Nb))


def read_mats(folder) -> MatsData:
    with H5File(Path(folder) / "sim_mats.h5", "r") as f:
        Nmat = int(f["Nmat"][()])
        Mb = f["Mb"][...].astype(np.int8) if Nmat > 0 else np.zeros((0,), np.int8)
        DEF = np.zeros((Nmat, MMb, 3), np.float64)
        for i in range(Nmat):
            d = f[f"mat_{i:02d}_DEF"][...]
            assert d.shape == (Mb[i], 3)
            assert Mb[i] <= MMb
            DEF[i, : Mb[i]] = d
    return MatsData(Nmat=Nmat, Mb=Mb, DEF=DEF)


def write_mats(folder, DEF_list, compress=None):
    """Write sim_mats.h5 from a list of (Mb_i, 3) DEF arrays."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    Nmat = len(DEF_list)
    Mb = np.zeros((Nmat,), np.int8)
    with H5File(folder / "sim_mats.h5", "w") as f:
        f.create_dataset("Nmat", data=np.int8(Nmat))
        for i, DEF in enumerate(DEF_list):
            DEF = np.atleast_2d(np.asarray(DEF, np.float64))
            assert DEF.ndim == 2 and DEF.shape[1] == 3
            f.create_dataset(f"mat_{i:02d}_DEF", data=DEF)
            Mb[i] = DEF.shape[0]
        f.create_dataset("Mb", data=Mb)


def read_mat_file(path) -> np.ndarray:
    """Read one material file: dataset 'DEF', shape (Mb, 3)."""
    with H5File(Path(path), "r") as f:
        return np.atleast_2d(f["DEF"][()])


def read_cart_grid(folder):
    with H5File(Path(folder) / "cart_grid.h5", "r") as f:
        return f["xv"][...], f["yv"][...], f["zv"][...], float(f["h"][()])


def write_outputs(folder, u_out, out_reorder=None):
    """Write sim_outs.h5 with u_out reordered to receiver order."""
    u_out = np.asarray(u_out, np.float64)
    if out_reorder is not None:
        u_out = u_out[np.asarray(out_reorder)]
    with H5File(Path(folder) / "sim_outs.h5", "w") as f:
        f.create_dataset("u_out", data=u_out)


def read_outputs(folder) -> np.ndarray:
    with H5File(Path(folder) / "sim_outs.h5", "r") as f:
        return f["u_out"][...]


class SimFolder:
    """Lazy handle over a sim folder; loads the five inputs on demand."""

    def __init__(self, folder):
        self.folder = Path(folder)
        self._consts = self._comms = self._vox = self._mats = None

    @property
    def consts(self) -> SimConstsData:
        if self._consts is None:
            self._consts = read_consts(self.folder)
        return self._consts

    @property
    def comms(self) -> CommsData:
        if self._comms is None:
            self._comms = read_comms(self.folder)
        return self._comms

    @property
    def vox(self) -> VoxData:
        if self._vox is None:
            self._vox = read_vox(self.folder)
        return self._vox

    @property
    def mats(self) -> MatsData:
        if self._mats is None:
            self._mats = read_mats(self.folder)
        return self._mats

    def write_outputs(self, u_out):
        write_outputs(self.folder, u_out, self.comms.out_reorder)
