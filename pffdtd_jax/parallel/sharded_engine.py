"""Multi-device engine: shard_map x-slab decomposition with ppermute halos.

The JAX analogue of the reference's multi-GPU design
(gpu_engine.h:516-662 split_data + :1086-1126 peer-to-peer halo exchange):

- the grid is split into D equal x-slabs over a 1-D `jax.sharding.Mesh`;
  one u1 plane per direction is exchanged per step with `lax.ppermute`
  (NCCL over NVLink on GPUs; the reference exchanges one u0 slice per
  direction with peer copies);
- all sparse boundary work (rigid corrections, impedance ODEs, ABCs,
  sources, receivers) is partitioned host-side into shard-local index lists,
  zero-padded to equal static shapes (scheme: padded entries carry zero
  weights so their gathers/scatters are no-ops);
- the whole Nt loop runs as `lax.scan` INSIDE `shard_map`, so nothing leaves
  the devices until the final (Nt, Nr) receiver block;
- per-shard x-extreme behaviour (grid-edge halo flips, the x-face ABCs) is
  handled with `lax.cond` on the shard index plus a per-row mask vector, so
  a single traced program serves every shard.

Requires Nx % D == 0 and Nx/D >= 4; `make_sharded_engine` pads x to fit.
In fp64 on CPU the D-shard output is bitwise identical to the single-device
sparse-rigid engine (tests/test_sharded_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pffdtd_jax.engine.coeffs import MMb
from pffdtd_jax.engine.jax_engine import EngineData, GridSpec, _abc_regions
from pffdtd_jax.io.h5 import SimFolder
from pffdtd_jax.voxelizer.vox import CART_VECTORS, FCC_VECTORS


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), ("x",))


def _pad_to(arr, n, fill=0):
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


@dataclass
class _ShardLists:
    """Per-shard padded index/weight arrays, stacked on a leading D axis."""

    bn_ext: np.ndarray      # (D, Nbm) gather idx into the ext slab (flat)
    bn_nbr: np.ndarray      # (D, Nbm, NN)
    bn_loc: np.ndarray      # (D, Nbm) scatter idx into the local slab (flat)
    bn_cut: np.ndarray      # (D, Nbm, NN)
    bn_ncut: np.ndarray     # (D, Nbm)
    bnl_loc: np.ndarray     # (D, Nblm)
    ssaf: np.ndarray        # (D, Nblm)
    mat: dict               # name -> (D, Nblm, MMb) or (D, Nblm)
    in_loc: np.ndarray      # (D, Ns)
    in_mask: np.ndarray     # (D, Ns)
    out_loc: np.ndarray     # (D, Nr)
    out_mask: np.ndarray    # (D, Nr)


def _partition(data: EngineData, D: int) -> _ShardLists:
    g = data.grid
    S = g.Nx // D
    row = g.Ny * g.Nzp  # flat stride of one x row

    def split(ixyz):
        gx = ixyz // row
        shard = np.clip(gx // S, 0, D - 1)
        return gx, shard

    # rigid-boundary lists
    gx, shard = split(data.bn_ixyz)
    rem = data.bn_ixyz - gx * row          # in-row offset
    lx = gx - shard * S
    per = [np.flatnonzero(shard == d) for d in range(D)]
    Nbm = max(1, max(p.size for p in per) if len(per) else 1)
    bn_ext = np.zeros((D, Nbm), np.int64)
    bn_nbr = np.zeros((D, Nbm, data.NN), np.int64)
    bn_loc = np.zeros((D, Nbm), np.int64)
    bn_cut = np.zeros((D, Nbm, data.NN), data.dtype)
    bn_ncut = np.zeros((D, Nbm), data.dtype)
    VV = (FCC_VECTORS if data.fcc else CART_VECTORS).astype(np.int64)
    ext_strides = (VV[:, 0] * g.Ny + VV[:, 1]) * g.Nzp + VV[:, 2]
    for d in range(D):
        p = per[d]
        ext_idx = (lx[p] + 1) * row + rem[p]
        bn_ext[d, : p.size] = ext_idx
        bn_nbr[d, : p.size] = ext_idx[:, None] + ext_strides[None, :]
        bn_loc[d, : p.size] = lx[p] * row + rem[p]
        bn_cut[d, : p.size] = data.bn_cut[p]
        bn_ncut[d, : p.size] = data.bn_ncut[p]

    # lossy-boundary lists (gather+scatter on the local slab only)
    gx, shard = split(data.bnl_ixyz)
    rem = data.bnl_ixyz - gx * row
    lx = gx - shard * S
    per = [np.flatnonzero(shard == d) for d in range(D)]
    Nblm = max(1, max(p.size for p in per) if len(per) else 1)
    bnl_loc = np.zeros((D, Nblm), np.int64)
    ssaf = np.zeros((D, Nblm), data.dtype)
    mat = {k: np.zeros((D, Nblm) + v.shape[1:], data.dtype)
           for k, v in data.mat_rows.items()}
    for d in range(D):
        p = per[d]
        bnl_loc[d, : p.size] = lx[p] * row + rem[p]
        ssaf[d, : p.size] = data.ssaf_bnl[p]
        for k in mat:
            mat[k][d, : p.size] = data.mat_rows[k][p]

    # sources / receivers: fixed global width, per-shard masks
    def io_lists(ixyz):
        gx, shard = split(ixyz)
        rem = ixyz - gx * row
        lx = gx - shard * S
        loc = np.zeros((D, ixyz.size), np.int64)
        mask = np.zeros((D, ixyz.size), data.dtype)
        for d in range(D):
            own = shard == d
            loc[d, own] = lx[own] * row + rem[own]
            mask[d, own] = 1.0
        return loc, mask

    in_loc, in_mask = io_lists(data.in_ixyz)
    out_loc, out_mask = io_lists(data.out_ixyz)

    return _ShardLists(bn_ext=bn_ext, bn_nbr=bn_nbr, bn_loc=bn_loc,
                       bn_cut=bn_cut, bn_ncut=bn_ncut, bnl_loc=bnl_loc,
                       ssaf=ssaf, mat=mat, in_loc=in_loc, in_mask=in_mask,
                       out_loc=out_loc, out_mask=out_mask)


class ShardedEngine:
    """x-slab sharded engine over a 1-D mesh."""

    def __init__(self, folder=None, *, consts=None, vox=None, comms=None,
                 mats=None, mesh: Mesh | None = None, dtype=np.float32,
                 pad_z: int | None = None, fp32_eps: float | None = None):
        if folder is not None:
            sf = SimFolder(folder)
            consts, vox, comms, mats = sf.consts, sf.vox, sf.comms, sf.mats
        from pffdtd_jax.utils import enable_compilation_cache

        enable_compilation_cache()
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D = self.mesh.devices.size
        self.data = EngineData(consts, vox, comms, mats, dtype=dtype,
                               pad_z=pad_z, fp32_eps=fp32_eps)
        g = self.data.grid
        if g.Nx % self.D != 0:
            raise ValueError(
                f"Nx={g.Nx} not divisible by {self.D} shards; use "
                f"make_sharded_engine (pads x) or prep.pad_x")
        self.S = g.Nx // self.D
        if self.S < 4:
            raise ValueError(f"{self.S} x-rows per shard; need >= 4")
        self.lists = _partition(self.data, self.D)
        self.Nt = self.data.Nt
        self._build()

    # ------------------------------------------------------------------ build
    def _build(self):
        data = self.data
        g = data.grid
        sc = data.sc
        dtype = data.dtype
        D, S = self.D, self.S
        Ny, Nz, Nzp = g.Ny, g.Nz, g.Nzp
        VV = (FCC_VECTORS if data.fcc else CART_VECTORS).astype(np.int64)

        a1 = dtype.type(sc.a1)
        a2 = dtype.type(sc.a2)
        sl2 = dtype.type(sc.sl2)
        l = dtype.type(sc.l)
        lo2 = dtype.type(sc.lo2)
        one = dtype.type(1.0)

        folded = g.folded
        fwd = [(i, i + 1) for i in range(D - 1)]
        bwd = [(i + 1, i) for i in range(D - 1)]

        # per-row mask: 1 where global x in [2, Nx-3] (uniform y/z ABC rows)
        gx_rows = np.arange(g.Nx)
        mx_np = ((gx_rows >= 2) & (gx_rows <= g.Nx - 3)).astype(dtype)

        # y/z-only ABC regions (x unrestricted): from the single-device
        # decomposition, keep regions whose x-class is "mid"
        def _as_slice(i):
            return i if isinstance(i, slice) else slice(i, i + 1)

        yz_regions = []
        for (sx, sy, sz), Q in _abc_regions(
                GridSpec(Nx=S + 4, Ny=Ny, Nz=Nz, Nzp=Nzp, fcc_flag=g.fcc_flag)):
            # regions built on a dummy Nx; x-mid regions have sx == slice(2, S+2)
            if isinstance(sx, slice):
                yz_regions.append(((_as_slice(sy), _as_slice(sz)), Q))
        # x-extreme single-row 2-D decomposition (for shard 0 row 1 and last
        # shard row S-2): 9 regions with Q = 1 + (y ext) + (z ext)
        xrow_regions = []
        ys_ = [slice(2, Ny - 1) if folded else slice(2, Ny - 2)]
        zs_ = [slice(2, Nz - 2)]
        y_ext = [1] if folded else [1, Ny - 2]
        z_ext = [1, Nz - 2]
        xrow_regions.append(((ys_[0], zs_[0]), 1))
        for ye in y_ext:
            xrow_regions.append((((ye,), zs_[0]), 2))
        for ze in z_ext:
            xrow_regions.append(((ys_[0], (ze,)), 2))
        for ye in y_ext:
            for ze in z_ext:
                xrow_regions.append((((ye,), (ze,)), 3))

        def apply_yz_abc(u, u0, mx):
            """Uniform y/z ABC over all rows, gated by the x-mid row mask."""
            for (sy, sz), Q in yz_regions:
                lQ = dtype.type(sc.l * Q) * mx[:, None, None]
                sl = (slice(None), sy, sz)
                u = u.at[sl].set((u[sl] + lQ * u0[sl]) / (one + lQ))
            return u

        def apply_xrow_abc(u, u0, r):
            """Proper face/edge/corner ABCs on the x-extreme local row r."""
            for (sy, sz), Q in xrow_regions:
                lQ = dtype.type(sc.l * Q)
                sy_ = sy if isinstance(sy, slice) else sy[0]
                sz_ = sz if isinstance(sz, slice) else sz[0]
                sl = (r, sy_, sz_)
                u = u.at[sl].set((u[sl] + lQ * u0[sl]) / (one + lQ))
            return u

        def step(carry, sig_n, *, lists):
            u0, u1, vh1, gh1 = carry
            ax = jax.lax.axis_index("x")

            # halo flips: y/z uniform, fold ghost, x via cond on shard index
            u1f = u1
            u1f = u1f.at[:, :, 0].set(u1f[:, :, 2])
            u1f = u1f.at[:, :, Nz - 1].set(u1f[:, :, Nz - 3])
            u1f = u1f.at[:, 0, :].set(u1f[:, 2, :])
            if folded:
                u1f = u1f.at[:, Ny - 1, :].set(u1f[:, Ny - 2, :])
            else:
                u1f = u1f.at[:, Ny - 1, :].set(u1f[:, Ny - 3, :])
            u1f = jax.lax.cond(ax == 0,
                               lambda u: u.at[0].set(u[2]), lambda u: u, u1f)
            u1f = jax.lax.cond(ax == D - 1,
                               lambda u: u.at[S - 1].set(u[S - 3]),
                               lambda u: u, u1f)

            # halo exchange: one u1 plane each way
            if D > 1:
                from_left = jax.lax.ppermute(u1f[S - 1:S], "x", fwd)
                from_right = jax.lax.ppermute(u1f[0:1], "x", bwd)
            else:
                from_left = jnp.zeros((1, Ny, Nzp), dtype)
                from_right = jnp.zeros((1, Ny, Nzp), dtype)
            ext = jnp.concatenate([from_left, u1f, from_right], axis=0)

            # dense stencil on ALL S local rows (y/z interior)
            acc = None
            for dx, dy, dz in VV:
                s = ext[1 + dx:S + 1 + dx, 1 + dy:Ny - 1 + dy, 1 + dz:Nz - 1 + dz]
                acc = s if acc is None else acc + s
            unew_int = (a1 * u1f[:, 1:Ny - 1, 1:Nz - 1]
                        - u0[:, 1:Ny - 1, 1:Nz - 1] + a2 * acc)
            unew = u0.at[:, 1:Ny - 1, 1:Nz - 1].set(unew_int)
            # revert the global halo rows (their stencil read wrap garbage)
            unew = jax.lax.cond(ax == 0,
                                lambda a: a.at[0].set(u0[0]), lambda a: a, unew)
            unew = jax.lax.cond(ax == D - 1,
                                lambda a: a.at[S - 1].set(u0[S - 1]),
                                lambda a: a, unew)

            # rigid-boundary corrections (gathers from ext, scatter local)
            ext_f = ext.reshape(-1)
            unew_f = unew.reshape(-1)
            cutsum = jnp.sum(lists["bn_cut"] * ext_f[lists["bn_nbr"]], -1)
            delta = sl2 * lists["bn_ncut"] * ext_f[lists["bn_ext"]] - a2 * cutsum
            unew_f = unew_f.at[lists["bn_loc"]].add(delta)

            # lossy impedance boundaries
            u0_f = u0.reshape(-1)
            u2b = u0_f[lists["bnl_loc"]]
            ub = unew_f[lists["bnl_loc"]]
            m = lists["mat"]
            lo2Kbg = lo2 * lists["ssaf"] * m["beta"]
            ub = ub - l * lists["ssaf"] * jnp.sum(
                2.0 * m["bDh"] * vh1 - m["bFh"] * gh1, -1)
            ub = (ub + lo2Kbg * u2b) / (one + lo2Kbg)
            unew_f = unew_f.at[lists["bnl_loc"]].set(ub)
            vh0 = (m["b"] * (ub - u2b)[:, None] + m["bd"] * vh1
                   - 2.0 * m["bFh"] * gh1)
            gh_new = gh1 + 0.5 * (vh0 + vh1)
            unew = unew_f.reshape(S, Ny, Nzp)

            # ABCs: uniform y/z regions (masked rows) + x-extreme rows
            unew = apply_yz_abc(unew, u0, lists["mx"])
            unew = jax.lax.cond(ax == 0,
                                lambda a: apply_xrow_abc(a, u0, 1),
                                lambda a: a, unew)
            unew = jax.lax.cond(ax == D - 1,
                                lambda a: apply_xrow_abc(a, u0, S - 2),
                                lambda a: a, unew)

            # source injection / receiver readout (+ cross-shard psum)
            unew_f = unew.reshape(-1)
            unew_f = unew_f.at[lists["in_loc"]].add(
                sig_n.astype(dtype) * lists["in_mask"])
            unew = unew_f.reshape(S, Ny, Nzp)
            out_n = jax.lax.psum(
                u1f.reshape(-1)[lists["out_loc"]] * lists["out_mask"], "x")

            return (u1f, unew, vh0, gh_new), out_n

        L = self.lists
        list_arrays = {
            "bn_ext": L.bn_ext, "bn_nbr": L.bn_nbr, "bn_loc": L.bn_loc,
            "bn_cut": L.bn_cut, "bn_ncut": L.bn_ncut, "bnl_loc": L.bnl_loc,
            "ssaf": L.ssaf, "in_loc": L.in_loc, "in_mask": L.in_mask,
            "out_loc": L.out_loc, "out_mask": L.out_mask,
            "mx": mx_np.reshape(D, S),
            "mat": dict(L.mat),
        }

        mesh = self.mesh
        spec_leaf = P("x")

        def shard_fn(u0, u1, vh1, gh1, sigs_T, lists):
            # lists arrive with the leading D axis already split away
            def body(carry, sig_n):
                return step(carry, sig_n, lists=lists)

            # pair the steps so each carry slot keeps its buffer across a
            # scan iteration (avoids a per-step full-slab rotation copy,
            # see jax_engine.run_scan)
            n = sigs_T.shape[0]
            if n % 2:
                carry, ys = jax.lax.scan(body, (u0, u1, vh1, gh1), sigs_T)
                return carry, ys

            def body2(c, x2):
                c, y0 = body(c, x2[0])
                c, y1 = body(c, x2[1])
                return c, jnp.stack((y0, y1))

            pairs = sigs_T.reshape(n // 2, 2, *sigs_T.shape[1:])
            carry, ys = jax.lax.scan(body2, (u0, u1, vh1, gh1), pairs)
            return carry, ys.reshape(n, *ys.shape[2:])

        lists_specs = jax.tree.map(lambda _: spec_leaf, list_arrays)
        fn = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("x"), P("x"), P("x"), P("x"), P(), lists_specs),
            out_specs=((P("x"), P("x"), P("x"), P("x")), P()),
            check_vma=False)
        self._sharded_fn = jax.jit(fn, donate_argnums=(0, 1, 2, 3))
        self._compiled = {}       # nt -> compiled executable
        self.compile_seconds = 0.0

        # lists go device-resident ONCE, sharded to match their specs:
        # numpy leaves would be re-uploaded on every run() call
        def flatten_lead(a):
            a = np.asarray(a)
            return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])

        self._lists_dev = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(flatten_lead(a)),
                                     NamedSharding(mesh, spec_leaf)),
            list_arrays)

    # -------------------------------------------------------------------- run
    def init_state(self):
        d = self.data
        g = d.grid
        sh = NamedSharding(self.mesh, P("x"))
        u0 = jax.device_put(jnp.zeros(g.shape, d.dtype), sh)
        u1 = jax.device_put(jnp.zeros(g.shape, d.dtype), sh)
        Nblm = self.lists.bnl_loc.shape[1]
        vh = jax.device_put(jnp.zeros((self.D * Nblm, MMb), d.dtype), sh)
        gh = jax.device_put(jnp.zeros((self.D * Nblm, MMb), d.dtype), sh)
        return u0, u1, vh, gh

    def run(self, nt: int | None = None, verbose: bool = True):
        """Run nt steps; returns u_out (Nr, nt) in float64.  elapsed/mvps
        exclude compilation, which is timed in compile_seconds."""
        import time

        d = self.data
        nt = self.Nt if nt is None else nt
        sigs = jnp.asarray((d.in_sigs[:, :nt] / d.infac).T.astype(d.dtype))
        state = self.init_state()
        fn = self._compiled.get(nt)
        if fn is None:
            t0 = time.perf_counter()
            fn = self._sharded_fn.lower(*state, sigs,
                                        self._lists_dev).compile()
            self.compile_seconds += time.perf_counter() - t0
            self._compiled[nt] = fn

        t0 = time.perf_counter()
        carry, ys = fn(*state, sigs, self._lists_dev)
        ys = np.asarray(jax.block_until_ready(ys))
        t1 = time.perf_counter()

        self.u_out = np.float64(ys.T) * d.infac
        g = d.grid
        npts = g.Nx * g.Ny * g.Nz
        self.elapsed = t1 - t0
        self.mvps = npts * nt / self.elapsed / 1e6
        if verbose:
            print(f"--ENGINE(sharded x{self.D}): {nt} steps, "
                  f"{npts / 1e6:.2f} Mvox, {self.elapsed:.3f}s "
                  f"-> {self.mvps:.1f} MVPS")
        return self.u_out


def make_sharded_engine(folder=None, *, consts=None, vox=None, comms=None,
                        mats=None, mesh: Mesh | None = None,
                        dtype=np.float32, pad_z: int | None = None):
    """A ShardedEngine for any grid: x is padded with decoupled exterior air
    (prep.pad_x) until it splits into the mesh's D equal slabs of at least
    4 rows.  A closed room's results are unchanged (the multi-GPU
    reference instead requires divisible splits, gpu_engine.h:516-662)."""
    if folder is not None:
        sf = SimFolder(folder)
        consts, vox, comms, mats = sf.consts, sf.vox, sf.comms, sf.mats
    mesh = mesh if mesh is not None else make_mesh()
    from pffdtd_jax.prep import pad_x
    from pffdtd_jax.scene_setup import SimData

    sim = pad_x(SimData(consts=consts, vox=vox, comms=comms, mats=mats),
                int(mesh.devices.size), min_rows=4)
    return ShardedEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                         mats=sim.mats, mesh=mesh, dtype=dtype, pad_z=pad_z)
