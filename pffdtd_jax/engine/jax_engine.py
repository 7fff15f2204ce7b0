"""The JAX engine: a single jitted leapfrog timestep over device-resident grids.

Design (NOT a port of the reference kernel zoo); every operation is plain
`jax.numpy`/`lax`, compiled by XLA for whatever device JAX runs on:

- The air update is a dense, branch-free 7/13-point stencil over the whole
  interior — shifted-slice adds that XLA fuses into one memory-bound loop
  (the same traffic per voxel as the reference CUDA air kernel,
  gpu_engine.h:220-274).
- Rigid boundary nodes are handled either by a dense bit-packed adjacency
  grid (rigid="dense": the masked stencil covers air and rigid nodes in one
  pass) or by a sparse per-node *correction* (rigid="sparse": for the Nb
  boundary nodes, delta = sl2*ncut*u1 - a2*sum(cut-leg neighbours) turns the
  full stencil into the adjacency-masked one; cpu_engine.h:234-287).
- Frequency-dependent impedance boundaries run as (Nbl, MMb) vectorised ODE
  branches between a gather and a scatter (cpu_engine.h:362-405 semantics).
- ABCs are dense face/edge/corner slice updates with uniform Q per region —
  no sparse ABC node lists at all (semantics of sim_fdtd.py:807-813).
- The whole run is one `lax.scan`: source samples stream in as scan inputs,
  receiver samples accumulate on-device as scan outputs — zero host syncs
  inside the loop (the reference does a D2H readout every step,
  gpu_engine.h:1058-1075).
- fp32 stability uses the (1+EPS) diagonal shift of fdtd_data.h:186-194
  (configurable; the reference's round-toward-zero intrinsics have no XLA
  equivalent — the EPS eigenvalue margin is the load-bearing safeguard) plus
  the same mid-exponent input scaling (fdtd_data.h:878-925).
- The step has no matrix product, so no TF32 (or other reduced-precision
  matmul mode) can enter an fp32 run.

Energy accounting (the machine-precision oracle, sim_fdtd.py:587-620) is
available as an on-device variant of the step that materialises the Laplacian
and carries the accumulators through the scan.
"""

from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from pffdtd_jax.engine.coeffs import FP32_EPS, MatCoeffs, SchemeCoeffs
from pffdtd_jax.engine.numpy_ref import abc_q_grid
from pffdtd_jax.io.h5 import MMb, SimFolder
from pffdtd_jax.voxelizer.vox import CART_VECTORS, FCC_VECTORS


# --------------------------------------------------------------------- prep
@dataclass
class GridSpec:
    """Static geometry of the (optionally z-padded) grid."""

    Nx: int      # x extent
    Ny: int      # y extent
    Nz: int      # true z extent
    Nzp: int     # padded z extent (== Nz unless pad_z is given)
    fcc_flag: int

    @property
    def shape(self):
        return (self.Nx, self.Ny, self.Nzp)

    @property
    def folded(self):
        return self.fcc_flag == 2


def _remap_indices(ixyz, Nz, Nzp):
    """Linear indices from the file layout (Nz) to the z-padded layout."""
    ixyz = np.asarray(ixyz, np.int64)
    return (ixyz // Nz) * Nzp + ixyz % Nz


class EngineData:
    """Host-side preparation of all static arrays the step function needs."""

    def __init__(self, consts, vox, comms, mats, dtype=np.float32,
                 pad_z: int | None = None, fp32_eps: float | None = None):
        self.dtype = np.dtype(dtype)
        if fp32_eps is None:
            fp32_eps = FP32_EPS if self.dtype == np.float32 else 0.0
        self.fcc = consts.fcc_flag > 0
        self.sc = SchemeCoeffs.make(consts.l, consts.l2, self.fcc, eps=fp32_eps)
        self.mc = MatCoeffs.from_mats(mats, consts.Ts)
        self.consts = consts

        Nx, Ny, Nz = vox.Nx, vox.Ny, vox.Nz
        Nzp = int(-(-Nz // pad_z) * pad_z) if pad_z else Nz
        self.grid = GridSpec(Nx=Nx, Ny=Ny, Nz=Nz, Nzp=Nzp,
                             fcc_flag=int(consts.fcc_flag))

        VV = (FCC_VECTORS if self.fcc else CART_VECTORS).astype(np.int64)
        self.NN = VV.shape[0]
        strides = VV @ np.array([Ny * Nzp, Nzp, 1])

        # rigid-boundary correction data: neighbour indices + cut masks
        bn = _remap_indices(vox.bn_ixyz, Nz, Nzp)
        cut = ~vox.adj_bn  # (Nb, NN)
        self.bn_ixyz = bn
        self.bn_nbr = bn[:, None] + strides[None, :]
        self.bn_cut = cut.astype(self.dtype)
        self.bn_ncut = cut.sum(-1).astype(self.dtype)
        self.Nb = int(bn.size)

        # dense bit-packed adjacency grid: the uniform masked stencil makes
        # rigid-boundary handling branch-free and removes all sparse work for
        # it (alternative to the reference's separate boundary kernel,
        # gpu_engine.h:288-348); air nodes carry the all-ones mask
        adt = np.uint16 if self.NN == 12 else np.uint8
        full_mask = adt((1 << self.NN) - 1)
        adj_grid = np.full(self.grid.shape, full_mask, adt)
        packed = np.zeros(bn.shape[0], adt)
        for k in range(self.NN):
            packed |= (vox.adj_bn[:, k].astype(adt) << adt(k))
        adj_grid.reshape(-1)[bn] = packed
        self.adj_grid = adj_grid

        # lossy boundary subset
        lossy = vox.mat_bn > -1
        self.Nbl = int(lossy.sum())
        self.bnl_ixyz = _remap_indices(vox.bn_ixyz[lossy], Nz, Nzp)
        saf = vox.saf_bn[lossy]
        ssaf = saf * (0.5 / np.sqrt(2.0)) if self.fcc else saf
        self.ssaf_bnl = ssaf.astype(self.dtype)
        rows = self.mc.gather(vox.mat_bn[lossy])
        self.mat_rows = {k: rows[k].astype(self.dtype)
                         for k in ("b", "bd", "bDh", "bFh", "beta")}
        self.mat_rows_f64 = {k: rows[k] for k in ("D", "E", "F")}

        # sources / receivers
        self.in_ixyz = _remap_indices(comms.in_ixyz, Nz, Nzp)
        self.out_ixyz = _remap_indices(comms.out_ixyz, Nz, Nzp)
        self.in_sigs = np.asarray(comms.in_sigs, np.float64)  # (Ns, Nt)
        self.Nt = int(comms.Nt)
        self.out_reorder = comms.out_reorder

        # input scaling to the middle of the floating-point exponent range
        # (fdtd_data.h:878-909); applied for fp32, identity for fp64
        if self.dtype == np.float32:
            max_in = np.abs(self.in_sigs).max()
            pow2 = int(round(0.5 * (np.finfo(np.float32).maxexp
                                    + np.finfo(np.float32).minexp)))
            self.infac = max_in / 2.0 ** pow2 if max_in > 0 else 1.0
        else:
            self.infac = 1.0


# --------------------------------------------------------------------- step
def _flip_halos(u, g: GridSpec):
    """Mirror the outermost layers (ABC ghost feed) + FCC fold ghost row."""
    Nz = g.Nz
    u = u.at[:, :, 0].set(u[:, :, 2])
    u = u.at[:, :, Nz - 1].set(u[:, :, Nz - 3])
    u = u.at[:, 0, :].set(u[:, 2, :])
    if g.folded:
        u = u.at[:, g.Ny - 1, :].set(u[:, g.Ny - 2, :])
    else:
        u = u.at[:, g.Ny - 1, :].set(u[:, g.Ny - 3, :])
    u = u.at[0, :, :].set(u[2, :, :])
    u = u.at[g.Nx - 1, :, :].set(u[g.Nx - 3, :, :])
    return u


def _neighbor_sum(u, g: GridSpec, VV):
    """Sum of u over all stencil neighbours, on the interior region."""
    Nx, Ny, Nz = g.Nx, g.Ny, g.Nz
    acc = None
    for dx, dy, dz in VV:
        s = u[1 + dx:Nx - 1 + dx, 1 + dy:Ny - 1 + dy, 1 + dz:Nz - 1 + dz]
        acc = s if acc is None else acc + s
    return acc


def _abc_regions(g: GridSpec):
    """Disjoint (slices, Q) regions: 6 face interiors, 12 edges, 8 corners.

    With a folded-FCC grid the high-y layer is the fold ghost, not an ABC.
    """
    Nx, Ny, Nz = g.Nx, g.Ny, g.Nz
    ext = {0: [1, Nx - 2], 1: ([1] if g.folded else [1, Ny - 2]),
           2: [1, Nz - 2]}
    # "mid" = interior layers that are NOT extreme along that dim; on a folded
    # grid the only y extreme is y=1, so mid-y runs up to the fold ghost
    mid = {0: slice(2, Nx - 2),
           1: slice(2, Ny - 1) if g.folded else slice(2, Ny - 2),
           2: slice(2, Nz - 2)}
    regions = []
    for dims in itertools.chain.from_iterable(
            itertools.combinations((0, 1, 2), r) for r in (1, 2, 3)):
        Q = len(dims)
        choices = [ext[d] if d in dims else [mid[d]] for d in (0, 1, 2)]
        for combo in itertools.product(*choices):
            regions.append((tuple(combo), Q))
    return regions


def build_step(data: EngineData, energy: bool = False, rigid: str = "dense"):
    """Build the jittable step(carry, sig_n, consts) -> (carry, y) function.

    rigid: 'dense' uses the bit-packed adjacency grid (uniform masked
    stencil, no sparse rigid work); 'sparse' uses the dense-stencil +
    per-node correction formulation.  Returns (step, consts).
    """
    if rigid not in ("dense", "sparse"):
        raise ValueError(f"rigid must be 'dense' or 'sparse', got {rigid!r}")
    g = data.grid
    sc = data.sc
    dtype = data.dtype
    VV = (FCC_VECTORS if data.fcc else CART_VECTORS).astype(np.int64)
    interior = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))

    a1 = dtype.type(sc.a1)
    a2 = dtype.type(sc.a2)
    sl2 = dtype.type(sc.sl2)
    l2 = dtype.type(sc.l2)
    l = dtype.type(sc.l)
    lo2 = dtype.type(sc.lo2)
    lfac = dtype.type(sc.lfac)
    Kfull = dtype.type(sc.K)
    two = dtype.type(2.0)

    # large static arrays travel as explicit inputs through the jit/scan (a
    # closure-captured device array would be embedded into the compiled
    # program as a constant); only what the chosen configuration reads goes
    # in, since every entry is uploaded to the device
    consts = {
        "in_ixyz": np.asarray(data.in_ixyz),
        "out_ixyz": np.asarray(data.out_ixyz),
    }
    if rigid == "sparse" or energy:
        consts.update({
            "bn": np.asarray(data.bn_ixyz),
            "bn_nbr": np.asarray(data.bn_nbr),
            "bn_cut": np.asarray(data.bn_cut),
            "bn_ncut": np.asarray(data.bn_ncut),
        })
    if rigid == "dense":
        consts["adj_grid"] = data.adj_grid
    if data.Nbl:
        consts.update({
            "bnl": np.asarray(data.bnl_ixyz),
            "ssaf": np.asarray(data.ssaf_bnl),
            "mrows": {k: np.asarray(v) for k, v in data.mat_rows.items()},
        })
    abc_regions = _abc_regions(g)

    if energy:
        # raw DEF rows and constants for the energy functionals
        V_fac = dtype.type(2.0 if data.fcc else 1.0)
        e_h = dtype.type(data.consts.h)
        e_c = dtype.type(data.consts.c)
        e_Ts = dtype.type(data.consts.Ts)
        Qg = abc_q_grid(g.Nx, g.Ny, g.Nz, folded_y=g.folded)
        Qg = np.pad(Qg, ((0, 0), (0, 0), (0, g.Nzp - g.Nz)))
        consts.update({
            "e_D": data.mat_rows_f64["D"].astype(dtype),
            "e_E": data.mat_rows_f64["E"].astype(dtype),
            "e_F": data.mat_rows_f64["F"].astype(dtype),
            "e_Q": Qg.astype(dtype),
            "e_V": (2.0 ** -Qg.astype(np.float64)).astype(dtype),
            "e_absmask": (Qg > 0).astype(dtype),
        })

    def _step_core(u0, u1, vh1, gh1, sig_n, C):
        """Shared update; returns (unew, u1f, vh0, gh_new, out_n)."""
        u1f = _flip_halos(u1, g)

        if rigid == "dense":
            # uniform adjacency-masked stencil: one branch-free pass handles
            # air AND rigid-boundary nodes (K and the legs come from bits)
            a = C["adj_grid"][interior]
            acc = None
            K = None
            for k, (dx, dy, dz) in enumerate(VV):
                bit = ((a >> k) & 1).astype(dtype)
                s = u1f[1 + dx:g.Nx - 1 + dx, 1 + dy:g.Ny - 1 + dy,
                        1 + dz:g.Nz - 1 + dz]
                t = bit * s
                acc = t if acc is None else acc + t
                K = bit if K is None else K + bit
            unew_int = (two - sl2 * K) * u1f[interior] - u0[interior] + a2 * acc
            unew = u0.at[interior].set(unew_int)
            unew_f = unew.reshape(-1)
        else:
            nsum = _neighbor_sum(u1f, g, VV)
            unew_int = a1 * u1f[interior] - u0[interior] + a2 * nsum
            unew = u0.at[interior].set(unew_int)
            unew_f = unew.reshape(-1)
            if data.Nb:
                # rigid-boundary correction: remove cut legs, fix diagonal
                u1_flat = u1f.reshape(-1)
                cut_nbrs = u1_flat[C["bn_nbr"]]       # (Nb, NN)
                cutsum = jnp.sum(C["bn_cut"] * cut_nbrs, -1)
                delta = sl2 * C["bn_ncut"] * u1_flat[C["bn"]] - a2 * cutsum
                unew_f = unew_f.at[C["bn"]].add(delta)

        vh0 = vh1
        gh_new = gh1
        if data.Nbl:
            bnl, ssaf, mrows = C["bnl"], C["ssaf"], C["mrows"]
            u2b = u0.reshape(-1)[bnl]
            ub = unew_f[bnl]
            lo2Kbg = lo2 * ssaf * mrows["beta"]
            ub = ub - l * ssaf * jnp.sum(
                2.0 * mrows["bDh"] * vh1 - mrows["bFh"] * gh1, -1)
            ub = (ub + lo2Kbg * u2b) / (1.0 + lo2Kbg)
            unew_f = unew_f.at[bnl].set(ub)
            vh0 = (mrows["b"] * (ub - u2b)[:, None] + mrows["bd"] * vh1
                   - 2.0 * mrows["bFh"] * gh1)
            gh_new = gh1 + 0.5 * (vh0 + vh1)

        unew = unew_f.reshape(g.shape)

        # ABCs: disjoint uniform-Q regions, fed by pre-update u0 values
        for sl, Q in abc_regions:
            lQ = dtype.type(sc.l * Q)
            unew = unew.at[sl].set((unew[sl] + lQ * u0[sl]) / (1.0 + lQ))

        # source injection / receiver readout
        unew_f = unew.reshape(-1)
        unew_f = unew_f.at[C["in_ixyz"]].add(sig_n.astype(dtype))
        unew = unew_f.reshape(g.shape)
        out_n = u1f.reshape(-1)[C["out_ixyz"]]
        return unew, u1f, vh0, gh_new, out_n

    if not energy:

        def step(carry, sig_n, C):
            u0, u1, vh1, gh1 = carry
            unew, u1f, vh0, gh_new, out_n = _step_core(
                u0, u1, vh1, gh1, sig_n, C)
            return (u1f, unew, vh0, gh_new), out_n

        return step, consts

    def step_energy(carry, sig_n, C):
        """Energy-instrumented step: carries L(u^{n-1}) and the accumulators."""
        u0, u1, vh1, gh1, Lu_prev, E_lost, E_in = carry

        # --- H_tot[n] from u^n (=u1), u^{n-1} (=u0), L u^{n-1} (=Lu_prev)
        du = (u1 - u0)[interior]
        core = du * du / l2 - (u1 * Lu_prev)[interior]
        H = V_fac * 0.5 * e_h * jnp.sum(core)
        corr = (1.0 - C["e_V"]) * ((u1 - u0) ** 2 / l2 - u1 * Lu_prev) * C["e_absmask"]
        H = H - V_fac * 0.5 * e_h * jnp.sum(corr)
        if data.Nbl:
            H = H + V_fac * 0.5 * e_c / l2 * jnp.sum(
                C["ssaf"][:, None] * (vh1 ** 2 * C["e_D"]
                                      + (e_Ts * gh1) ** 2 * C["e_F"]))
        u2in = u0.reshape(-1)[C["in_ixyz"]]

        unew, u1f, vh0, gh_new, out_n = _step_core(
            u0, u1, vh1, gh1, sig_n, C)

        # --- store L(u^n) for the next step's H (recomputed to match the
        # oracle's split formulation: lfac * (nsum - K*u1))
        nsum = _neighbor_sum(u1f, g, VV)
        Lu_int = lfac * (nsum - Kfull * u1f[interior])
        Lu = jnp.zeros(g.shape, dtype).at[interior].set(Lu_int)
        if data.Nb:
            # masked Lu = dense Lu + lfac*(ncut*u1 - cut-leg sum)
            u1_flat = u1f.reshape(-1)
            cutsum = jnp.sum(C["bn_cut"] * u1_flat[C["bn_nbr"]], -1)
            deltaL = lfac * (C["bn_ncut"] * u1_flat[C["bn"]] - cutsum)
            Lu = Lu.reshape(-1).at[C["bn"]].add(deltaL).reshape(g.shape)

        # --- losses and input energy
        if data.Nbl:
            E_lost = E_lost + V_fac * 0.25 * e_h / l * jnp.sum(
                C["ssaf"][:, None] * ((vh0 + vh1) ** 2 * C["e_E"]))
        E_lost = E_lost + 0.5 * V_fac * e_h / l * jnp.sum(
            (C["e_V"] * C["e_Q"]) * (unew - u0) ** 2 * C["e_absmask"])
        E_in = E_in + (V_fac * e_h / l2) * 0.5 * jnp.sum(
            (unew.reshape(-1)[C["in_ixyz"]] - u2in) * sig_n.astype(dtype))

        return ((u1f, unew, vh0, gh_new, Lu, E_lost, E_in),
                (out_n, H, E_lost, E_in))

    return step_energy, consts


# ------------------------------------------------------------------- runner
class JaxEngine:
    """Single-device engine: jitted scan over the full simulation.

    For the multi-device slab-decomposed engine see
    pffdtd_jax.parallel.sharded_engine.
    """

    def __init__(self, folder=None, *, consts=None, vox=None, comms=None,
                 mats=None, dtype=np.float32, energy_on=False,
                 pad_z: int | None = None, fp32_eps: float | None = None,
                 rigid: str = "dense"):
        if np.dtype(dtype) == np.float64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "dtype=float64 needs jax_enable_x64; call "
                "jax.config.update('jax_enable_x64', True) first (without "
                "it every array would silently compute in float32)")
        if folder is not None:
            sf = SimFolder(folder)
            consts, vox, comms, mats = sf.consts, sf.vox, sf.comms, sf.mats
        from pffdtd_jax.utils import enable_compilation_cache

        enable_compilation_cache()
        self.data = EngineData(consts, vox, comms, mats, dtype=dtype,
                               pad_z=pad_z, fp32_eps=fp32_eps)
        self.energy_on = energy_on
        self._folder = folder
        self.Nt = self.data.Nt
        step, step_consts = build_step(self.data, energy=energy_on,
                                       rigid=rigid)
        # device-resident once: repeated run() calls must not re-upload
        self._step_consts = jax.tree.map(jnp.asarray, step_consts)

        # two steps per scan iteration: the leapfrog rotates (u0, u1) ->
        # (u1, unew), and a while-loop carry slot must reuse its own buffer,
        # so a single-step body forces XLA to COPY the full grid (u1 -> slot
        # 0) every step.  After an even number of steps each field is back
        # in its original slot and the copy vanishes.
        @functools.partial(jax.jit, donate_argnums=(0,))
        def run_scan(carry, sigs_T, C):
            def body(c, x):
                return step(c, x, C)

            n = sigs_T.shape[0]
            if n % 2:  # callers pad; safety net for direct calls
                return jax.lax.scan(body, carry, sigs_T)

            def body2(c, x2):
                c, y0 = body(c, x2[0])
                c, y1 = body(c, x2[1])
                return c, jax.tree.map(
                    lambda a, b: jnp.stack((a, b)), y0, y1)

            carry, ys = jax.lax.scan(body2, carry,
                                     sigs_T.reshape(n // 2, 2,
                                                    *sigs_T.shape[1:]))
            return carry, jax.tree.map(
                lambda a: a.reshape(-1, *a.shape[2:]), ys)

        self._run_scan = run_scan
        self._compiled = {}       # scan length -> compiled executable
        self.compile_seconds = 0.0
        self.compiled = None      # the most recently compiled scan

    def init_carry(self):
        d = self.data
        g = d.grid
        u0 = jnp.zeros(g.shape, d.dtype)
        u1 = jnp.zeros(g.shape, d.dtype)  # distinct buffers (donation)
        vh = jnp.zeros((d.Nbl, MMb), d.dtype)
        gh = jnp.zeros((d.Nbl, MMb), d.dtype)
        if self.energy_on:
            return (u0, u1, vh, gh, jnp.zeros(g.shape, d.dtype),
                    jnp.zeros((), d.dtype), jnp.zeros((), d.dtype))
        return (u0, u1, vh, gh)

    def _scan_fn(self, carry, sigs):
        """The compiled scan for this chunk length (compiled once, timed)."""
        fn = self._compiled.get(sigs.shape)
        if fn is None:
            t0 = time.perf_counter()
            fn = self._run_scan.lower(carry, sigs, self._step_consts).compile()
            self.compile_seconds += time.perf_counter() - t0
            self._compiled[sigs.shape] = fn
            self.compiled = fn
        return fn

    def run(self, nt: int | None = None, verbose: bool = True,
            chunk: int | None = None, checkpoint_every: int | None = None,
            checkpoint_path=None, resume: bool = False, on_chunk=None):
        """Run the simulation; returns u_out (Nr, Nt) in float64.

        chunk: run the scan in blocks of this many steps, printing a live
        progress line per block (the reference's print_progress dashboard,
        fdtd_common.h:106-190, reports the same total/instantaneous MVPS).
        on_chunk: callable(step, carry) invoked after every chunk (e.g. a
        viz.LiveSliceView for the reference's run_plot live view).
        checkpoint_every/checkpoint_path: save the full wavefield state
        (u0,u1,vh,gh + step counter) every N blocks; resume=True restarts
        from the latest checkpoint — the reference has NO mid-simulation
        checkpointing (SURVEY §5), a killed run restarts from t=0.
        elapsed/mvps exclude compilation, which is timed separately in
        compile_seconds.
        """
        d = self.data
        nt = self.Nt if nt is None else nt
        sigs_all = (d.in_sigs[:, :nt] / d.infac).T.astype(d.dtype)  # (Nt, Ns)

        n0 = 0
        carry = self.init_carry()
        ys_parts = []
        if resume and checkpoint_path and Path(checkpoint_path).exists():
            carry, n0, ys_prev = self._load_checkpoint(checkpoint_path)
            ys_parts.append(ys_prev)
            if verbose:
                print(f"--ENGINE(jax): resumed at step {n0}")

        chunk = chunk or (nt - n0)
        chunk = -(-chunk // 2) * 2  # keep chunk boundaries pair-aligned
        g = d.grid
        npts = g.Nx * g.Ny * g.Nz
        run_s = 0.0
        n = n0
        blocks = 0
        while n < nt:
            m = min(chunk, nt - n)
            sl = sigs_all[n:n + m]
            if m % 2:  # final partial chunk: zero-input pad step, trimmed
                sl = np.concatenate([sl, np.zeros((1, sl.shape[1]), sl.dtype)])
            sl = jnp.asarray(sl)
            fn = self._scan_fn(carry, sl)
            tb = time.perf_counter()
            carry, ys = fn(carry, sl, self._step_consts)
            ys = jax.tree.map(
                lambda a: np.asarray(jax.block_until_ready(a))[:m], ys)
            dt_b = time.perf_counter() - tb
            run_s += dt_b
            ys_parts.append(ys)
            n += m
            blocks += 1
            if on_chunk is not None:
                on_chunk(n, carry)
            if verbose and n < nt:
                inst = npts * m / dt_b / 1e6
                tot = npts * (n - n0) / run_s / 1e6
                eta = (nt - n) * run_s / max(n - n0, 1)
                print(f"--ENGINE(jax): {n}/{nt} "
                      f"[{100 * n / nt:.0f}%] {inst:.1f} MVPS inst, "
                      f"{tot:.1f} MVPS avg, ETA {eta:.1f}s", flush=True)
            if (checkpoint_every and checkpoint_path
                    and blocks % checkpoint_every == 0):
                self._save_checkpoint(checkpoint_path, carry, n, ys_parts)

        ys = jax.tree.map(lambda *a: np.concatenate(a, axis=0), *ys_parts)
        if self.energy_on:
            out_T, H, E_lost, E_in = ys
            self.H_tot = np.float64(H) * d.infac ** 2
            self.E_lost = np.float64(E_lost) * d.infac ** 2
            self.E_in = np.float64(E_in) * d.infac ** 2
        else:
            out_T = ys
        self.u_out = np.float64(out_T.T) * d.infac

        self.elapsed = run_s
        self.mvps = npts * (nt - n0) / self.elapsed / 1e6
        if verbose:
            print(f"--ENGINE(jax): {nt - n0} steps over {npts / 1e6:.2f} "
                  f"Mvox in {self.elapsed:.3f}s -> {self.mvps:.1f} MVPS "
                  f"(compile {self.compile_seconds:.1f}s)")
        return self.u_out

    # ------------------------------------------------------- checkpointing
    def _save_checkpoint(self, path, carry, n, ys_parts):
        ys = jax.tree.map(lambda *a: np.concatenate(a, axis=0), *ys_parts)
        cflat, _ = jax.tree.flatten(carry)
        flat = {f"carry{i}": np.asarray(c) for i, c in enumerate(cflat)}
        yflat, _ = jax.tree.flatten(ys)
        flat.update({f"ys{i:02d}": np.asarray(y) for i, y in enumerate(yflat)})
        np.savez(path, n=n, **flat)

    def _load_checkpoint(self, path):
        z = np.load(path)
        _, ctree = jax.tree.flatten(self.init_carry())
        nc = ctree.num_leaves
        carry = jax.tree.unflatten(
            ctree, [jnp.asarray(z[f"carry{i}"]) for i in range(nc)])
        ys_keys = sorted(k for k in z.files if k.startswith("ys"))
        ys = tuple(z[k] for k in ys_keys)
        if len(ys) == 1:
            ys = ys[0]
        return carry, int(z["n"]), ys

    def energy_balance(self):
        from pffdtd_jax.utils import rel_diff

        assert self.energy_on
        # scan outputs are post-step accumulations; H_tot[n] pairs with the
        # PRE-step accumulations (oracle indexing), hence the shift
        e_in = np.r_[0.0, self.E_in[:-1]]
        e_lost = np.r_[0.0, self.E_lost[:-1]]
        live = e_in > 0
        return rel_diff((self.H_tot + e_lost)[live], e_in[live])

    def save_outputs(self, folder=None):
        from pffdtd_jax.io.h5 import write_outputs

        folder = folder or self._folder
        write_outputs(folder, self.u_out, self.data.out_reorder)

    def print_last_samples(self, Np=5):
        ro = self.data.out_reorder
        for i in range(self.u_out.shape[0]):
            print(f"--ENGINE(jax): out {i}")
            for n in range(self.Nt - Np, self.Nt):
                print(f"--ENGINE(jax): sample {n}: {self.u_out[ro[i], n]:.16e}")
