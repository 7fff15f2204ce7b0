"""Smoke test of the FDTD engine on NVIDIA GPUs, through the entry points a
user calls.

    python chip_smoke.py           # one GPU: the four phases below
    python chip_smoke.py --multi   # four GPUs: the slab-sharded engine only

Everything runs in ONE process: a JAX process reserves most of a card's
memory when it starts, so a second process on the card would fail.

Phases on one GPU.  Each prints its result, compile seconds, ms/step, MVPS,
the compiled step's memory analysis and the process's device memory peak:

1. oracle: the canonical 2 x 3 x 2.5 m room, scene_setup -> sim folder ->
   `cli sim` (fp32) -> `cli process`.  Receiver traces must match the fp64
   NumPy oracle within 1e-4 of the trace maximum: fp32 against fp64, and on
   the GPU FMA contraction and scatter order also differ from the CPU.  The
   oracle runs the same (1+EPS) fp32 diagonal shift as the engine, a
   deliberate scheme change worth ~1.4e-4 by itself over this run; the
   error against the unshifted oracle is printed beside it.
2. headline: bench.py's 125-Mvox folded-FCC lossy hall.  The plain fp32
   step against the energy-instrumented fp32 step over 512 steps in one
   dispatch (long enough for the wave to reach the receivers), the fp32
   energy-balance residual, and ms/step with z unpadded and padded to 128.
3. full width: bench.py's fcc_lossy_1e9 scene (1.03 Gvox, folded FCC,
   11-branch materials) through JaxEngine.run for 128 steps.  Every
   receiver sample finite, the trace not all zeros (one receiver sits 1 m
   from the source), and the effective GB/s beside a plain device copy
   measured in the same process.
4. fp64: the oracle's folder through `cli sim --f64 --energy`.  The energy
   balance residual must be < 1e-10.  Runs last: it switches JAX to 64 bit.

The step has no matrix product, so TF32 cannot enter any fp32 result.

Without a GPU the script exits non-zero at once.  Any failed check raises,
so the script exits non-zero before its last line, which on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ORACLE_TOL = 1e-4       # fp32 engine vs fp64 oracle, of the trace maximum
ENERGY_F64_TOL = 1e-10  # fp64 energy-balance residual (machine precision)
# plain vs energy-instrumented fp32 step: the same arithmetic in two
# programs, which XLA may fuse (and contract into FMAs) differently
STEP_VS_ENERGY_TOL = 1e-5
# fp32 energy balance: each step's energies are sums over ~1e8 voxels in
# fp32, whose rounding grows like sqrt(N) * eps ~ 1e4 * 6e-8 ~ 6e-4
ENERGY_F32_TOL = 1e-3
# sharded vs single-device fp32: same arithmetic, different programs
SHARDED_TOL = 1e-5
HEADLINE_NT = 512
FULL_NT = 128


def log(*a):
    print(*a, flush=True)


def bytes_per_voxel(fcc: bool) -> int:
    """HBM bytes one voxel update must move in fp32: u0 and u1 in, the
    adjacency bits in (2 bytes for FCC's 12 legs, 1 for Cartesian's 6),
    unew out."""
    return 4 + 4 + (2 if fcc else 1) + 4


def effective_gbps(npts: int, steps: int, seconds: float, fcc: bool) -> float:
    return npts * steps * bytes_per_voxel(fcc) / seconds / 1e9


def rel_err(u, ref) -> float:
    """Max |u - ref| relative to the reference trace maximum."""
    u, ref = np.asarray(u), np.asarray(ref)
    if u.shape != ref.shape:
        raise AssertionError(f"shape {u.shape} vs reference {ref.shape}")
    scale = float(np.abs(ref).max())
    if not scale > 0:
        raise AssertionError("reference trace is all zeros")
    return float(np.abs(u - ref).max()) / scale


def check_trace(u, tag):
    """Every receiver sample finite, and the trace not all zeros."""
    u = np.asarray(u)
    if not np.isfinite(u).all():
        raise AssertionError(f"{tag}: non-finite receiver samples")
    if not np.abs(u).max() > 0:
        raise AssertionError(f"{tag}: all-zero receiver trace")


def expect(ok, msg):
    if not ok:
        raise AssertionError(msg)
    log(f"  PASS {msg}")


def memory_report(compiled) -> dict:
    ma = compiled.memory_analysis() if compiled is not None else None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys} if ma is not None else {}


def report(tag, eng, nt):
    import jax

    g = eng.data.grid
    npts = g.Nx * g.Ny * g.Nz
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  [{tag}] grid {g.Nx}x{g.Ny}x{g.Nzp} ({npts / 1e6:.1f} Mvox), "
        f"compile {eng.compile_seconds:.2f}s, {nt} steps in "
        f"{eng.elapsed:.4f}s: {eng.elapsed / nt * 1e3:.4f} ms/step, "
        f"{eng.mvps:.1f} MVPS")
    log(f"  [{tag}] step memory_analysis {memory_report(eng.compiled)}")
    log(f"  [{tag}] peak_bytes_in_use (process so far) "
        f"{stats.get('peak_bytes_in_use')}")


def canonical_room_folder(folder):
    """The canonical verification room: 2 x 3 x 2.5 m, one 2-branch wall
    material, one source, one receiver, 0.02 s at h = 0.2 m."""
    from pffdtd_jax.geometry.room import RoomGeo
    from pffdtd_jax.scene_setup import mats_from_DEF_list, \
        sim_setup_from_room

    v = np.array([[0, 0, 0], [2, 0, 0], [0, 3, 0], [2, 3, 0],
                  [0, 0, 2.5], [2, 0, 2.5], [0, 3, 2.5], [2, 3, 2.5]], float)
    tris = np.array([(0, 4, 6), (0, 6, 2), (1, 3, 7), (1, 7, 5), (0, 1, 5),
                     (0, 5, 4), (2, 6, 7), (2, 7, 3), (0, 2, 3), (0, 3, 1),
                     (4, 5, 7), (4, 7, 6)])
    rg = RoomGeo.from_arrays(v, tris, np.zeros(12, np.int8),
                             np.ones(12, np.int8), ["walls"],
                             [[1.1, 1.8, 1.2]], [[0.6, 0.9, 1.0]])
    mats = mats_from_DEF_list([np.array([[2., 5., 30.], [1., 10., 300.]])])
    sim_setup_from_room(rg, mats, duration=0.02, insig_type="hann10",
                        h=0.2, save_folder=str(folder))
    return folder


def oracle_u(folder, fp32_eps=0.0):
    """fp64 NumPy oracle traces of a sim folder, in receiver order;
    fp32_eps applies the fp32 engine's diagonal shift to the scheme."""
    from pffdtd_jax.engine.numpy_ref import NumpyEngine

    ref = NumpyEngine(folder, fp32_eps=fp32_eps)
    ref.run_all()
    return ref.u_out[ref.comms.out_reorder]


def phase_oracle(folder):
    """`cli sim` in fp32 and `cli process` on the canonical room; returns
    (engine, relative error against the fp64 oracle with the same scheme
    shift, relative error against the unshifted fp64 oracle)."""
    from pffdtd_jax.cli import main as cli
    from pffdtd_jax.engine.coeffs import FP32_EPS
    from pffdtd_jax.io.h5 import read_outputs

    canonical_room_folder(folder)
    eng = cli(["sim", "--data_dir", str(folder)])
    u = read_outputs(folder)
    check_trace(u, "oracle")
    err = rel_err(u, oracle_u(folder, fp32_eps=FP32_EPS))
    err_unshifted = rel_err(u, oracle_u(folder))
    cli(["process", "--data_dir", str(folder), "--fcut_lowpass", "400"])
    if not (Path(folder) / "sim_outs_processed.h5").exists():
        raise AssertionError("cli process wrote no sim_outs_processed.h5")
    return eng, err, err_unshifted


def phase_fp64(folder):
    """`cli sim --f64 --energy` on an existing folder; returns (engine,
    max |energy balance|, relative error against the fp64 oracle)."""
    from pffdtd_jax.cli import main as cli
    from pffdtd_jax.io.h5 import read_outputs

    eng = cli(["sim", "--data_dir", str(folder), "--f64", "--energy"])
    if eng.data.dtype != np.float64:
        raise AssertionError(f"--f64 ran in {eng.data.dtype}")
    bal = float(np.abs(eng.energy_balance()).max())
    return eng, bal, rel_err(read_outputs(folder), oracle_u(folder))


def copy_gbps(n=1 << 28, reps=50, windows=3):
    """Device bandwidth of a large plain copy-and-scale (read + write of
    1 GiB), best of a few timed windows."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * np.float32(1.0000001))
    x = f(jnp.ones((n,), jnp.float32)).block_until_ready()
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            x = f(x)
        x.block_until_ready()
        best = max(best, 2 * 4 * n * reps / (time.perf_counter() - t0) / 1e9)
    return best


def log_gbps(tag, eng, nt, copy_rate):
    g = eng.data.grid
    gbps = effective_gbps(g.Nx * g.Ny * g.Nz, nt, eng.elapsed, eng.data.fcc)
    log(f"  [{tag}] effective {gbps:.1f} GB/s "
        f"({bytes_per_voxel(eng.data.fcc)} B/voxel) vs plain copy "
        f"{copy_rate:.1f} GB/s: {gbps / copy_rate:.3f} of the copy")


def phase_headline(copy_rate):
    from bench import H, HEADLINE_DIMS, bench_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine

    t0 = time.perf_counter()
    sim = bench_sim(True, True, *HEADLINE_DIMS, H, HEADLINE_NT)
    log(f"  [headline] setup {time.perf_counter() - t0:.1f}s")
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=np.float32)
    plain = JaxEngine(**kw)
    plain.run(nt=HEADLINE_NT, verbose=False)
    report("headline plain", plain, HEADLINE_NT)
    log_gbps("headline plain", plain, HEADLINE_NT, copy_rate)
    check_trace(plain.u_out, "headline plain")
    en = JaxEngine(energy_on=True, **kw)
    en.run(nt=HEADLINE_NT, verbose=False)   # one dispatch, no chunking
    report("headline energy", en, HEADLINE_NT)
    err = rel_err(plain.u_out, en.u_out)
    bal = float(np.abs(en.energy_balance()).max())
    expect(err <= STEP_VS_ENERGY_TOL,
           f"headline plain vs energy step rel err {err:.3e} <= "
           f"{STEP_VS_ENERGY_TOL:g}")
    expect(bal < ENERGY_F32_TOL,
           f"headline fp32 energy balance {bal:.3e} < {ENERGY_F32_TOL:g}")
    del en
    for pad_z in (None, 128):
        eng = plain if pad_z is None else JaxEngine(pad_z=pad_z, **kw)
        eng.run(nt=FULL_NT, verbose=False)
        eng.run(nt=FULL_NT, verbose=False)
        log(f"  [headline pad_z={pad_z}] Nzp={eng.data.grid.Nzp}: "
            f"{eng.elapsed / FULL_NT * 1e3:.4f} ms/step, "
            f"{eng.mvps:.1f} MVPS")


def phase_full_width(copy_rate):
    from bench import DIMS_1E9, H, bench_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine

    Lx, Ly, Lz = DIMS_1E9
    src = np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz])
    R = np.array([[0.25 * Lx, 0.3 * Ly, 0.4 * Lz],
                  [0.7 * Lx, 0.6 * Ly, 0.55 * Lz],
                  src + [1.0, 0.0, 0.0]])
    t0 = time.perf_counter()
    sim = bench_sim(True, True, Lx, Ly, Lz, H, FULL_NT, Rxyz=R)
    log(f"  [full width] setup {time.perf_counter() - t0:.1f}s, "
        f"Nb={sim.vox.Nb}")
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    del sim
    eng.run(nt=FULL_NT, verbose=False)
    first = eng.elapsed
    eng.run(nt=FULL_NT, verbose=False)
    log(f"  [full width] first run {first:.4f}s, second {eng.elapsed:.4f}s")
    report("full width", eng, FULL_NT)
    log_gbps("full width", eng, FULL_NT, copy_rate)
    check_trace(eng.u_out, "full width")
    log("  PASS full width: finite, non-zero receiver traces")


def run_single(folder):
    import jax

    from pffdtd_jax.utils import enable_compilation_cache

    enable_compilation_cache()
    rate = copy_gbps()
    log(f"[copy] plain device copy {rate:.1f} GB/s")

    log("[phase 1: oracle]")
    eng, err, err_unshifted = phase_oracle(folder)
    report("oracle", eng, eng.Nt)
    log(f"  [oracle] rel err vs the unshifted fp64 oracle {err_unshifted:.3e}")
    expect(err <= ORACLE_TOL,
           f"oracle: cli sim fp32 vs fp64 NumPy rel err {err:.3e} <= "
           f"{ORACLE_TOL:g}")

    log("[phase 2: headline]")
    phase_headline(rate)

    log("[phase 3: full width]")
    phase_full_width(rate)

    log("[phase 4: fp64]")
    eng, bal, err = phase_fp64(folder)
    report("fp64", eng, eng.Nt)
    log(f"  [fp64] rel err vs fp64 NumPy oracle {err:.3e}")
    expect(bal < ENERGY_F64_TOL,
           f"fp64 energy balance {bal:.3e} < {ENERGY_F64_TOL:g}")
    assert jax.config.jax_enable_x64


def run_multi(n=4):
    """ShardedEngine over make_mesh(n) on the headline scene against the
    single-GPU sparse-rigid engine on the same (x-padded) scene."""
    import jax

    from bench import H, HEADLINE_DIMS, bench_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.parallel.sharded_engine import (make_mesh,
                                                    make_sharded_engine)
    from pffdtd_jax.prep import pad_x
    from pffdtd_jax.utils import enable_compilation_cache

    enable_compilation_cache()
    if len(jax.devices()) < n:
        raise SystemExit(f"--multi needs {n} GPUs, found "
                         f"{len(jax.devices())}")
    log(f"[multi: {n} GPUs] {[d.device_kind for d in jax.devices()]}")
    sim = pad_x(bench_sim(True, True, *HEADLINE_DIMS, H, HEADLINE_NT), n,
                min_rows=4)
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=np.float32)
    single = JaxEngine(rigid="sparse", **kw)
    single.run(nt=HEADLINE_NT, verbose=False)
    single.run(nt=HEADLINE_NT, verbose=False)
    report("single GPU", single, HEADLINE_NT)
    check_trace(single.u_out, "single GPU")

    mesh = make_mesh(n)
    sh = make_sharded_engine(mesh=mesh, **kw)
    u0 = sh.init_state()[0]
    devs = {s.device for s in u0.addressable_shards}
    expect(len(devs) == n and sh.D == n,
           f"sharded state spans {len(devs)} devices: "
           f"{sorted(str(d) for d in devs)}")
    del u0
    sh.run(nt=HEADLINE_NT, verbose=False)
    sh.run(nt=HEADLINE_NT, verbose=False)
    g = sh.data.grid
    log(f"  [sharded x{n}] compile {sh.compile_seconds:.2f}s, "
        f"{HEADLINE_NT} steps in {sh.elapsed:.4f}s: "
        f"{sh.elapsed / HEADLINE_NT * 1e3:.4f} ms/step, {sh.mvps:.1f} MVPS "
        f"({g.Nx}x{g.Ny}x{g.Nzp}, {n}x{sh.S}-row slabs)")
    check_trace(sh.u_out, "sharded")
    err = rel_err(sh.u_out, single.u_out)
    log(f"  [multi] single {single.mvps:.1f} MVPS, sharded x{n} "
        f"{sh.mvps:.1f} MVPS ({sh.mvps / single.mvps:.3f}x)")
    expect(err <= SHARDED_TOL,
           f"sharded x{n} vs single GPU rel err {err:.3e} <= {SHARDED_TOL:g}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-GPU sharded engine check")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {dev.platform!r})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    for line in smi.strip().splitlines():
        log(f"[nvidia-smi] {line}")
    log(f"[jax] {jax.__version__}, {len(jax.devices())} x {dev.device_kind}")

    if args.multi:
        run_multi()
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            run_single(Path(d))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
