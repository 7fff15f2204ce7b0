"""Benchmark: fp32 voxel-update throughput (MVPS) on the attached GPU.

Mirrors the reference's benchmark methodology (benchmarks/README.md): the
Musikverein hall, 11-branch RLC materials on every surface, impulse + diff
source, single precision, FCC at 5.6 PPW, MVPS = Npts * Nsamples / runtime /
1e6.  The published rate to compare with is the best per-GPU figure,
52512.6 MVPS on A100-40GB (pffdtd_benchmarks.csv:44), measured on exactly
this config.

How it runs:
- Every item runs in its OWN child process (BENCH_CHILD=<name>), one at a
  time, and the parent never imports JAX: a JAX process reserves most of a
  card's memory when it starts, so only one process may hold the card.  A
  crashed or hung item cannot take finished work down with it.
- The child refuses to run without a GPU: no number here comes from a CPU.
- The current result JSON line is re-printed (flushed) after EVERY
  completed item, so a hard kill still leaves the latest complete state in
  the output tail.  It names the card (device_kind, count) and its power
  limit (nvidia-smi), since a card set below 700 W runs slower.
- A wall-clock budget (env BENCH_BUDGET_S, default 3300 s) gates every
  secondary: items whose rough cost estimate exceeds the remaining budget
  are skipped with a note.  The headline always runs first.
- Timed runs are best-of-3 after a compile + warm-up run; compile time is
  reported separately.
- The exit code is non-zero when any item that ran failed, or when the
  budget alarm or SIGTERM cut the run.

Env knobs:
  BENCH_BUDGET_S    wall-clock budget in seconds (default 3300)
  BENCH_ONLY=a,b    run only the named items (headline always runs)
  BENCH_SKIP=a,b    skip the named items
  BENCH_NT, BENCH_H, BENCH_LX/LY/LZ  size overrides
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

T0 = time.perf_counter()
BUDGET = float(os.environ.get("BENCH_BUDGET_S", "3300"))
BASELINE_MVPS = 52512.6  # 2x A100-40GB per-GPU rate, FCC fmax=6.5kHz, lossy

# 11-branch material (reference benchmark condition: "11 RLC branches per
# material", benchmarks/README.md:8); magnitudes in the range of the fitted
# reference materials (data/materials/*.h5)
DEF11 = np.array([[d, e, f] for d, e, f in zip(
    np.geomspace(0.4, 40.0, 11),
    np.geomspace(2.0, 80.0, 11),
    np.geomspace(20.0, 2.0e5, 11))])

# the headline hall (125 Mvox folded FCC at h=0.046) and the billion-voxel
# FCC hall, as (Lx, Ly, Lz) in metres
H = 0.046
HEADLINE_DIMS = (36.0, 28.0, 23.0)
DIMS_1E9 = (108.0, 34.0, 28.0)

STATE = {"metric": "voxel_update_rate_fp32_fcc_lossy", "value": None,
         "headline": None, "secondary": {}, "device": None, "failed": []}


def elapsed():
    return time.perf_counter() - T0


def remaining():
    return BUDGET - elapsed()


def power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    return out.strip()


def emit():
    """Print the CURRENT full result JSON line (flushed).  Called after
    every completed item so a timeout can never erase finished work."""
    out = {
        "metric": STATE["metric"],
        "value": (round(STATE["headline"], 1)
                  if STATE["headline"] is not None else None),
        "unit": "Mvox/s",
        "vs_baseline": (round(STATE["headline"] / BASELINE_MVPS, 4)
                        if STATE["headline"] is not None else None),
        "elapsed_s": round(elapsed(), 1),
        "device": STATE["device"],
        "power_limit": STATE.get("power_limit"),
        # significant-figure rounding: round(v, 4) would crush small
        # error metrics to 0.0
        "secondary": {k: (round(v, 4) if abs(v) >= 1e-3
                          else float(f"{v:.3g}"))
                      for k, v in STATE["secondary"].items()},
        "failed": STATE["failed"],
    }
    print(json.dumps(out), flush=True)
    try:
        with open("BENCH_PARTIAL.json", "w") as f:
            json.dump(out, f)
    except OSError:
        pass


_CHILD = None   # the live per-item subprocess, killed on deadline


def _on_deadline(signum, frame):  # noqa: ARG001
    print(f"  [bench] signal {signum} at {elapsed():.0f}s — dumping state",
          file=sys.stderr, flush=True)
    if _CHILD is not None:
        try:
            _CHILD.kill()
        except OSError:
            pass
    emit()
    os._exit(3)


def bench_sim(fcc, lossy, Lx, Ly, Lz, h, nt, Rxyz=None):
    """A synthetic box hall under the reference's benchmark conditions:
    impulse + diff source, 11-branch materials when lossy, and FCC run
    FOLDED (fcc_flag=2, benchmarks/README.md + gpu_engine.h:677)."""
    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.prep import fold_fcc_sim, rotate_sim, sort_sim

    sim = synthetic_box_sim(Lx, Ly, Lz, h=h, Nt=nt, fcc=fcc, lossy=lossy,
                            insig_type="impulse", DEF=DEF11 if lossy else None,
                            Rxyz=Rxyz)
    if fcc:
        sim = sort_sim(fold_fcc_sim(rotate_sim(sim)))
    return sim


def _timed(eng, nt):
    """Warm-up run (compiles), then best of 3 timed runs -> MVPS."""
    eng.run(nt=nt, verbose=False)
    print(f"  compile {eng.compile_seconds:.1f}s", file=sys.stderr,
          flush=True)
    best = 0.0
    for _ in range(3):
        eng.run(nt=nt, verbose=False)
        best = max(best, eng.mvps)
    assert np.isfinite(eng.u_out).all()
    return best


def run_synthetic(fcc: bool, lossy: bool, Lx, Ly, Lz, h, nt, tag=None):
    from pffdtd_jax.engine.jax_engine import JaxEngine

    t0 = time.perf_counter()
    sim = bench_sim(fcc, lossy, Lx, Ly, Lz, h, nt)
    t1 = time.perf_counter()
    g = sim.vox
    tag = tag or (f"{'fcc' if fcc else 'cart'}_"
                  f"{'lossy' if lossy else 'rigid'}")
    print(f"[{tag}] "
          f"setup {t1 - t0:.1f}s  grid {g.Nx}x{g.Ny}x{g.Nz} = "
          f"{g.Nx * g.Ny * g.Nz / 1e6:.1f} Mvox, Nb={g.Nb}",
          file=sys.stderr, flush=True)
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    return _timed(eng, nt)


def run_real_mv(nt, fmax=2000.0):
    """The actual Musikverein model from the reference mount (FCC, lossy).

    The (deterministic) voxelized + folded sim folder is cached on disk:
    setup costs ~5 min of host time per invocation otherwise."""
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.geometry.room import RoomGeo
    from pffdtd_jax.io.h5 import SimFolder
    from pffdtd_jax.prep import fold_fcc_sim, rotate_sim, sort_sim
    from pffdtd_jax.scene_setup import pack_mats, sim_setup_from_room

    REF = "/root/reference/data"
    MV_MATS = {"Floor": "mv_floor.h5", "Chairs": "mv_chairs.h5",
               "Plasterboard": "mv_plasterboard.h5", "Window": "mv_window.h5",
               "Wood": "mv_wood.h5"}
    t0 = time.perf_counter()
    cache = os.environ.get("BENCH_MV_CACHE", "/tmp/bench_mv_sim")
    if cache and os.path.exists(os.path.join(cache, "vox_out.h5")):
        from pffdtd_jax.scene_setup import SimData

        sf = SimFolder(cache)
        sim = SimData(consts=sf.consts, vox=sf.vox, comms=sf.comms,
                      mats=sf.mats)
        # re-run the orientation rule so a folder cached under an older
        # rule is re-oriented (a no-op when it already matches)
        rot = rotate_sim(sim)
        if rot is not sim:
            sim = sort_sim(rot)
    else:
        rg = RoomGeo(f"{REF}/models/Musikverein_ConcertHall/model_export.json")
        keep = [r for r in rg.Rxyz
                if np.linalg.norm(rg.tris_pre.cent - r, axis=-1).min() > 0.6]
        rg.Rxyz = np.asarray(keep if keep else rg.Sxyz[:1] + 2.0)
        mats = pack_mats(rg.mat_str, MV_MATS, f"{REF}/materials")
        sim = sim_setup_from_room(rg, mats,
                                  duration=max(nt, 256) * 1e-4,
                                  insig_type="impulse", diff_source=True,
                                  fmax=fmax, PPW=5.6, fcc_flag=True,
                                  check_adj=False)
        sim = sort_sim(fold_fcc_sim(rotate_sim(sim)))
        if cache:
            from pffdtd_jax.scene_setup import save_sim_data

            try:
                save_sim_data(sim, cache)
            except Exception as e:  # noqa: BLE001 - cache is best-effort
                print(f"  mv cache write failed: {e}", file=sys.stderr)
    g = sim.vox
    print(f"[mv_fcc_lossy] setup {time.perf_counter() - t0:.1f}s  grid "
          f"{g.Nx}x{g.Ny}x{g.Nz} = {g.Nx * g.Ny * g.Nz / 1e6:.1f} Mvox, "
          f"Nb={g.Nb}", file=sys.stderr, flush=True)
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    nt = min(nt, eng.Nt)
    return _timed(eng, nt)


def fp32_energy_drift(nsteps=50000, lossy=False):
    """Relative signal drift of an fp32 box over nsteps -
    production-RIR-length validation of the (1+EPS) diagonal-shift fp32
    discipline (fdtd_data.h:186-194).  The leapfrog is symplectic: bounded
    oscillation is stable; tail growth means the Laplacian lost negative
    semi-definiteness (the failure mode the reference's RTZ intrinsics
    guard against, fdtd_common.h:57-68).

    lossy=False: sealed rigid box (the pure-air + rigid-mask path).
    lossy=True: 11-branch impedance walls AND an open top venting into the
    Engquist-Majda ABCs - the full fp32 physics (boundary ODE + ABC) at
    production length.  Dissipation makes the tail decay; the check is
    that it does not GROW (drift ratio stays <= ~1)."""
    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine

    sim = synthetic_box_sim(4.0, 3.1, 2.6, h=0.04, Nt=nsteps, lossy=lossy,
                            insig_type="hann10", diff_source=False,
                            DEF=DEF11 if lossy else None, open_top=lossy)
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    eng.run(verbose=False, chunk=min(nsteps, 10000))
    u = eng.u_out[0]
    assert np.isfinite(u).all()
    # RMS of the tail vs the first reflections: growth => instability
    a = np.sqrt(np.mean(u[: nsteps // 4] ** 2))
    b = np.sqrt(np.mean(u[-nsteps // 4:] ** 2))
    return float(b / a)


def fp32_vs_fp64_rir_db(nsteps=8192):
    """Max spectral deviation (dB) of the fp32 RIR from the fp64 numpy
    oracle over the occupied band at production RIR length (the fp32
    stability claim needs an fp64-reference error figure, not just a
    self-referential drift ratio).  Occupied band = rfft bins within 60 dB
    of the fp64 peak."""
    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.engine.numpy_ref import NumpyEngine

    sim = synthetic_box_sim(3.0, 2.3, 2.0, h=0.045, Nt=nsteps, lossy=True,
                            insig_type="hann10", diff_source=False,
                            DEF=DEF11, open_top=True)
    o = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats)
    u64 = o.run_all()[0]
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    eng.run(nt=nsteps, verbose=False, chunk=min(nsteps, 8192))
    u32 = eng.u_out[0]
    H64 = np.fft.rfft(u64)
    H32 = np.fft.rfft(u32[:u64.size])
    m = np.abs(H64) > np.abs(H64).max() * 1e-3   # within 60 dB of peak
    return float(np.abs(20.0 * np.log10(
        np.abs(H32[m]) / np.abs(H64[m]))).max())


def energy_check(Lx, Ly, Lz, h, nt=512):
    """The plain fp32 step against the energy-instrumented fp32 step on
    the same scene: (a) the max receiver-sample relative difference and
    (b) the fp32 energy-balance residual (reference anchor:
    sim_fdtd.py:587-620).  nt must cover the source->receiver flight time
    (~380 steps at this h): a shorter run compares two all-zero RIRs, and
    the nonzero-RIR assert below keeps the metric honest."""
    from pffdtd_jax.engine.jax_engine import JaxEngine

    sim = bench_sim(True, True, Lx, Ly, Lz, h, nt)
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=np.float32)
    plain = JaxEngine(**kw)
    plain.run(nt=nt, verbose=False)
    en = JaxEngine(energy_on=True, **kw)
    en.run(nt=nt, verbose=False)
    assert np.abs(en.u_out).max() > 0, "vacuous: wave never reached a rx"
    scale = max(float(np.abs(en.u_out).max()), 1e-30)
    err = float(np.abs(plain.u_out - en.u_out).max()) / scale
    return err, float(np.abs(en.energy_balance()).max())


def sharded_d1(nt=64):
    """The slab-sharded engine on a one-device mesh against the
    single-device engine on the same scene: (mvps, err, frac), where frac
    = sharded rate / single-device rate isolates the shard_map wrapper's
    overhead (the reference degrades only 3-18% from 1 to 8 GPUs,
    BASELINE.md).  The single-device engine runs the same sparse-rigid
    formulation as the sharded step."""
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.parallel.sharded_engine import (make_mesh,
                                                    make_sharded_engine)

    sim = bench_sim(False, False, 21.0, 16.0, 12.6, 0.03, nt)
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=np.float32)
    jx = JaxEngine(rigid="sparse", **kw)
    jx.run(nt=nt, verbose=False)
    jx.run(nt=nt, verbose=False)
    sp = make_sharded_engine(mesh=make_mesh(1), **kw)
    sp.run(nt=nt, verbose=False)
    sp.run(nt=nt, verbose=False)
    err = float(np.abs(sp.u_out - jx.u_out).max()
                / max(np.abs(jx.u_out).max(), 1e-30))
    assert err < 1e-4, f"sharded D=1 mismatch: {err}"
    return sp.mvps, err, sp.mvps / jx.mvps


def build_items():
    """Ordered (name, est_cost_s, fn) table; fn() -> {metric: value}.

    '__headline__' is the headline key; everything else lands in
    `secondary`.  The cost estimates are rough guesses, not yet measured
    on the GPU; an estimate of 0 marks an item that cannot run here."""
    Lx = float(os.environ.get("BENCH_LX", HEADLINE_DIMS[0]))
    Ly = float(os.environ.get("BENCH_LY", HEADLINE_DIMS[1]))
    Lz = float(os.environ.get("BENCH_LZ", HEADLINE_DIMS[2]))
    h = float(os.environ.get("BENCH_H", H))
    nt = int(os.environ.get("BENCH_NT", "128"))
    have_ref = os.path.exists("/root/reference/data")
    return [
        ("fcc_lossy", 400, lambda: {
            "__headline__": run_synthetic(True, True, Lx, Ly, Lz, h, nt)}),
        ("mv_fcc_lossy", 850 if have_ref else 0,
         lambda: {"mv_fcc_lossy": run_real_mv(nt)}),
        ("sharded", 280, lambda: (lambda m, e, f: {
            "sharded_d1_mvps": m, "sharded_d1_vs_single_err": e,
            "sharded_d1_vs_single_frac": f})(*sharded_d1())),
        ("energy", 500, lambda: (lambda e, b: {
            "plain_vs_energy_step_err": e, "energy_balance_fp32": b})(
            *energy_check(28.0, 22.0, 18.0, h))),
        ("fp32_spectral", 280,
         lambda: {"fp32_vs_fp64_rir_max_db": fp32_vs_fp64_rir_db()}),
        # billion-voxel FCC LOSSY (the baseline's flagship regime is
        # 8.95e9 lossy FCC)
        ("fcc_lossy_1e9", 450, lambda: {
            "fcc_lossy_1e9": run_synthetic(True, True, *DIMS_1E9, h, nt,
                                           tag="fcc_lossy_1e9")}),
        ("fcc_rigid", 220, lambda: {
            "fcc_rigid": run_synthetic(True, False, Lx, Ly, Lz, h, nt)}),
        ("cart_rigid", 150, lambda: {
            "cart_rigid": run_synthetic(False, False, Lx, Ly, Lz, h, nt)}),
        ("cart_lossy", 400, lambda: {
            "cart_lossy": run_synthetic(False, True, Lx, Ly, Lz, h, nt)}),
        # ~1.1e9 rigid Cartesian voxels (u0+u1 fp32 ~9 GB)
        ("cart_rigid_1e9", 140, lambda: {
            "cart_rigid_1e9": run_synthetic(False, False, 150.0, 25.0,
                                            28.6, h, nt,
                                            tag="cart_rigid_1e9")}),
        ("fp32_drift", 140,
         lambda: {"fp32_tail_to_head_rms_50k": fp32_energy_drift()}),
        ("fp32_drift_lossy", 170, lambda: {
            "fp32_tail_to_head_rms_50k_lossy": fp32_energy_drift(
                lossy=True)}),
    ]


def child_main(name):
    """Run ONE item in this process and print its result as the last
    stdout line, with the device it ran on.  Refuses to run without a
    GPU: a CPU number must never be reported as a device number."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {dev.platform!r})")
    fn = {n: f for n, _, f in build_items()}[name]
    res = fn()
    res["__device__"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
    print("BENCH_RESULT " + json.dumps(res), flush=True)


def _run_child(name, timeout_s):
    """Spawn `BENCH_CHILD=name python bench.py`; returns its result dict
    or None.  stderr streams through; stdout is parsed for the result."""
    global _CHILD
    env = dict(os.environ, BENCH_CHILD=name)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)], env=env,
        stdout=subprocess.PIPE, text=True)
    _CHILD = proc
    try:
        out, _ = proc.communicate(timeout=max(timeout_s, 60))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        print(f"  {name} TIMED OUT after {timeout_s:.0f}s (killed)",
              file=sys.stderr, flush=True)
        return None
    finally:
        _CHILD = None
    res = None
    for line in out.splitlines():
        if line.startswith("BENCH_RESULT "):
            res = json.loads(line[len("BENCH_RESULT "):])
        else:   # engine chatter prints to stdout; forward it to the log
            print(f"  [{name}] {line}", file=sys.stderr, flush=True)
    if res is not None and proc.returncode == 0:
        STATE["device"] = res.pop("__device__")
        return res
    print(f"  {name} produced no result (rc={proc.returncode}); "
          f"stdout tail: {out[-300:]!r}", file=sys.stderr, flush=True)
    return None


def main():
    signal.signal(signal.SIGTERM, _on_deadline)
    signal.signal(signal.SIGALRM, _on_deadline)
    signal.alarm(max(int(BUDGET), 60))
    STATE["power_limit"] = power_limit()

    only = [s for s in os.environ.get("BENCH_ONLY", "").split(",") if s]
    skip = [s for s in os.environ.get("BENCH_SKIP", "").split(",") if s]
    items = build_items()

    # ---------------- headline: always runs, emitted the moment it exists
    res = _run_child("fcc_lossy", remaining() - 120)
    if res is None:
        STATE["failed"].append("fcc_lossy")
    STATE["headline"] = (res or {}).get("__headline__")
    emit()

    for name, est, _ in items:
        if name == "fcc_lossy":
            continue
        if only and name not in only:
            continue
        if name in skip or est == 0:
            continue
        if est > remaining():
            print(f"  [bench] SKIP {name}: est {est}s > remaining "
                  f"{remaining():.0f}s", file=sys.stderr, flush=True)
            continue
        t = time.perf_counter()
        # cap each item's timeout relative to its own estimate, so one
        # pathological item cannot starve every cheaper item behind it
        res = _run_child(name, min(remaining() - 30,
                                   max(3 * est, est + 600)))
        if res:
            STATE["secondary"].update(
                {k: v for k, v in res.items() if v is not None})
        else:
            STATE["failed"].append(name)
        print(f"  [bench] {name} took {time.perf_counter() - t:.0f}s, "
              f"remaining {remaining():.0f}s", file=sys.stderr, flush=True)
        emit()

    for k, v in STATE["secondary"].items():
        print(f"  secondary {k}: {v:.4g}", file=sys.stderr, flush=True)
    emit()
    return 1 if STATE["failed"] else 0


if __name__ == "__main__":
    child = os.environ.get("BENCH_CHILD")
    if child:
        child_main(child)
    else:
        sys.exit(main())
