"""Command-line entry points.

The reference drives each stage with module CLIs (sim_fdtd.py:898-940,
process_outputs.py:299-358) plus compiled fdtd_main_{cpu,gpu}_{single,double}
executables run from the sim folder.  Here one CLI covers all stages:

    python -m pffdtd_jax.cli sim --data_dir DIR [--f64] [--energy] ...
    python -m pffdtd_jax.cli process --data_dir DIR ...
    python -m pffdtd_jax.cli prep --data_dir DIR [--rotate] [--fold] [--sort]
    python -m pffdtd_jax.cli fit-material --out mat.h5 --sabs a1,...,a11
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _cmd_sim(args):
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.engine.numpy_ref import NumpyEngine

    dtype = np.float64 if args.f64 else np.float32
    if args.engine == "numpy":
        eng = NumpyEngine(args.data_dir, energy_on=args.energy)
        eng.run_all()
        u_out = eng.u_out
        from pffdtd_jax.io.h5 import write_outputs

        write_outputs(args.data_dir, u_out, eng.comms.out_reorder)
        if args.energy:
            bal = eng.energy_balance()
            print(f"--ENGINE: max |energy balance| = "
                  f"{np.nanmax(np.abs(bal)):.3e}")
    else:
        if args.f64:
            import jax

            jax.config.update("jax_enable_x64", True)
        eng = JaxEngine(args.data_dir, dtype=dtype, energy_on=args.energy)
        on_chunk = None
        chunk = args.nsteps
        if args.plot:
            from pffdtd_jax.viz import LiveSliceView

            on_chunk = LiveSliceView(eng, show=args.show)
            chunk = chunk or max(1, eng.Nt // 60)
        eng.run(chunk=chunk,
                checkpoint_every=args.checkpoint_every or None,
                checkpoint_path=args.checkpoint, resume=args.resume,
                on_chunk=on_chunk)
        eng.save_outputs(args.data_dir)
        eng.print_last_samples(5)
        if args.energy:
            print(f"--ENGINE: max |energy balance| = "
                  f"{np.abs(eng.energy_balance()).max():.3e}")
    print(f"--ENGINE: wrote {Path(args.data_dir) / 'sim_outs.h5'}")
    return eng


def _cmd_process(args):
    from pffdtd_jax.analysis.process_outputs import main as process_main

    argv = ["--data_dir", args.data_dir,
            "--resample_Fs", str(args.resample_Fs),
            "--fcut_lowcut", str(args.fcut_lowcut),
            "--N_order_lowcut", str(args.N_order_lowcut),
            "--fcut_lowpass", str(args.fcut_lowpass),
            "--N_order_lowpass", str(args.N_order_lowpass),
            "--air_abs_filter", args.air_abs_filter]
    if args.symmetric_lowpass:
        argv.append("--symmetric_lowpass")
    if args.save_wav:
        argv.append("--save_wav")
    if args.plot:
        argv.append("--plot")
    if args.show:
        argv.append("--show")
    process_main(argv)


def _cmd_prep(args):
    from pffdtd_jax.prep import (fold_fcc_sim_data, rotate_sim_data,
                                 sort_sim_data)

    if args.rotate:
        rotate_sim_data(args.data_dir)
    if args.fold:
        fold_fcc_sim_data(args.data_dir)
    if args.sort:
        sort_sim_data(args.data_dir)


def _cmd_fit_material(args):
    from pffdtd_jax.materials import fit_to_Sabs_oct_11

    sabs = np.array([float(x) for x in args.sabs.split(",")])
    DEF = fit_to_Sabs_oct_11(sabs, filename=args.out)
    print(f"wrote {args.out}\nDEF=\n{DEF}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="pffdtd_jax")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="run the FDTD engine on a sim folder")
    ps.add_argument("--data_dir", required=True)
    ps.add_argument("--engine", default="jax", choices=["jax", "numpy"])
    ps.add_argument("--f64", action="store_true",
                    help="double precision (enables jax_enable_x64)")
    ps.add_argument("--energy", action="store_true",
                    help="machine-precision energy accounting")
    ps.add_argument("--nsteps", type=int, default=None,
                    help="progress/checkpoint block size")
    ps.add_argument("--checkpoint", default=None,
                    help="wavefield checkpoint file (.npz)")
    ps.add_argument("--checkpoint_every", type=int, default=0,
                    help="checkpoint every N blocks")
    ps.add_argument("--resume", action="store_true")
    ps.add_argument("--plot", action="store_true",
                    help="live 3-slice wavefield view during the run "
                         "(saves PNG frames when headless)")
    ps.add_argument("--show", action="store_true",
                    help="with --plot, open an interactive window")
    ps.set_defaults(fn=_cmd_sim)

    pp = sub.add_parser("process", help="post-process sim_outs.h5 into RIRs")
    pp.add_argument("--data_dir", required=True)
    pp.add_argument("--resample_Fs", type=float, default=48e3)
    pp.add_argument("--fcut_lowcut", type=float, default=10.0)
    pp.add_argument("--N_order_lowcut", type=int, default=8)
    pp.add_argument("--fcut_lowpass", type=float, default=0.0)
    pp.add_argument("--N_order_lowpass", type=int, default=8)
    pp.add_argument("--symmetric_lowpass", action="store_true")
    pp.add_argument("--air_abs_filter", default="none",
                    choices=["none", "stokes", "modal", "ola"])
    pp.add_argument("--save_wav", action="store_true")
    pp.add_argument("--plot", action="store_true",
                    help="save time/spectra plots per receiver (rirs.png)")
    pp.add_argument("--show", action="store_true",
                    help="with --plot, open a window instead of saving")
    pp.set_defaults(fn=_cmd_process)

    pr = sub.add_parser("prep", help="rotate/fold/sort a sim folder")
    pr.add_argument("--data_dir", required=True)
    pr.add_argument("--rotate", action="store_true")
    pr.add_argument("--fold", action="store_true")
    pr.add_argument("--sort", action="store_true")
    pr.set_defaults(fn=_cmd_prep)

    pf = sub.add_parser("fit-material",
                        help="fit DEF branches to 11 octave-band absorptions")
    pf.add_argument("--out", required=True)
    pf.add_argument("--sabs", required=True,
                    help="11 comma-separated absorption coefficients")
    pf.set_defaults(fn=_cmd_fit_material)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
