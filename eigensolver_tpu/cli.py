"""Command-line interface.

The reference has no CLI (every run means editing constants in a 1000-line
script); here each capability is a subcommand over the declarative case
registry:

  python -m eigensolver_tpu sweep slab_density_photospheric --width 0.9 -o out.pickle
  python -m eigensolver_tpu sweep slab_flow_complex_coronal --complex -o kh.pickle
  python -m eigensolver_tpu analyze out.pickle --case slab_density_photospheric --plot disp.png
  python -m eigensolver_tpu eigenfunction out.pickle --case ... --k 1.5 --branch kink --plot ef.png
  python -m eigensolver_tpu movie out.pickle --case ... --k 1.5 --branch kink -o wave.mp4
  python -m eigensolver_tpu vtk out.pickle --case ... --k 1.5 --branch kink -o field
  python -m eigensolver_tpu cases
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def _build_case(args):
    from . import cases as case_mod
    fac = getattr(case_mod, args.case, None)
    if fac is None:
        sys.exit(f"unknown case '{args.case}' - see `python -m eigensolver_tpu cases`")
    kw = {}
    for key in ("width", "U", "U_i0", "v_twist", "power", "mode"):
        v = getattr(args, key.lower(), None)
        if v is not None:
            import inspect
            if key in inspect.signature(fac).parameters:
                kw[key] = v
    case = fac(**kw)
    if args.speeds:
        case = dataclasses.replace(
            case, speeds=tuple(float(s) for s in args.speeds.split(",")))
    if args.n_k:
        case = dataclasses.replace(case, n_k=args.n_k)
    if getattr(args, "n_interior", None):
        case = dataclasses.replace(case, grid=dataclasses.replace(
            case.grid, n_interior=args.n_interior))
    return case


def _apply_device(args):
    import jax

    from .utils import enable_compile_cache
    if getattr(args, "device", None):
        jax.config.update("jax_platforms", args.device)
    if getattr(args, "x64", False):
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()


def _add_case_args(p, with_case=True):
    if with_case:
        p.add_argument("--case", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--x64", action="store_true")
    p.add_argument("--width", type=float, default=None)
    p.add_argument("--u", dest="u", type=float, default=None)
    p.add_argument("--u-i0", dest="u_i0", type=float, default=None)
    p.add_argument("--v-twist", dest="v_twist", type=float, default=None)
    p.add_argument("--power", type=float, default=None)
    p.add_argument("--mode", type=int, default=None)
    p.add_argument("--speeds", default=None, help="comma-separated band edges")
    p.add_argument("--n-k", type=int, default=None)
    p.add_argument("--n-interior", type=int, default=None,
                   help="RK4 steps across the non-uniform layer (resolution/"
                        "speed trade; default per-case GridConfig)")


def cmd_cases(args):
    from . import cases as case_mod
    for name, fac in case_mod.ALL_CASES.items():
        doc = (fac.__doc__ or "").strip().splitlines()[0]
        print(f"{name:36s} {doc}")


def cmd_sweep(args):
    _apply_device(args)
    from .roots import save_pickle
    from .search import SearchConfig
    from .sweep import run_case, run_case_complex

    # CLI --case takes the factory name; args.case reused by _build_case
    args.case = args.case_name
    case = _build_case(args)
    if case.complex_omega or args.complex:
        case = dataclasses.replace(case, complex_omega=True)
        if args.checkpoint:
            from .sweep import run_case_complex_checkpointed
            rs, st = run_case_complex_checkpointed(
                case, checkpoint_path=args.checkpoint)
        else:
            rs, st = run_case_complex(case)
    else:
        dt = "float64" if args.x64 else "float32"
        cfg = SearchConfig(n_omega=args.n_omega, scan_dtype=dt, polish_dtype=dt)
        if args.checkpoint:
            from .sweep import run_case_checkpointed
            rs, st = run_case_checkpointed(case, cfg,
                                           checkpoint_path=args.checkpoint)
        elif args.sharded:
            from .parallel import run_case_sharded
            rs, st = run_case_sharded(case, search=cfg)
        else:
            rs, st = run_case(case, cfg)
    print(json.dumps({"case": case.name, "counts": rs.counts(),
                      "wall_s": round(st.wall_s, 2),
                      "roots_per_sec": round(st.roots_per_sec, 2)}))
    if args.output:
        save_pickle(args.output, rs)
        print(f"saved {args.output}")


def cmd_analyze(args):
    _apply_device(args)
    from .analysis import analyse
    from .roots import load_pickle
    from .viz import dispersion_diagram

    case = _build_case(args)
    rs = load_pickle(args.pickle, case.name)
    fits = analyse(rs, case.regime)
    summary = {m: {w: len(f) for w, f in per.items() if f}
               for m, per in fits.items()}
    print(json.dumps({"branches": summary, "counts": rs.counts()}))
    if args.plot:
        an = None
        if args.analytic:
            from .analytic import analytic_curves
            ks = np.unique(np.concatenate(
                [b.ks for b in rs.branches.values() if len(b)]))
            vs = np.concatenate(
                [b.phase_speeds() for b in rs.branches.values() if len(b)])
            an = analytic_curves(case.regime, ks, float(vs.min()) * 0.98,
                                 float(vs.max()) * 1.02,
                                 geometry=case.geometry.value,
                                 modes=case.modes)
        dispersion_diagram(rs, case.regime, path=args.plot, fits=fits,
                           title=case.name, analytic=an)
        print(f"saved {args.plot}")
    if args.growth:
        from .viz import growth_rate_diagram
        growth_rate_diagram(rs, case.regime, path=args.growth, title=case.name)
        print(f"saved {args.growth}")


def cmd_compare(args):
    """Overlay many result pickles on one dispersion diagram - the capability
    of the reference's multi-width / twisted comparison books
    (`analysis_photospheric.py:336-344` four-width overlays;
    `analysis_cylinder_twisted_nonlinear_compare_power_twistedflow.py:441-631`
    dozens of (v_twist, power) pickles on one figure)."""
    _apply_device(args)
    from .roots import load_pickle
    from .viz import multi_width_overlay

    case = _build_case(args)
    labels = (args.labels.split(",") if args.labels
              else [p.rsplit("/", 1)[-1].removesuffix(".pickle")
                    for p in args.pickles])
    if len(labels) != len(args.pickles):
        sys.exit(f"{len(args.pickles)} pickles but {len(labels)} labels")
    root_sets = {lbl: load_pickle(p, lbl)
                 for lbl, p in zip(labels, args.pickles)}
    continuum = None
    if args.continuum:
        # cusp/Alfven continua between the boundary and centre values
        from .equilibrium import continuum_bands
        continuum = continuum_bands(case)
    out = multi_width_overlay(root_sets, case.regime, path=args.output,
                              branch=args.branch, continuum=continuum,
                              title=case.name)
    print(f"saved {out}")


def _pick_root(rs, branch, k_target):
    br = rs[branch]
    i = int(np.argmin(np.abs(br.ks - k_target)))
    return float(br.omegas[i]), float(br.ks[i])


def _reconstruct(case, args, rs):
    from .eigenfunctions import reconstruct_cylinder, reconstruct_slab
    from .config import Geometry
    omega, k = _pick_root(rs, args.branch, args.k)
    mode = {"sausage": 0, "kink": 1}.get(args.branch, 0)
    if case.geometry == Geometry.SLAB:
        ef = reconstruct_slab(case, mode, omega, k)
    else:
        ef = reconstruct_cylinder(case, mode, omega, k)
    return ef


def cmd_eigenfunction(args):
    _apply_device(args)
    from .roots import load_pickle
    from .viz import eigenfunction_figure

    case = _build_case(args)
    rs = load_pickle(args.pickle, case.name)
    ef = _reconstruct(case, args, rs)
    print(json.dumps({"omega": ef.omega, "k": ef.k,
                      "v_phase": ef.omega / ef.k}))
    if args.plot:
        comps = [c for c in ("P_T", "xi_r", "xi_phi", "xi_z")
                 if getattr(ef, c) is not None]
        eigenfunction_figure([ef], components=comps, path=args.plot)
        print(f"saved {args.plot}")


def cmd_movie(args):
    _apply_device(args)
    from .roots import load_pickle
    from .synthesis import FieldGrid, boundary_surface, synthesize, to_cartesian
    from .viz import animate_cross_section, animate_tube_3d

    case = _build_case(args)
    rs = load_pickle(args.pickle, case.name)
    ef = _reconstruct(case, args, rs)
    grid = FieldGrid.standard(ef.omega, n_t=args.frames)
    fields = to_cartesian(synthesize(ef, grid), grid)
    bnd = boundary_surface(fields, grid, amplitude=0.2)
    if getattr(args, "three_d", False):
        # 3-D advected-tube-surface view + two z cross-sections
        # (`Gaussian_flow_Cylinder_movie.py:1166-1232`)
        out = animate_tube_3d(fields, grid, args.output, boundary=bnd)
    else:
        out = animate_cross_section(fields, grid, args.output, boundary=bnd)
    print(f"saved {out}")


def cmd_vorticity(args):
    """One-command reproduction of the reference's vorticity figure class
    (`Vorticity_gaussian_flow{,_3D,_vert_cut,_yvert_cut}.py`): synthesis ->
    Cartesian resample -> np.gradient curl -> quiver/contourf cut-plane."""
    _apply_device(args)
    from .roots import load_pickle
    from .synthesis import FieldGrid, vorticity_pipeline
    from .viz import vorticity_cut_figure

    case = _build_case(args)
    rs = load_pickle(args.pickle, case.name)
    ef = _reconstruct(case, args, rs)
    grid = FieldGrid.standard(ef.omega, n_t=args.frames)
    bg_vphi = bg_vz = None
    if args.background:
        from .equilibrium import make_equilibrium
        eq = make_equilibrium(case)
        bg_vphi = lambda r: np.asarray(eq.v_phi(r))
        bg_vz = lambda r: np.asarray(eq.U_i(r))
    xs, ys, zs, vel, vort, PT = vorticity_pipeline(
        ef, grid, n_xy=args.n_xy, t_index=args.t_index,
        background_v_phi=bg_vphi, background_v_z=bg_vz)
    title = (f"{case.name} {args.branch} k={ef.k:.3g} "
             f"$\\omega$={ef.omega:.4g}")
    if getattr(args, "three_d", False):
        # native 3-D all-components view (`Vorticity_gaussian_flow_3D.py:
        # 993-1042`): velocity + full vorticity-vector quivers with the
        # advected boundary
        from .synthesis import boundary_surface, synthesize, to_cartesian
        from .viz import vorticity_3d_figure
        fields = to_cartesian(synthesize(ef, grid), grid)
        bx, by = boundary_surface(fields, grid, amplitude=0.2)
        out = vorticity_3d_figure(
            xs, ys, zs, vel, vort,
            boundary=(bx[args.t_index], by[args.t_index]),
            path=args.output, title=title + " (3-D)")
    else:
        out = vorticity_cut_figure(
            xs, ys, zs, vel, vort, PT=PT, cut=args.cut,
            index=args.cut_index, path=args.output,
            title=title + f" ({args.cut}-cut)")
    print(f"saved {out}")


def cmd_vtk(args):
    _apply_device(args)
    from .io.vtk import export_field_series
    from .roots import load_pickle
    from .synthesis import FieldGrid, synthesize, to_cartesian

    case = _build_case(args)
    rs = load_pickle(args.pickle, case.name)
    ef = _reconstruct(case, args, rs)
    grid = FieldGrid.standard(ef.omega, n_t=args.frames)
    fields = to_cartesian(synthesize(ef, grid), grid)
    paths = export_field_series(args.output, fields, grid,
                                ("P_T", "v_x", "v_y", "v_z", "xi_r"))
    print(f"saved {len(paths)} VTK files: {paths[0]} ...")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="eigensolver_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("cases").set_defaults(fn=cmd_cases)

    p = sub.add_parser("sweep")
    p.add_argument("case_name")
    _add_case_args(p, with_case=False)
    p.set_defaults(case=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--n-omega", type=int, default=256)
    p.add_argument("--complex", action="store_true")
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="crash-safe sweep: append each k-block's roots to an "
                        "fsync'd store at PATH; rerunning with the same PATH "
                        "resumes after the last durable block (real AND "
                        "complex-omega sweeps)")
    p.set_defaults(fn=cmd_sweep)

    for name, fn in [("analyze", cmd_analyze), ("eigenfunction", cmd_eigenfunction),
                     ("movie", cmd_movie), ("vtk", cmd_vtk),
                     ("vorticity", cmd_vorticity)]:
        p = sub.add_parser(name)
        p.add_argument("pickle")
        _add_case_args(p)
        if name in ("eigenfunction", "movie", "vtk", "vorticity"):
            p.add_argument("--k", type=float, required=True)
            p.add_argument("--branch", default="kink")
            p.add_argument("--frames", type=int, default=16)
        if name == "vorticity":
            p.add_argument("--cut", default="y", choices=("x", "y", "z"),
                           help="cut plane: y = vertical x-z (vert_cut), "
                                "x = vertical y-z (yvert_cut), z = horizontal")
            p.add_argument("--cut-index", type=int, default=None,
                           help="slice index along the cut axis (default mid)")
            p.add_argument("--t-index", type=int, default=0)
            p.add_argument("--n-xy", type=int, default=96)
            p.add_argument("--background", action="store_true",
                           help="add the equilibrium flow/rotation to v")
        if name in ("movie", "vorticity"):
            p.add_argument("--three-d", action="store_true", dest="three_d",
                           help="3-D view: advected-tube-surface movie "
                                "(movie) / all-components vorticity figure "
                                "(vorticity)")
        if name in ("analyze", "eigenfunction"):
            p.add_argument("--plot", default=None)
        if name == "analyze":
            p.add_argument("--analytic", action="store_true",
                           help="underlay the uniform-limit analytic curves")
            p.add_argument("--growth", default=None, metavar="PNG",
                           help="save a Re/Im omega growth-rate figure "
                                "(complex KH runs)")
        if name in ("movie", "vtk", "vorticity"):
            p.add_argument("-o", "--output", required=True)
        p.set_defaults(fn=fn)

    p = sub.add_parser("compare")
    p.add_argument("pickles", nargs="+")
    _add_case_args(p)
    p.add_argument("--labels", default=None,
                   help="comma-separated labels (default: pickle basenames)")
    p.add_argument("--branch", default="kink")
    p.add_argument("--continuum", action="store_true",
                   help="shade the layer's characteristic-speed continua")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_compare)

    # fix the sweep parser's case handling: case_name positional
    args = ap.parse_args(argv)
    if getattr(args, "case_name", None):
        args.case = args.case_name
    args.fn(args)


if __name__ == "__main__":
    main()
