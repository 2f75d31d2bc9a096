#!/usr/bin/env python
"""Reproduction harness: sweep a reference case on its own k grid and report
per-branch match rates against the shipped pickle.

Usage: python tools/reproduce.py [target ...] [--device cpu] [--json out.json]
Targets default to all eight BASELINE.md rows.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

REF = "/root/reference"

TARGETS = {
    # name: (case factory kwargs, pickle path, speeds windows, extra cfg)
    # windows start above the cusp continuum (cT spans [cT_bound=0.845,
    # cT_i0=0.885] for W=0.9); 0.9995/1.0005 brackets the c_i0 band edge
    "slab_ph_09": dict(
        case=("slab_density_photospheric", dict(width=0.9)),
        pickle=f"{REF}/Slab/Non uniform density/Photospheric/Example data/width09.pickle",
        speeds=(0.8855, 0.905, 0.925, 0.945, 0.965, 0.985, 0.9995, 1.0005,
                1.04, 1.08, 1.12, 1.17, 1.23, 1.2999),
        grid=dict(exterior_method="numeric", exterior_wavelengths=7.0),
    ),
    "slab_ph_1e5": dict(
        case=("slab_density_photospheric", dict(width=1e5)),
        pickle=f"{REF}/Slab/Non uniform density/Photospheric/Example data/width1e5.pickle",
        speeds=(0.8005, 0.83, 0.86, 0.8845, 0.8851, 0.905, 0.93, 0.955, 0.98,
                0.9995, 1.0005, 1.05, 1.1, 1.16, 1.22, 1.2999),
        grid=dict(exterior_method="numeric", exterior_wavelengths=7.0),
    ),
    "slab_co_09": dict(
        case=("slab_density_coronal", dict(width=0.9)),
        pickle=f"{REF}/Slab/Non uniform density/Coronal/Example data/width09_coronal.pickle",
        speeds=(1.05, 1.1, 1.15, 1.2, 1.35, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75,
                2.999),
        grid=dict(exterior_method="numeric", exterior_wavelengths=7.0),
    ),
    # pickle root clusters sit at v ~ U - cT_i = 0.063 and v ~ U + vA_i = 1.35,
    # fixing the generating flow amplitude at the file's commented coronal
    # value U_i0 = 0.35 vA_i (`flow_multiprocessor_coronal.py:68`), not the
    # currently-active 0.9
    "slab_flow_1": dict(
        case=("slab_flow_gaussian_coronal", dict(width=1.0, U_i0=0.35)),
        pickle=f"{REF}/Slab/Non uniform flow/Example data/flow_width1_coronal.pickle",
        speeds=(0.02, 0.06, 0.1, 0.15, 0.199, 0.21, 0.28, 0.4, 0.55, 0.7,
                0.85, 1.0, 1.15, 1.35, 1.55, 1.8, 2.05, 2.3, 2.499),
        # the remaining kink misses sit INSIDE the flow continuum
        # v in (U(1), U(0)) - critical-layer artifacts of the reference's
        # LSODA, not discrete eigenmodes; see REPRODUCTION.md. Chebyshev
        # seeding / deeper bracket budgets measurably do not recover them.
        grid=dict(exterior_method="numeric", exterior_wavelengths=3.0),
        # the generating file ships the LEGACY shear form D(x)
        # (`flow_multiprocessor_coronal.py:317-318`)
        case_extra=dict(shear_D_legacy=True),
    ),
    "cyl_co_09": dict(
        case=("cylinder_density_coronal", dict(width=0.9)),
        pickle=f"{REF}/Cylinder/Non-uniform density/Coronal/Example data/Cylindrical_coronal_width09.pickle",
        speeds=(-4.999, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0, -1.5, -1.0, -0.95,
                -0.9, 0.9, 0.95, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5,
                4.999),
    ),
    "cyl_ph_09": dict(
        case=("cylinder_density_photospheric", dict(width=0.9)),
        pickle=f"{REF}/Cylinder/Non-uniform density/Photospheric/Example data/Cylindrical_photospheric_width_09.pickle",
        speeds=(-1.499, -1.35, -1.25, -1.1, -1.0, -0.95, -0.9, -0.85, -0.75,
                -0.6, -0.51, 0.51, 0.6, 0.75, 0.85, 0.9, 0.95, 1.0, 1.1,
                1.25, 1.35, 1.499),
    ),
    # 'flow_1' names the Gaussian flow WIDTH (dr=1), amplitude U_i0=0.05 c_i0 -
    # fixed by the analysis scripts (`analysis_cylinder_flow_coronal.py:117,121`
    # with sibling pickles flow_1e5/flow_15 = widths 1e5/1.5)
    # band edges = the generating file's characteristic speeds (positive list
    # `Cylinder_method_flow_testing.py:231`, negative variant kept at `:228`):
    # +-{cT_i0=0.8944, c_i0=1, vA_i0=2, c_kink=2.75325, vA_e=5}. The reference
    # breaks on its FIRST under-tolerance scan point, so flat kink branches
    # hugging c_kink are recorded AT the band-edge seed v = +-c_kink - the
    # fuzz first-of-run points reproduce those entries.
    # Band edges: the generating file's characteristic speeds are
    # +-{cT_i0=0.8944, c_i0=1, vA_i0=2, c_kink=2.75325, vA_e=5}
    # (`Cylinder_method_flow_testing.py:231`, mirrored negative list `:228`);
    # the +-0.51 entries are OUR ladder guard edges only - they keep the
    # (-cT, +cT) gap (which the reference never scans) out of any one ladder
    # row spanning v = 0. fuzz_v_ranges therefore restricts the swath
    # (fuzz) acceptance to |v| within the reference's scanned bands, so no
    # swath entry is recorded at a seed the reference never evaluated.
    # The strided fuzz grid reproduces its 70-seed scans (`:1153`) - swath
    # entries accepted at xi_tol=6% (`:530`) are recorded AT those seeds (up
    # to the ladder edge_shrink offset, ~1e-3 of band width), up to band/70
    # from the residual's true zero. n_omega = 22*69+1 keeps 22x the
    # reference's bracketing resolution on the same grid. max_brackets=24:
    # the consolidated wide bands (e.g. (2.75325, 4.999)) can hold more
    # body-mode sign changes per row than the default budget of 8.
    "cyl_flow_1": dict(
        case=("cylinder_flow_coronal", dict(U=0.05, width=1.0)),
        pickle=f"{REF}/Cylinder/Non-uniform flow/Coronal/Example data/Cylindrical_coronal_flow_1.pickle",
        speeds=(-4.999, -2.75325, -2.0, -1.0, -0.8944, -0.51,
                0.51, 0.8944, 1.0, 2.0, 2.75325, 4.999),
        n_omega=1519, fuzz_stride=22, fuzz_pct=6.0, max_brackets=24,
        fuzz_v_ranges=((0.8944, 4.999),), refine_scan_accept=2.0,
    ),
    # The twisted scripts accept the FIRST scanned omega whose xi residual is
    # under P_tol=2.5% (`Twisted_photospheric_nonlinear_flow_kink_fast.py:
    # 581,717` - loop breaks on acceptance), so the shipped roots sit one-sided
    # ~0.2-0.6% BELOW the residual's true zero (measured: mean +3.3e-3, all
    # positive). Match tolerance reflects that acceptance width; the residual
    # of OUR zeros under the reference metric is 0.01-0.06%.
    "twist_v01_p1": dict(
        case=("cylinder_twisted_photospheric",
              dict(v_twist=0.1, power=1.0, mode=1)),
        pickle=f"{REF}/Cylinder/Rotational flow/Photospheric/Example data/Cylindrical_photospheric_vtwist01_power1_fund_kink.pickle",
        speeds=(0.85, 0.95, 1.05, 1.15, 1.25, 1.32, 1.40, 1.4899),
        tol=8e-3,
    ),
    # strong-twist fundamental kink (same engine/windows, v_twist = 0.25)
    "twist_v025_p1": dict(
        case=("cylinder_twisted_photospheric",
              dict(v_twist=0.25, power=1.0, mode=1)),
        pickle=f"{REF}/Cylinder/Rotational flow/Photospheric/Example data/Cylindrical_photospheric_vtwist025_power1_fund_kink.pickle",
        speeds=(0.85, 0.95, 1.05, 1.15, 1.25, 1.32, 1.40, 1.4899),
        tol=8e-3,
    ),
    # twisted SAUSAGE branches (m=0 engine variant), v_twist=0.15 power=1
    # pickles; fast windows [c_kink=1.26782, 1.4, c_e=1.5]
    # (`Twisted_photospheric_flow_sausage.py:224`), slow windows [0.88..1.0]
    # (`..._sausage_slow.py:232`); first-acceptance break at P_tol=2.5% as for
    # the kink variants.
    "twist_v015_p1_sfast": dict(
        case=("cylinder_twisted_photospheric",
              dict(v_twist=0.15, power=1.0, mode=0)),
        pickle=f"{REF}/Cylinder/Rotational flow/Photospheric/Example data/Cylindrical_photospheric_vtwist015_power1_sausage_fast.pickle",
        speeds=(1.26782, 1.33, 1.4, 1.45, 1.4999),
        tol=8e-3,
    ),
    "twist_v015_p1_sslow": dict(
        case=("cylinder_twisted_photospheric",
              dict(v_twist=0.15, power=1.0, mode=0)),
        pickle=f"{REF}/Cylinder/Rotational flow/Photospheric/Example data/Cylindrical_photospheric_vtwist015_power1_sausage_slow.pickle",
        speeds=(0.88, 0.9, 0.92, 0.94, 0.96, 0.98, 0.9999),
        tol=8e-3,
    ),
}

# Programmatic targets for every remaining Example-data pickle (pure
# parameter loops over the same case constructors; windows derived from the
# pickle's own phase-speed clusters - see tools/targets_auto.py).
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from targets_auto import generate as _auto_generate  # noqa: E402

TARGETS.update(_auto_generate(
    existing_pickles=[s["pickle"] for s in TARGETS.values()]))

# Band-edge pass (sweep.run_needle_pass) for the targets whose pickles carry
# entries AT the cusp-continuum edges: the slab_ph_3 sausage entries sit at
# the cT band-edge accumulation point (v within 2e-7 of the edge), the
# slab_co_15 / zoom entries are an isolated discrete zero ~1e-5 |v| above the
# band top - both inside the production ladder's edge_shrink margin, so the
# main sweep never evaluates there (PARITY_r05 "needle" miss class; resolved
# by direct f64 scan, see run_needle_pass docstring). The pickled branches
# there are sausage-only; the mirror (negative-v) bands carry no entries.
for _t in ("slab_ph_3", "slab_co_15", "slab_co_15zoom"):
    TARGETS[_t]["needle"] = dict(modes=(0,), positive_only=True)


def match_report(ref_br, our_br, v_lo, v_hi, tol=3e-3, misses=None):
    matched, total, errs = 0, 0, []
    matched_rel_only = 0
    for om_r, k_r in zip(ref_br.omegas, ref_br.ks):
        v = om_r / k_r
        if not (v_lo < v < v_hi):
            continue
        total += 1
        ours = our_br.omegas[np.isclose(our_br.ks, k_r, atol=1e-9)]
        hit = False
        rel = np.inf
        om_near = np.nan
        window = []
        if len(ours):
            i_near = int(np.argmin(np.abs(ours - om_r)))
            om_near = float(ours[i_near])
            rel = abs(om_near - om_r) / abs(om_r)
            # ALL of our roots within 2.5% of the entry, not just the
            # nearest: the recheck arbiter compares its converged dip
            # against these - with only the nearest, a pickle entry sitting
            # between two true zeros gets classified both_off even when we
            # found the dip's zero too (it just was not the nearest one)
            near = ours[np.abs(ours - om_r) < 0.025 * abs(om_r)]
            window = [float(x) for x in
                      near[np.argsort(np.abs(near - om_r))][:6]]
            errs.append(rel)
            # relative-in-omega OR absolute-in-phase-speed: the reference
            # seeds its bands uniformly in v = omega/k (`test_freq =
            # linspace(speeds[i] k, ...)`), so its own recorded resolution
            # is ABSOLUTE in v - a relative-omega tolerance diverges
            # spuriously for the near-zero backward/slow Doppler modes
            # (omega ~ 1e-4, PARITY_r03 slab_flow "misses" with
            # |delta v| ~ 5e-5)
            # the |delta v| branch is CAPPED in relative omega (<= 5%): an
            # uncapped absolute-in-v criterion would count a v ~ 0.02 Doppler
            # mode matched at ~15% relative omega error (ADVICE r04 #2);
            # matched_rel_only reports the strict relative-only criterion
            # alongside so r03-series rates stay comparable.
            hit = rel < tol or (abs(om_near - om_r) / abs(k_r) < tol
                                and rel < 0.05)
            matched += hit
            matched_rel_only += rel < tol
        else:
            errs.append(np.inf)
        if not hit and misses is not None:
            misses.append((om_r, k_r, rel, om_near, window))
    errs = np.asarray(errs) if errs else np.asarray([np.nan])
    fin = errs[np.isfinite(errs)]
    return {
        "matched": int(matched), "total": int(total),
        "matched_rel_only": int(matched_rel_only),
        "rate": round(matched / total, 4) if total else None,
        "median_rel_err": float(np.median(fin)) if len(fin) else None,
        "p90_rel_err": float(np.percentile(fin, 90)) if len(fin) else None,
    }


def run_target(name, spec, scan_dtype="float32", n_omega=384,
               refine_f64=False, max_brackets_default=24, edge_shrink=None):
    import jax.numpy as jnp
    from eigensolver_tpu import cases as case_mod
    from eigensolver_tpu.roots import load_pickle
    from eigensolver_tpu.search import SearchConfig
    from eigensolver_tpu.sweep import run_case

    from targets_auto import resolve_windows
    spec = resolve_windows(spec)
    fac, kw = spec["case"]
    if "n_omega" in spec and spec["n_omega"] != n_omega:
        print(f"# {name}: spec n_omega={spec['n_omega']} overrides "
              f"--n-omega {n_omega} (fuzz-grid alignment)", file=sys.stderr)
    n_omega = spec.get("n_omega", n_omega)
    fuzz_stride = spec.get("fuzz_stride", 1)
    if fuzz_stride > 1:
        # the strided fuzz grid only lands on the reference's seed linspace
        # when the ladder is uniform and stride divides the panel count
        assert (n_omega - 1) % fuzz_stride == 0, (
            f"{name}: fuzz_stride={fuzz_stride} needs (n_omega-1) % stride == 0"
            f" (n_omega={n_omega})")
    case = getattr(case_mod, fac)(**kw)
    ref = load_pickle(spec["pickle"])
    # 2-tuple pickles always load as branch "kink" (the twisted scripts all
    # dump [sol_omegas1, sol_ks1] regardless of m,
    # `Twisted_photospheric_flow_sausage.py:786`); when the case solves m=0
    # the roots are sausage modes - relabel so the branch lookup matches.
    if set(ref.branches) == {"kink"} and tuple(case.modes) == (0,):
        ref = type(ref)({"sausage": ref.branches["kink"]}, ref.case_name)
    k_ref = np.unique(np.concatenate(
        [b.ks for b in ref.branches.values() if len(b)]))
    case = dataclasses.replace(case, k_values=tuple(k_ref),
                               speeds=spec["speeds"])
    if spec.get("grid"):
        case = dataclasses.replace(
            case, grid=dataclasses.replace(case.grid, **spec["grid"]))
    if edge_shrink is not None:
        case = dataclasses.replace(case, grid=dataclasses.replace(
            case.grid, ladder_edge_shrink=edge_shrink))
    if spec.get("case_extra"):
        case = dataclasses.replace(case, **spec["case_extra"])
    # f32 bisection saturates by ~18 iterations (measured bit-identical vs 45)
    n_bisect = 50 if scan_dtype == "float64" else 18
    if fuzz_stride > 1:
        assert case.grid.ladder_shape == "uniform", (
            f"{name}: fuzz_stride parity requires a uniform omega ladder, "
            f"got {case.grid.ladder_shape!r}")
    # mask bracket formation inside genuine continua (resolution-dependent
    # dense point spectrum crowds out real modes; fuzz parity unaffected).
    # Twisted cases get the row-local (k,m)-dependent variant instead.
    from eigensolver_tpu.equilibrium import (genuine_continua,
                                             genuine_continua_rowfn)
    excl = tuple((lo, hi) for lo, hi, _ in genuine_continua(case))
    rowfn = genuine_continua_rowfn(case)
    cfg = SearchConfig(n_omega=n_omega, n_bisect=n_bisect, scan_dtype=scan_dtype,
                       polish_dtype=scan_dtype,
                       max_brackets_per_row=spec.get("max_brackets",
                                                     max_brackets_default),
                       exclude_v_ranges=excl or None,
                       exclude_omega_rowfn=rowfn,
                       fuzz_accept_pct=spec.get("fuzz_pct", 3.0),
                       fuzz_stride=fuzz_stride,
                       fuzz_v_ranges=spec.get("fuzz_v_ranges"),
                       # with --refine, loosen the f32 filter and re-judge at
                       # the f64 zero (needle quasi-resonances; see
                       # SearchConfig.accept_pct_refined). The loose scan
                       # filter is per-target: flooding dedup with 25%-residual
                       # brackets can absorb fuzz-parity entries (measured on
                       # cyl_flow_1: kink matches drop 373 -> 309), so targets
                       # without needle modes keep a tight scan filter.
                       accept_pct=(spec.get("refine_scan_accept", 25.0)
                                   if refine_f64 else 1.0),
                       accept_pct_refined=3.0 if refine_f64 else None)
    t0 = time.time()
    rs, st = run_case(case, cfg, refine_f64=refine_f64)
    ndl = spec.get("needle")
    needle_counts = None
    if ndl:
        # band-edge pass: f64 on host CPU, merged at tight dedup so the
        # near-edge roots survive (see sweep.run_needle_pass)
        from eigensolver_tpu.roots import merge_rootsets
        from eigensolver_tpu.sweep import needle_edges, run_needle_pass
        edges = needle_edges(case)
        if ndl.get("positive_only"):
            edges = tuple(e for e in edges if e[0] > 0)
        nrs, _ = run_needle_pass(case, edges=edges,
                                 modes=ndl.get("modes"))
        needle_counts = nrs.counts()
        rs = merge_rootsets(rs, nrs)
    wall = time.time() - t0
    speeds = sorted(spec["speeds"])
    v_lo, v_hi = speeds[0], speeds[-1]
    out = {"target": name, "wall_s": round(wall, 1),
           "candidates": st.n_candidates, "found": rs.counts()}
    if needle_counts is not None:
        out["needle_roots"] = needle_counts
    for bname, br in ref.branches.items():
        ours = rs.branches.get(bname)
        if ours is None or len(br) == 0:
            continue
        misses = []
        out[bname] = match_report(br, ours, v_lo, v_hi,
                                  tol=spec.get("tol", 3e-3), misses=misses)
        out[bname]["ref_total"] = len(br)
        if misses:
            out[bname]["misses"] = {
                "omega_ref": [m[0] for m in misses],
                "k": [m[1] for m in misses],
                "v_phase": [round(m[0] / m[1], 4) for m in misses],
                "rel_err": [round(float(m[2]), 5) if np.isfinite(m[2])
                            else None for m in misses],
                "omega_ours": [float(m[3]) if np.isfinite(m[3]) else None
                               for m in misses],
                "omega_ours_window": [m[4] for m in misses]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("targets", nargs="*", default=list(TARGETS))
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--jsonl", default=None,
                    help="append one JSON line per finished target (crash-"
                         "safe accumulation for multi-hour breadth runs)")
    ap.add_argument("--resume", action="store_true",
                    help="skip targets already present in --jsonl")
    ap.add_argument("--n-omega", type=int, default=384)
    ap.add_argument("--refine", action="store_true",
                    help="f64 host-CPU re-bisection of accepted roots")
    ap.add_argument("--edge-shrink", type=float, default=None,
                    help="override GridConfig.ladder_edge_shrink (band-edge "
                         "shave fraction; see config.py - non-pole band "
                         "edges like c_kink can hide zeros in the default "
                         "1e-3 margin)")
    args = ap.parse_args()

    import jax
    from eigensolver_tpu.utils import enable_compile_cache
    enable_compile_cache()   # repeat sweeps skip the compile
    if args.device:
        jax.config.update("jax_platforms", args.device)
    if args.dtype is None:
        args.dtype = "float64" if jax.default_backend() == "cpu" else "float32"
    if args.dtype == "float64" or args.refine:
        # refine_roots_f64 genuinely needs f64 buffers (without x64 JAX silently
        # truncates them to f32 and the refinement is a no-op); the on-device
        # scan keeps its explicit float32 dtypes either way.
        jax.config.update("jax_enable_x64", True)

    reports = []
    done = set()
    if args.resume and args.jsonl and os.path.exists(args.jsonl):
        with open(args.jsonl) as f:
            for line in f:
                try:
                    rep = json.loads(line)
                except ValueError:
                    continue
                if "error" not in rep:
                    done.add(rep["target"])
                    reports.append(rep)
        print(f"# resume: {len(done)} targets already in {args.jsonl}",
              file=sys.stderr, flush=True)
    for t in (args.targets or list(TARGETS)):
        if t in done:
            continue
        print(f"# starting {t} on {jax.default_backend()} ({args.dtype})",
              file=sys.stderr, flush=True)
        try:
            rep = run_target(t, TARGETS[t], scan_dtype=args.dtype,
                             n_omega=args.n_omega, refine_f64=args.refine,
                             edge_shrink=args.edge_shrink)
        except Exception as e:  # keep going; report the failure
            rep = {"target": t, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rep))
        sys.stdout.flush()
        reports.append(rep)
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps(rep) + "\n")
                f.flush()
                os.fsync(f.fileno())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)


if __name__ == "__main__":
    main()
