#!/usr/bin/env python
"""Refined-accuracy measurement against ANALYTIC oracles (BASELINE accuracy
row evidence).

The BASELINE demands "eigenvalues matching the shipped pickles to 1e-6
relative (within solver tolerance)". The shipped pickles cannot support a
1e-6 comparison: re-running the reference's own scheme at tight tolerance
moves its entries by 1e-3..4e-2 relative (`dev_ref` in the recheck
artifacts) - percent-level acceptance noise is baked into the files. The
well-posed 1e-6 check is against closed-form dispersion relations in the
uniform limit (width=1e5 collapses the profile to a step to ~1e-10):

  slab:     tanh/tan relations (`flow_multiprocessor.py:117-127`)
  cylinder: J_m/K_m Bessel relation (`eigensolver_tpu.analytic.cylinder_relation`)

For each family: run the f32 sweep + f64 host refinement exactly as the
reproduction pass does, then for every refined root bisect the analytic
relation in f64 around it and report the relative deviation.

Usage: python tools/accuracy_report.py [--json ACCURACY_r03.json]
"""
import argparse
import dataclasses
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def run_family(name, case, speeds, geometry, n_omega=256):
    from eigensolver_tpu.analytic import analytic_deviation
    from eigensolver_tpu.search import SearchConfig
    from eigensolver_tpu.sweep import run_case

    case = dataclasses.replace(case, speeds=speeds)
    cfg = SearchConfig(n_omega=n_omega, n_bisect=18, scan_dtype="float32",
                       polish_dtype="float32")
    t0 = time.time()
    rs, st = run_case(case, cfg, refine_f64=True)
    wall = time.time() - t0
    out = {"family": name, "wall_s": round(wall, 1),
           "n_roots": sum(rs.counts().values()), "branches": {}}
    for bname, br in rs.branches.items():
        if not len(br):
            continue
        parity = 0 if bname == "sausage" else 1
        devs = analytic_deviation(case.regime, np.asarray(br.omegas),
                                  np.asarray(br.ks), parity, geometry)
        ok = np.isfinite(devs)
        worst = np.argsort(np.where(ok, devs, -1))[-8:][::-1]
        out["branches"][bname] = {
            "n": int(len(devs)), "n_checked": int(ok.sum()),
            "median_rel_dev": float(np.median(devs[ok])) if ok.any() else None,
            "frac_below_1e6": (float(np.mean(devs[ok] < 1e-6))
                               if ok.any() else None),
            "p90_rel_dev": float(np.quantile(devs[ok], 0.9)) if ok.any() else None,
            "max_rel_dev": float(np.max(devs[ok])) if ok.any() else None,
            "worst_roots": [
                {"k": float(br.ks[i]), "v": float(br.omegas[i] / br.ks[i]),
                 "rel_dev": float(devs[i])}
                for i in worst if ok[i]],
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--family", default=None,
                    help="substring filter: run only matching families")
    args = ap.parse_args()

    import jax
    if args.device:
        jax.config.update("jax_platforms", args.device)
    # refine_roots_f64 needs real f64 buffers (without x64 JAX silently
    # truncates and the refinement is a no-op)
    jax.config.update("jax_enable_x64", True)
    from eigensolver_tpu import cases
    from eigensolver_tpu.utils import enable_compile_cache
    enable_compile_cache()

    fams = [
        ("slab_photospheric_uniform_limit",
         lambda: cases.slab_density_photospheric(width=1e5),
         (0.905, 0.93, 0.955, 0.98, 0.9995), "slab"),
        # slow body modes live between cT_i0=0.588 and c_i0=1; the fast
        # (kink surface) branch sits near c_kink ~ 1.77
        ("slab_coronal_uniform_limit",
         lambda: cases.slab_density_coronal(width=1e5),
         (0.62, 0.75, 0.9, 0.9995, 1.7, 1.78, 1.85), "slab"),
        # body-mode bands of the uniform coronal cylinder: (cT_i0=0.894,
        # c_i0=1) slow, (vA_i0=2, vA_e=5) fast
        ("cylinder_coronal_uniform_limit",
         lambda: cases.cylinder_density_coronal(width=1e5),
         (0.9, 0.95, 0.9995, 2.05, 2.5, 3.0, 3.5, 4.0, 4.5, 4.95),
         "cylinder"),
    ]
    reports = []
    for name, mk, speeds, geom in fams:
        if args.family and args.family not in name:
            continue
        reports.append(run_family(name, mk(), speeds, geom))
    for r in reports:
        print(json.dumps(r))
    if args.json:
        json.dump(reports, open(args.json, "w"), indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
