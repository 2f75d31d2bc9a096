#!/usr/bin/env python
"""Per-stage profile of the fused search pipeline on one case.

Times each stage of `search._search_pipeline` as a SEPARATE jitted dispatch
(steady-state: compile on the first call, time the later ones), so a
throughput shift in the headline bench is attributable to scan / bracket /
bisect / acceptance rather than guessed at. The production sweep keeps the
single fused jit; this tool exists because the fused program cannot be timed
stage-wise from the host.

Usage:
    python tools/profile_pipeline.py [case_name] [--reps N] [--json PATH]

The reference's only instrumentation is a single wall-clock print per run
(`multiprocessor_Inhomogeneous_method.py:1119`); this is the per-stage cost
model SURVEY.md section 5 calls for.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", nargs="?", default="slab_ph_09")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n-omega", type=int, default=256)
    ap.add_argument("--n-bisect", type=int, default=18)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from eigensolver_tpu import cases
    from eigensolver_tpu.search import (SearchConfig, bisect, find_brackets,
                                        ladder_scan)
    from eigensolver_tpu.sweep import (build_ladders, finalize_branches,
                                       make_dispersion_moded, run_case)
    from eigensolver_tpu.utils import StageTimer, enable_compile_cache
    enable_compile_cache()

    CASE_FNS = {
        "slab_ph_09": lambda: cases.slab_density_photospheric(width=0.9),
        "cyl_co_09": lambda: cases.cylinder_density_coronal(width=0.9),
        "twist_v01_p1": lambda: cases.cylinder_twisted_photospheric(
            v_twist=0.1, power=1.0, mode=1),
    }
    case = CASE_FNS[args.case]()
    cfg = SearchConfig(n_omega=args.n_omega, n_bisect=args.n_bisect,
                       scan_dtype=args.dtype, polish_dtype=args.dtype)
    dt = jnp.dtype(args.dtype)

    omegas, ks = build_ladders(case, cfg.n_omega)
    rows = omegas.shape[0]
    modes = case.modes
    omegas_f = jnp.concatenate([omegas] * len(modes)).astype(dt)
    ks_f = jnp.concatenate([ks] * len(modes)).astype(dt)
    modes_f = jnp.concatenate(
        [jnp.full((rows,), float(m)) for m in modes]).astype(dt)
    disp = make_dispersion_moded(case, dt)

    # --- cumulative composite stages, each reduced to ONE scalar -----------
    # (one host fetch per stage; stage costs come from differences)
    @jax.jit
    def stage_rtt(om):
        return jnp.float32(0.0) + om.ravel()[0] * 0

    @jax.jit
    def stage_scan(om, kk, md):
        det, valid, mism = ladder_scan(disp, om, kk, md)
        return jnp.nansum(jnp.where(jnp.isfinite(det), det, 0.0))

    @jax.jit
    def stage_bracket(om, kk, md):
        det, valid, mism = ladder_scan(disp, om, kk, md)
        br = find_brackets(om, kk, det, valid, cfg.max_brackets_per_row,
                           md, mism=mism)
        return jnp.sum(br.lo) + jnp.sum(br.mask)

    @jax.jit
    def stage_bisect(om, kk, md):
        det, valid, mism = ladder_scan(disp, om, kk, md)
        br = find_brackets(om, kk, det, valid, cfg.max_brackets_per_row,
                           md, mism=mism)
        pr = bisect(disp, br, cfg.n_bisect, dtype=dt)
        return jnp.sum(pr.omega) + jnp.nansum(
            jnp.where(jnp.isfinite(pr.mismatch), pr.mismatch, 0.0))

    def force(out):
        return jax.block_until_ready(out)

    def timed(fn, *a):
        out = force(fn(*a))                           # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = force(fn(*a))
        return out, (time.perf_counter() - t0) / args.reps

    _, t_rtt = timed(stage_rtt, omegas_f)
    _, t_scan = timed(stage_scan, omegas_f, ks_f, modes_f)
    _, t_cum_bracket = timed(stage_bracket, omegas_f, ks_f, modes_f)
    _, t_cum_bisect = timed(stage_bisect, omegas_f, ks_f, modes_f)
    t_bracket = t_cum_bracket - t_scan
    t_bisect = t_cum_bisect - t_cum_bracket

    # --- host tail: collect (device->host transfers) vs dedup --------------
    from eigensolver_tpu.search import collect, search_rows
    pr_full = search_rows(disp, disp, omegas_f, ks_f, cfg, modes=modes_f)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        collect(pr_full, with_fuzz=True)
    t_collect = (time.perf_counter() - t0) / args.reps

    # --- fused pipeline + host tail (what bench.py measures) ---------------
    run_case(case, cfg)                                # compile
    timer = StageTimer()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        rs, st = run_case(case, cfg, timer=timer)
    t_total = (time.perf_counter() - t0) / args.reps

    n_cand = int(omegas_f.size)
    rep = {
        "case": args.case, "backend": jax.default_backend(),
        "rows": int(omegas_f.shape[0]), "n_omega": int(omegas_f.shape[1]),
        "candidates": n_cand, "reps": args.reps,
        "stages_s": {
            "dispatch_rtt": round(t_rtt, 4),
            "scan": round(t_scan, 4),
            "bracket_delta": round(t_bracket, 4),
            "bisect_delta": round(t_bisect, 4),
            "collect_host": round(t_collect, 4),
            "fused_total": round(t_total, 4),
        },
        "run_case_stage_totals_s": {k: round(v / args.reps, 4)
                                    for k, v in timer.report().items()},
        "cands_per_s_fused": round(n_cand / t_total, 1),
        "n_roots": sum(rs.counts().values()),
    }
    print(json.dumps(rep, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2)


if __name__ == "__main__":
    main()
