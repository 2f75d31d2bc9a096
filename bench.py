#!/usr/bin/env python
"""Benchmark: eigenmode roots/sec/chip on the three engine families.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "detail"}.
Needs a GPU: it exits non-zero, printing nothing, when JAX's default device
is anything else. `detail.device` names the card JAX ran on.

- value: accepted eigenmode roots per second per chip for the full omega-k
  sweep of the slab photospheric density case (W=0.9), f32 scan+polish.
- detail.cases adds the two expensive engines the BASELINE scale rows name:
  the cylinder Hain-Luest chain (coronal density W=0.9) and the twisted
  (rotational-flow) engine, each as steady-state roots/s, candidates/s and
  per-stage wall split.
- vs_baseline: speedup of roots/sec over the reference pipeline, whose
  per-seed cost (scipy LSODA exterior + fsolve-shooting interior over the
  reference's 1e5-point grid, `multiprocessor_Inhomogeneous_method.py:364-387`)
  is measured live on this host and multiplied by the reference's own seed
  count for the same case (35 k x 1 band x 35 seeds x 2 parities, plus the
  measured bisection-recursion overhead factor ~3x, `:790-801`).
"""
import json
import sys
import time

import numpy as np


def _bench_case(case, cfg, n_repeats: int = 5):
    """(n_roots, walls, n_candidates, stage_walls) steady-state: first run
    compiles, then `n_repeats` timed runs. The artifact records median AND
    min/max spread; headline numbers quote the median. stage_walls carries
    the per-stage wall split (ladders / device pipeline / host finalize) of
    the MEDIAN run."""
    from eigensolver_tpu.sweep import run_case
    from eigensolver_tpu.utils import StageTimer
    run_case(case, cfg)
    runs = []
    for _ in range(n_repeats):
        timer = StageTimer()
        t0 = time.time()
        rs, st = run_case(case, cfg, timer=timer)
        wall = time.time() - t0
        runs.append((wall, rs, st, timer))
    runs.sort(key=lambda r: r[0])
    wall_med, rs, st, timer = runs[len(runs) // 2]
    walls = dict(median=wall_med, min=runs[0][0], max=runs[-1][0],
                 n_repeats=n_repeats)
    n_roots = sum(rs.counts().values())
    stages = {k: round(v, 4) for k, v in timer.report().items()}
    return n_roots, walls, st.n_candidates, stages


def _case_entry(n, walls, cands, stages=None, **extra):
    wall = walls["median"]
    d = dict(n_roots=n, wall_s=round(wall, 3),
             wall_s_min=round(walls["min"], 3),
             wall_s_max=round(walls["max"], 3),
             n_repeats=walls["n_repeats"],
             roots_per_s=round(n / wall, 1),
             candidates=cands,
             cands_per_s=round(cands / wall, 1),
             cands_per_s_max=round(cands / walls["min"], 1))
    if stages is not None:
        d["stage_walls_s"] = stages
    d.update(extra)
    return d


def measure_ours():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default device is "
                 f"{dev.platform} ({dev.device_kind})")
    from eigensolver_tpu import cases
    from eigensolver_tpu.search import SearchConfig
    from eigensolver_tpu.utils import enable_compile_cache
    enable_compile_cache()

    # f32 bisection saturates at ~2^-12 of the ladder bracket (bit-identical
    # roots measured for n_bisect 12..45 in f32); 18 leaves margin.
    cfg = SearchConfig(n_omega=256, n_bisect=18,
                       scan_dtype="float32", polish_dtype="float32")

    out = {}
    n, walls, cands, stages = _bench_case(
        cases.slab_density_photospheric(width=0.9), cfg)
    out["slab_ph_09"] = _case_entry(n, walls, cands, stages)
    n, walls, cands, stages = _bench_case(
        cases.cylinder_density_coronal(width=0.9), cfg)
    out["cyl_co_09"] = _case_entry(n, walls, cands, stages)
    # twisted (rotational flow) engine - the conditioning-hardest family
    n, walls, cands, stages = _bench_case(
        cases.cylinder_twisted_photospheric(v_twist=0.1, power=1.0, mode=1),
        cfg)
    out["twist_v01_p1"] = _case_entry(n, walls, cands, stages)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    return out, device


def measure_reference_seed_cost(n_samples: int = 4):
    """Per-seed wall time of the reference numerical pipeline (no sympy -
    generous to the reference: coefficients pre-lambdified)."""
    from scipy.integrate import odeint
    from scipy.optimize import fsolve

    c_i0, vA_i0, c_e, vA_e = 1.0, 1.9, 1.3, 0.8
    gamma = 5.0 / 3.0
    rho_i0 = 1.0
    rho_e = rho_i0 * (c_i0**2 + gamma / 2 * vA_i0**2) / (c_e**2 + gamma / 2 * vA_e**2)
    cT_e = np.sqrt(c_e**2 * vA_e**2 / (c_e**2 + vA_e**2))
    W = 0.9

    def rho_i(x):
        return rho_e + (rho_i0 - rho_e) * np.exp(-(x**2) / W**2)

    def vA_i(x):
        return vA_i0 * np.sqrt(rho_i0 / rho_i(x))

    def c_i(x):
        return np.sqrt(rho_e * (c_e**2 + gamma / 2 * vA_e**2) / rho_i(x)
                       - gamma / 2 * vA_i(x) ** 2)

    ix = np.linspace(-1.0, 1.0, 100000)   # reference grid `:89`
    k, om_seeds = 1.5, np.linspace(1.35, 1.55, n_samples)

    t0 = time.time()
    for om in om_seeds:
        m_e = ((k**2 * vA_e**2 - om**2) * (k**2 * c_e**2 - om**2)
               / ((vA_e**2 + c_e**2) * (k**2 * cT_e**2 - om**2)))
        lx = np.linspace(-7 * 2 * np.pi / k, -1.0, 500)
        Ls = odeint(lambda V, x: [V[1], m_e * V[0]], [1e-8, 1e-8], lx)
        left = Ls[-1, 0]

        def F(x):
            c2, a2 = c_i(x) ** 2, vA_i(x) ** 2
            cT2 = c2 * a2 / (c2 + a2)
            return rho_i(x) * (c2 + a2) * (k**2 * cT2 - om**2) / (k**2 * c2 - om**2)

        def m0(x):
            c2, a2 = c_i(x) ** 2, vA_i(x) ** 2
            cT2 = c2 * a2 / (c2 + a2)
            return ((k**2 * c2 - om**2) * (k**2 * a2 - om**2)
                    / ((c2 + a2) * (k**2 * cT2 - om**2)))

        h = 1e-5

        def rhs(V, x):
            dF = (F(x + h) - F(x - h)) / (2 * h)
            return [V[1], -dF / F(x) * V[1] + m0(x) * V[0]]

        def objective(dv):
            U = odeint(rhs, [left, dv[0]], ix)
            return U[-1, 0] + left

        fsolve(objective, [1.0])
    return (time.time() - t0) / n_samples


def main():
    cases_out, device = measure_ours()
    head = cases_out["slab_ph_09"]
    roots_per_sec = head["roots_per_s"]

    try:
        ref_seed_s = measure_reference_seed_cost()
    except Exception:
        ref_seed_s = float("nan")

    # Reference workload for the same case: 35 k x 1 band x 35 seeds x 2
    # parities; recursive bisection multiplies evaluations ~3x
    # (`multiprocessor_Inhomogeneous_method.py:774,790-801,510-522`). The
    # reference forks one process per (k,band,parity); grant it ideal scaling
    # over this host's cores.
    import os
    ref_evals = 35 * 1 * 35 * 2 * 3
    cores = os.cpu_count() or 1
    ref_wall = ref_seed_s * ref_evals / cores
    # Reference run of this case yields 305 roots (width09.pickle, measured).
    ref_roots_per_sec = 305 / ref_wall if ref_wall > 0 else float("nan")
    vs_baseline = roots_per_sec / ref_roots_per_sec

    print(json.dumps({
        "metric": "eigenmode_roots_per_sec_per_chip",
        "value": roots_per_sec,
        "unit": "roots/s",
        "vs_baseline": round(vs_baseline, 2),
        "detail": {
            "device": device,
            "cases": cases_out,
            # roots/s depends on each case's root density (a denser sweep
            # grid finds more roots per second trivially); candidates/s
            # (cands_per_s per case) is the stable cross-case throughput
            # metric - compare THAT between engines/rounds.
            "candidates_per_sec_per_chip": head["cands_per_s"],
            "ref_seed_s": round(ref_seed_s, 4),
            "ref_wall_est_s": round(ref_wall, 1),
        },
    }))


if __name__ == "__main__":
    main()
