#!/usr/bin/env python
"""Smoke test of the dispersion sweep on the GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: sharded vs one-card sweep

Drives the solver's main path through the entry points a user calls
(`sweep.run_case`, `sweep.run_case_complex`, `parallel.run_case_sharded`) at
each case's full grid, checks the roots against independent references, and
prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases (one card):
  1. device: JAX's default device must be a GPU; never falls back.
  2. main path: three real-omega cases (f32 scan+polish, f64 refine on the
     card) and the complex-omega Kelvin-Helmholtz case.
  3. correctness: (a) uniform-limit roots vs the analytic relations,
     (b) f64 roots on the GPU vs the CPU backend of the same process.
  4. compile-time memory of the largest dispatches.
  5. `pytest -m gpu`.

The parent process never imports JAX. Phases 1-4 (or the four-card phase)
run in one child process that holds the card(s) alone; phase 5 runs in a
second child after the first has exited. Any failure exits non-zero and no
"ok" line is printed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Phase 3 tolerances. (a) per-root bound of tests/test_cylinder_analytic.py;
# (b) f64 transcendentals differ in the last bits between XLA's CPU and GPU
# code, and 60 bisections carry no more than that.
ORACLE_MEDIAN = 1e-6
ORACLE_MAX = 1e-5
CPU_GPU_MAX = 1e-9
SHARDED_MAX = 1e-6     # f32 polish: sharded vs one-card


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def _platforms():
    """JAX_PLATFORMS for the children: the caller's choice (the GPU by
    default) with the CPU backend added, which phase 3(b) compares with."""
    plats = os.environ.get("JAX_PLATFORMS") or "cuda"
    return plats if "cpu" in plats.split(",") else plats + ",cpu"


# ---------------------------------------------------------------------------
# Phases (run in the child that holds the card)
# ---------------------------------------------------------------------------

def phase_device(n_cards: int = 1) -> dict:
    import jax
    devs = jax.devices()
    d0 = devs[0]
    check(d0.platform == "gpu",
          f"JAX's default device is {d0.platform} ({d0.device_kind}), not a GPU")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX has {len(devs)}")
    log(f"phase 1 device: {d0.device_kind} x{len(devs)}, jax {jax.__version__}")
    log("  no dot/einsum on the hot path: TF32 does not enter")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


def f32_search(case):
    from eigensolver_tpu.search import SearchConfig
    return SearchConfig(n_omega=case.grid.n_omega_ladder,
                        n_bisect=case.grid.n_bisect,
                        scan_dtype="float32", polish_dtype="float32")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_main_path(real_cases, complex_case) -> dict:
    """Each case twice through its entry point: the first call compiles,
    the second is the steady wall."""
    import numpy as np

    from eigensolver_tpu.sweep import run_case, run_case_complex
    out = {}
    for case in real_cases:
        cfg = f32_search(case)
        run = lambda: run_case(case, cfg, refine_f64=True)   # noqa: E731
        _, first = _timed(run)
        (rs, st), wall = _timed(run)
        counts = rs.counts()
        log(f"phase 2 {case.name}: compile+first {first:.2f} s, steady "
            f"{wall:.3f} s, {st.n_candidates} candidates "
            f"({st.n_candidates / wall:.4g}/s), roots {counts}")
        check(sum(counts.values()) > 0, f"{case.name}: no roots")
        for name, br in rs.branches.items():
            check(np.all(np.isfinite(br.omegas)),
                  f"{case.name} {name}: non-finite roots")
        out[case.name] = dict(first_s=first, wall_s=wall, counts=counts,
                              candidates=st.n_candidates)
    run = lambda: run_case_complex(complex_case)   # noqa: E731
    _, first = _timed(run)
    (rs, st), wall = _timed(run)
    comp = st.completeness
    log(f"phase 2 {complex_case.name}: compile+first {first:.2f} s, steady "
        f"{wall:.3f} s, {st.n_candidates} Newton seeds, roots {rs.counts()}, "
        f"argument-principle audit {comp}")
    check(comp["checked"] > 0 and comp["agree"] == comp["checked"]
          and comp["missed"] == 0, f"complex audit failed: {comp}")
    for name, br in rs.branches.items():
        check(np.all(np.isfinite(br.omegas)) and np.all(np.isfinite(br.omegas_imag)),
              f"{complex_case.name} {name}: non-finite roots")
    out[complex_case.name] = dict(first_s=first, wall_s=wall,
                                  counts=rs.counts(), audit=comp)
    return out


def phase_oracles(families) -> dict:
    """(a) f64-refined roots of uniform-limit cases vs the analytic
    relations, by the nearest-zero matcher. families: [(case, geometry)]."""
    import numpy as np

    from eigensolver_tpu.analytic import analytic_deviation
    from eigensolver_tpu.sweep import run_case
    log(f"phase 3a tolerances: median <= {ORACLE_MEDIAN:g}, max <= "
        f"{ORACLE_MAX:g} (f32 scan+polish, f64 refine)")
    out = {}
    for case, geometry in families:
        rs, _ = run_case(case, f32_search(case), refine_f64=True)
        for name, br in rs.branches.items():
            parity = 0 if name == "sausage" else 1
            dev = analytic_deviation(case.regime, br.omegas, br.ks, parity,
                                     geometry)
            ok = np.isfinite(dev)
            med = float(np.median(dev[ok])) if ok.any() else float("nan")
            mx = float(np.max(dev[ok])) if ok.any() else float("nan")
            log(f"phase 3a {case.name} {name}: {int(ok.sum())}/{len(dev)} "
                f"matched, median {med:.3g}, max {mx:.3g}")
            check(len(dev) > 0 and ok.all(),
                  f"{case.name} {name}: {int((~ok).sum())} roots with no "
                  f"analytic zero within 0.5%")
            check(med <= ORACLE_MEDIAN and mx <= ORACLE_MAX,
                  f"{case.name} {name}: median {med:.3g} / max {mx:.3g}")
            out[f"{case.name}/{name}"] = dict(n=len(dev), median=med, max=mx)
    return out


def _paired(a, b):
    """Max relative difference of two root branches, paired after sorting
    by (k, omega); None when the counts differ."""
    import numpy as np
    if len(a.omegas) != len(b.omegas):
        return None
    ia = np.lexsort((a.omegas, a.ks))
    ib = np.lexsort((b.omegas, b.ks))
    rel = np.abs(a.omegas[ia] - b.omegas[ib]) / np.abs(b.omegas[ib])
    return rel, a.omegas[ia] == b.omegas[ib]


def phase_cpu_vs_gpu(case) -> dict:
    """(b) the same f64 scan+polish on the default device and on the CPU
    backend of this process: equal counts per branch, <= CPU_GPU_MAX."""
    import jax
    import numpy as np

    from eigensolver_tpu.search import SearchConfig
    from eigensolver_tpu.sweep import run_case
    cfg = SearchConfig(n_omega=case.grid.n_omega_ladder,
                       n_bisect=case.grid.n_bisect)
    check(jax.config.jax_enable_x64, "phase 3b needs jax_enable_x64")
    log(f"phase 3b tolerance: max relative difference <= {CPU_GPU_MAX:g} "
        f"(f64 scan and polish, {len(case.k_grid())} k values)")
    rs_dev, _ = run_case(case, cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        rs_cpu, _ = run_case(case, cfg)
    out = {}
    for name in rs_dev.branches:
        a, b = rs_dev[name], rs_cpu[name]
        pair = _paired(a, b)
        check(pair is not None, f"3b {name}: {len(a)} roots on "
              f"{jax.devices()[0].platform}, {len(b)} on the CPU")
        rel, _ = pair
        mx = float(rel.max()) if len(rel) else 0.0
        log(f"phase 3b {case.name} {name}: {len(a)} roots on both, max "
            f"relative difference {mx:.3g}")
        check(len(a) > 0 and mx <= CPU_GPU_MAX, f"3b {name}: max {mx:.3g}")
        out[name] = dict(n=len(a), max_rel=mx)
    return out


def dispatch_memory(case, cfg, label) -> dict:
    """compiled.memory_analysis() of one fused search dispatch of a case."""
    import jax.numpy as jnp

    from eigensolver_tpu.search import _search_pipeline, pad_rows
    from eigensolver_tpu.sweep import build_ladders, make_dispersion_moded
    dt = jnp.dtype(cfg.scan_dtype)
    omegas, ks = build_ladders(case, cfg.n_omega)
    rows = omegas.shape[0]
    modes = case.modes
    om = jnp.concatenate([omegas] * len(modes)).astype(dt)
    kk = jnp.concatenate([ks] * len(modes)).astype(dt)
    md = jnp.concatenate([jnp.full((rows,), float(m)) for m in modes]).astype(dt)
    om, kk, md = pad_rows(om, kk, md, 128)
    disp = make_dispersion_moded(case, dt)
    pipe = _search_pipeline(disp, disp, cfg)
    ma = pipe.lower(om, kk, md).compile().memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in
           ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
    log(f"phase 4 {label}: dispatch {tuple(om.shape)} -> "
        + ", ".join(f"{k[:-9]} {v / 2**20:.1f} MiB" for k, v in mem.items()))
    return dict(shape=list(om.shape), **mem)


def phase_memory(largest, flow_case) -> dict:
    """Largest phase-2 sweep, and the cylinder-flow dispatch at 1792 rows x
    1519 omega (the largest shape the reproduction runs record)."""
    from eigensolver_tpu.search import SearchConfig
    out = {"largest": dispatch_memory(largest, f32_search(largest),
                                      largest.name)}
    cfg = SearchConfig(n_omega=flow_case.grid.n_omega_ladder, n_bisect=18,
                       max_brackets_per_row=24, scan_dtype="float32",
                       polish_dtype="float32", fuzz_accept_pct=6.0,
                       fuzz_stride=22)
    out["flow"] = dispatch_memory(flow_case, cfg, flow_case.name)
    return out


def phase_four_cards(case, n_cards: int = 4) -> dict:
    """run_case_sharded over a 1-D mesh of n_cards vs run_case on device 0,
    both f32 scan+polish: equal counts per branch, <= SHARDED_MAX."""
    import numpy as np

    from eigensolver_tpu.parallel import make_mesh, run_case_sharded
    from eigensolver_tpu.sweep import run_case
    cfg = f32_search(case)
    mesh = make_mesh(n_cards)
    one = lambda: run_case(case, cfg)                            # noqa: E731
    many = lambda: run_case_sharded(case, mesh, cfg)             # noqa: E731
    _, first1 = _timed(one)
    (rs1, _), wall1 = _timed(one)
    _, first4 = _timed(many)
    (rs4, st4), wall4 = _timed(many)
    log(f"phase 6 tolerance: max relative difference <= {SHARDED_MAX:g} "
        f"(f32 polish), {st4.n_candidates} candidates")
    log(f"phase 6 wall on 1 card: {wall1:.3f} s (compile+first {first1:.2f} s)")
    log(f"phase 6 wall on {n_cards} cards: {wall4:.3f} s (compile+first "
        f"{first4:.2f} s)")
    out = {"wall_1": wall1, f"wall_{n_cards}": wall4}
    for name in rs1.branches:
        pair = _paired(rs4[name], rs1[name])
        check(pair is not None, f"phase 6 {name}: {len(rs4[name])} roots "
              f"sharded, {len(rs1[name])} on one card")
        rel, same = pair
        mx = float(rel.max()) if len(rel) else 0.0
        share = float(np.mean(same)) if len(same) else 1.0
        log(f"phase 6 {name}: {len(rel)} roots on both, max relative "
            f"difference {mx:.3g}, bit-identical share {share:.4f}")
        check(len(rel) > 0 and mx <= SHARDED_MAX, f"phase 6 {name}: {mx:.3g}")
        out[name] = dict(n=len(rel), max_rel=mx, identical=share)
    return out


def run_phases(four_cards: bool) -> dict:
    """The child's work: every JAX phase in one process. Returns the device
    record of the contract line."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from eigensolver_tpu import cases
    from eigensolver_tpu.utils import enable_compile_cache
    device = phase_device(4 if four_cards else 1)
    enable_compile_cache()
    if four_cards:
        phase_four_cards(cases.cylinder_density_coronal(width=0.9))
        return device
    cyl = cases.cylinder_density_coronal(width=0.9)
    flow = cases.cylinder_flow_coronal(U=1.0)
    phases = [
        ("2", lambda: phase_main_path(
            [cases.slab_density_photospheric(width=0.9), cyl,
             cases.cylinder_twisted_photospheric(v_twist=0.1, power=1.0,
                                                 mode=1)],
            cases.slab_flow_complex_coronal())),
        # uniform-limit windows of tools/accuracy_report.py (ACCURACY_r05)
        ("3a", lambda: phase_oracles([
            (dataclasses.replace(cases.slab_density_photospheric(width=1e5),
                                 speeds=(0.905, 0.93, 0.955, 0.98, 0.9995)),
             "slab"),
            (dataclasses.replace(cases.cylinder_density_coronal(width=1e5),
                                 speeds=(0.9, 0.95, 0.9995, 2.05, 2.5, 3.0,
                                         3.5, 4.0, 4.5, 4.95)),
             "cylinder")])),
        ("3b", lambda: phase_cpu_vs_gpu(dataclasses.replace(
            cyl, k_values=tuple(float(k) for k in cyl.k_grid()[::15])))),
        ("4", lambda: phase_memory(cyl, dataclasses.replace(
            flow, n_k=68, grid=dataclasses.replace(flow.grid,
                                                   n_omega_ladder=1519)))),
    ]
    for name, run in phases:
        _, took = _timed(run)
        log(f"phase {name} took {took:.1f} s")
    return device


# ---------------------------------------------------------------------------
# Orchestration (no JAX in this process)
# ---------------------------------------------------------------------------

def _child(cmd, env):
    """Run cmd, echoing its output as it comes; return (exit code, its
    last line, which is held back)."""
    with subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          text=True) as p:
        last = ""
        for line in p.stdout:
            if last:
                log(last)
            last = line.rstrip("\n")
    return p.returncode, last


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"usage: chip_smoke.py [--four-cards]; got {unknown}",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    log(f"nvidia-smi: {smi}")
    env = dict(os.environ, JAX_PLATFORMS=_platforms())
    code = ("import json, chip_smoke; "
            f"print(json.dumps(chip_smoke.run_phases({four})))")
    t0 = time.perf_counter()
    rc, last = _child([sys.executable, "-c", code], env)
    if rc:
        log(last)
        log(f"FAILED: phases exited {rc}")
        return rc
    device = json.loads(last)
    log(f"phases took {time.perf_counter() - t0:.1f} s")
    if not four:
        rc, last = _child([sys.executable, "-m", "pytest", "-m", "gpu", "-q",
                           "-p", "no:cacheprovider", "tests"], env)
        log(last)
        if rc:
            log(f"FAILED: pytest -m gpu exited {rc}")
            return rc
        log("phase 5 pytest -m gpu: passed")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
