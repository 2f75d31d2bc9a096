#!/usr/bin/env python
"""Profile one steady sweep on the device and reduce the trace to metrics.

    python tools/trace_sweep.py [case] [--out DIR] [--top N]

case is one of CASES below (default cyl_co_09). The sweep runs once to
compile, then once more inside `jax.profiler.trace` under a host annotation
named "sweep". The `.xplane.pb` is read back with
`jax.profiler.ProfileData` and reduced to one JSON object:

- wall_s: the annotated sweep on the host clock;
- device_busy_s / idle_share: union of the device's kernel intervals, and
  1 - busy / wall over the annotated window;
- device_ops: number of kernel events on the device during the sweep;
- top_ops: kernels by summed device time, with their event counts;
- lines: every plane/line of the trace with its event count, to read the
  trace's layout by hand.
"""
import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, ".")

CASES = {
    "slab_ph_09": ("slab_density_photospheric", dict(width=0.9)),
    "cyl_co_09": ("cylinder_density_coronal", dict(width=0.9)),
    "twist_v01_p1": ("cylinder_twisted_photospheric",
                     dict(v_twist=0.1, power=1.0, mode=1)),
}


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path, top=15):
    """Metrics of one .xplane.pb (see the module docstring)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    lines, window = [], None
    for plane in pd.planes:
        for line in plane.lines:
            evs = list(line.events)
            lines.append(f"{plane.name} | {line.name} | {len(evs)}")
            for ev in evs:
                if ev.name == "sweep":
                    window = (ev.start_ns, ev.end_ns)
    if window is None:
        raise RuntimeError(f"no 'sweep' annotation in {path}")
    kernels = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            kernels += [ev for ev in line.events
                        if window[0] <= ev.start_ns <= window[1]]
    by_name = {}
    for ev in kernels:
        t, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + ev.duration_ns, n + 1)
    busy = _union((ev.start_ns, ev.end_ns) for ev in kernels)
    wall = window[1] - window[0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_s=wall / 1e9, device_busy_s=busy / 1e9,
                idle_share=1.0 - busy / wall if wall else None,
                device_ops=len(kernels),
                top_ops=[dict(name=k[:120], device_s=t / 1e9, count=n)
                         for k, (t, n) in ranked],
                lines=lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", nargs="?", default="cyl_co_09", choices=CASES)
    ap.add_argument("--out", default="chiprun_out/trace")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import jax

    from eigensolver_tpu import cases
    from eigensolver_tpu.search import SearchConfig
    from eigensolver_tpu.sweep import run_case
    from eigensolver_tpu.utils import enable_compile_cache
    enable_compile_cache()

    fac, kw = CASES[args.case]
    case = getattr(cases, fac)(**kw)
    # bench.py's configuration
    cfg = SearchConfig(n_omega=256, n_bisect=18,
                       scan_dtype="float32", polish_dtype="float32")
    run_case(case, cfg)                                   # compile
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        with jax.profiler.TraceAnnotation("sweep"):
            rs, st = run_case(case, cfg)
    wall = time.perf_counter() - t0
    path = max(glob.glob(os.path.join(args.out, "plugins", "profile", "*",
                                      "*.xplane.pb")), key=os.path.getmtime)
    dev = jax.devices()[0]
    rep = dict(case=args.case, device=dict(platform=dev.platform,
                                           kind=dev.device_kind,
                                           count=len(jax.devices())),
               candidates=st.n_candidates, roots=rs.counts(),
               traced_wall_s=wall, trace=path, **reduce_trace(path, args.top))
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
