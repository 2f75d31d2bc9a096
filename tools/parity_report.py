#!/usr/bin/env python
"""Assemble the round-level parity artifacts: PARITY JSON + REPRODUCTION.md.

Inputs: one or more reproduce.py --jsonl files (later files override earlier
ones per target - e.g. a refined flow re-run supersedes the f32 pass) and
one or more ref_recheck.py --out files (merged). Output: the adjudicated
per-root verdict JSON (tools/adjudicate.py schema) and a regenerated
REPRODUCTION.md table covering every target.

Usage:
  python tools/parity_report.py \
      --repro artifacts/repro_r03.jsonl artifacts/repro_r03_flow_refined.jsonl \
      --recheck artifacts/recheck_*.json \
      --out PARITY_r03.json --md REPRODUCTION.md
"""
import argparse
import json
import sys

sys.path.insert(0, ".")

FAMILY_ORDER = ("slab_ph", "slab_co", "slab_flow", "cyl_co", "cyl_ph",
                "cyl_flow", "twist")

HEADER = """# Reference-pickle reproduction status (round 3: all 90 pickles)

`tools/reproduce.py` sweeps each reference case on the pickle's own k grid and
matches every shipped root (within the scanned phase-speed windows) against our
root set at the same k, tolerance 3e-3 relative (8e-3 for the twisted family,
whose first-acceptance offset is percent-level - see notes). Unmatched entries
are adjudicated per root (`tools/adjudicate.py`):

- **disc** (`ref_discretization`): the reference's own scheme re-run at tight
  tolerance (`tools/ref_recheck.py`) puts the root where we put it - the
  pickle entry carries the reference's discretization error;
- **irr** (`ref_irreproducible`): the reference's own scheme, run accurately,
  has no residual dip below 5% near the entry (includes twisted entries in
  the leaky m_e < 0 region its own guard skips);
- **cont** (`continuum_artifact`): the entry lies inside a computed continuum
  band (cT/c/vA, Doppler U +- cT, shear critical layer, or the twisted
  (k,m)-dependent Doppler Alfven/cusp ranges) where the reference's
  percent-tolerance acceptance records integrator-noise swaths, and the
  recheck confirms no true zero there;
- **MISS**: a genuine miss of ours.

`non-art rate` = matched / (total - disc - irr - cont): the fraction of
adjudicated-real reference roots we reproduce. Medians are relative
eigenvalue errors of matched roots ("refined" = f64 host re-bisection,
`--refine`).

"""


def fam(target):
    for f in FAMILY_ORDER:
        if target.startswith(f):
            return FAMILY_ORDER.index(f)
    return len(FAMILY_ORDER)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repro", nargs="+", required=True)
    ap.add_argument("--recheck", nargs="*", default=[])
    ap.add_argument("--refined", nargs="*", default=[],
                    help="extra reproduce --refine jsonl files: medians shown "
                         "in the 'refined median' column (do not override "
                         "the main pass rows)")
    ap.add_argument("--oracle", nargs="*", default=[],
                    help="tools/oracle_cylflow.py --out files (third-scheme "
                         "arbitration, merged)")
    ap.add_argument("--out", default="PARITY_r03.json")
    ap.add_argument("--md", default=None)
    args = ap.parse_args()

    reports = {}
    refined_src = {}
    for path in args.repro:
        with open(path) as f:
            for line in f:
                try:
                    rep = json.loads(line)
                except ValueError:
                    continue
                if rep.get("error"):
                    continue
                reports[rep["target"]] = rep
    for path in args.refined:
        with open(path) as f:
            for line in f:
                try:
                    rep = json.loads(line)
                except ValueError:
                    continue
                if not rep.get("error"):
                    refined_src[rep["target"]] = rep

    recheck = {}
    for path in args.recheck:
        detail = json.load(open(path)).get("detail", {})
        for name, rows in detail.items():
            recheck.setdefault(name, []).extend(rows)

    oracle = {}
    for path in args.oracle:
        detail = json.load(open(path)).get("detail", {})
        for name, rows in detail.items():
            oracle.setdefault(name, []).extend(rows)

    from tools.adjudicate import adjudicate
    result = adjudicate(list(reports.values()), recheck,
                        oracle_detail=oracle)
    json.dump(result, open(args.out, "w"), indent=1)

    n_targets = len([k for k in result if not k.startswith("_")])
    lines = []
    tot = dict(total=0, matched=0, disc=0, irr=0, cont=0, miss=0)
    worst = []
    for name in sorted(result, key=lambda t: (fam(t), t)):
        if name.startswith("_"):       # reserved keys (e.g. _sensitivity)
            continue
        tgt = result[name]
        for br, b in tgt["branches"].items():
            c = b["counts"]
            denom = b["total"] - (c["ref_discretization"]
                                  + c["ref_irreproducible"]
                                  + c["continuum_artifact"])
            rate = b["rate_non_artifact"]
            med = b["median_rel_err"]
            ref_med = refined_src.get(name, {}).get(br, {}).get(
                "median_rel_err")
            tot["total"] += b["total"]
            tot["matched"] += c["matched"]
            tot["disc"] += c["ref_discretization"]
            tot["irr"] += c["ref_irreproducible"]
            tot["cont"] += c["continuum_artifact"]
            tot["miss"] += c["MISSED"]
            if rate is not None and rate < 0.99:
                worst.append((name, br, rate, c["MISSED"]))
            lines.append(
                f"| {name} | {br} | {c['matched']}/{b['total']} "
                f"| {c['ref_discretization']} | {c['ref_irreproducible']} "
                f"| {c['continuum_artifact']} | {c['MISSED']} "
                f"| {'-' if rate is None else f'{100 * rate:.1f}%'} "
                f"| {'-' if med is None else f'{med:.1e}'} "
                f"| {'-' if ref_med is None else f'{ref_med:.1e}'} |")

    grand_denom = tot["total"] - tot["disc"] - tot["irr"] - tot["cont"]
    summary = (
        f"**{n_targets} targets / {tot['total']} shipped roots: "
        f"{tot['matched']} matched, {tot['disc']} reference-discretization, "
        f"{tot['irr']} irreproducible, {tot['cont']} continuum artifacts, "
        f"{tot['miss']} genuine misses -> overall non-artifact match rate "
        f"{100 * tot['matched'] / grand_denom:.2f}%.**\n")

    if args.md:
        md = [HEADER, summary, ""]
        md.append("| Target | Branch | Matched | disc | irr | cont | MISS "
                  "| non-art rate | median | refined median |")
        md.append("|---|---|---|---|---|---|---|---|---|---|")
        md.extend(lines)
        md.append("")
        if worst:
            md.append("Branches below the 99% non-artifact bar:")
            for name, br, rate, miss in sorted(worst, key=lambda t: t[2]):
                md.append(f"- {name}/{br}: {100 * rate:.1f}% "
                          f"({miss} adjudicated-genuine misses)")
            md.append("")
        with open(args.md + ".table", "w") as f:
            f.write("\n".join(md))
        print(f"# wrote {args.md}.table (merge into {args.md})",
              file=sys.stderr)
    print(summary)
    for name, br, rate, miss in sorted(worst, key=lambda t: t[2]):
        print(f"below-bar {name}/{br}: {rate} ({miss} missed)")
    print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
