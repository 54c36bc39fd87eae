"""Render roofline tables from the dry run's results — the counterpart of
``repro.launch.report``.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single] [--results PATH]
    PYTHONPATH=src python -m repro_torch.launch.report --ab OTHER.json   # OTHER → results

The terms are the dry run's counts against the h100 profile
(``launch/roofline.py``), not measurements. Nothing in the port writes a
baseline file (the reference's ``--baseline`` has no counterpart), so
``--ab`` compares against a second results file given by path.
"""
from __future__ import annotations

import argparse
import json
import os

from .dryrun import RESULTS_PATH


def load(path: str):
    return json.load(open(path)) if os.path.exists(path) else {}


def fmt_s(x):
    if x >= 100:
        return f"{x:.0f}"
    if x >= 1:
        return f"{x:.1f}"
    return f"{x:.3f}"


def roofline_table(res, mesh="single"):
    rows = []
    for k, v in sorted(res.items()):
        if not v.get("ok") or v["mesh"] != mesh:
            continue
        r = v["roofline"]
        live = v.get("bytes_per_device_live") or 0
        rows.append(
            (
                f"{v['arch']}|{v['shape']}",
                r["compute_s"],
                r["memory_s"],
                r["collective_s"],
                r["bottleneck"],
                r["useful_flop_ratio"],
                live / 2**30,
                "✓" if v.get("fits_80gb") else ("✗" if v.get("fits_80gb") is False else "?"),
            )
        )
    out = [
        "| cell | compute s | memory s | collective s | bottleneck | useful | GiB/dev | ≤80G |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r[0]} | {fmt_s(r[1])} | {fmt_s(r[2])} | {fmt_s(r[3])} | {r[4]} "
            f"| {r[5]:.2f} | {r[6]:.1f} | {r[7]} |"
        )
    return "\n".join(out)


def ab_table(base, opt, mesh="single"):
    out = [
        "| cell | compute s (b→o) | memory s (b→o) | collective s (b→o) | coll. gain |",
        "|---|---|---|---|---|",
    ]
    for k in sorted(opt):
        v = opt[k]
        b = base.get(k)
        if not v.get("ok") or v["mesh"] != mesh or not b or not b.get("ok"):
            continue
        ro, rb = v["roofline"], b["roofline"]
        gain = rb["collective_s"] / ro["collective_s"] if ro["collective_s"] > 1e-9 else float("inf")
        out.append(
            f"| {v['arch']}|{v['shape']} | {fmt_s(rb['compute_s'])}→{fmt_s(ro['compute_s'])} "
            f"| {fmt_s(rb['memory_s'])}→{fmt_s(ro['memory_s'])} "
            f"| {fmt_s(rb['collective_s'])}→{fmt_s(ro['collective_s'])} | {gain:.1f}× |"
        )
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="roofline tables from the dry run's results")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--results", default=RESULTS_PATH, help="results file (default: dryrun_results_torch.json)")
    ap.add_argument("--ab", default=None, metavar="BASE", help="a second results file: compare BASE → results")
    args = ap.parse_args(argv)
    res = load(args.results)
    table = ab_table(load(args.ab), res, args.mesh) if args.ab else roofline_table(res, args.mesh)
    print(table)
    return table


if __name__ == "__main__":
    main()
