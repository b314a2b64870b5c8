"""Regenerate the published performance table from the measurement records.

Hand-maintained tables lag the records, so the published ladder is a
pure function of them:

* ladder rows come from the LATEST entry per (rung, engine) in
  ``scripts/scale_rung_results.jsonl``;
* the deep-rung (2.6/3.1 Gbp) reference baselines come from the
  controlled interleaved study (``baseline_study_results.jsonl`` —
  best-of-rounds with load recorded), not ad-hoc single timings.

It rewrites the block between ``<!-- BEGIN GENERATED: perf-ladder -->``
/ ``<!-- END GENERATED: perf-ladder -->`` markers in README.md. Run
after any measurement lands:

    python scripts/regen_tables.py        # rewrite in place
    python scripts/regen_tables.py --check   # CI mode: fail if stale
"""

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUNG_NAMES = {
    0.0046: ("E. coli scale (4.6 Mbp)", "E. coli (4.6 Mbp)"),
    0.012: ("S. cerevisiae scale (12 Mbp)", "yeast (12 Mbp)"),
    0.14: ("D. melanogaster scale (140 Mbp)", "fly (140 Mbp)"),
    1.0: ("crossover sweep (1.0 Gbp)", "mid-depth (1.0 Gbp, sweep)"),
    2.6: ("mouse scale (2.6 Gbp, repeat-rich)", "mouse (2.6 Gbp, repeat-rich)"),
    3.1: ("human scale (3.1 Gbp)", "human (3.1 Gbp)"),
}
DEEP_RUNGS = (2.6, 3.1)


def load_jsonl(path):
    p = ROOT / "scripts" / path
    if not p.exists():
        return []
    return [json.loads(l) for l in p.read_text().splitlines() if l.strip()]


def latest_rung_rows():
    """{gbp: {engine: record}} — the latest record per (rung, engine),
    method='and' only (the ladder's operating point)."""
    rows = {}
    for rec in load_jsonl("scale_rung_results.jsonl"):
        if rec.get("method", "and") != "and":
            continue
        gbp = rec.get("genome_gbp")
        eng = rec.get("engine", "pallas")
        if rec.get("hybrid_fast"):
            eng = f"hybrid-{rec['hybrid_fast']}"
        if gbp not in RUNG_NAMES:
            continue
        rows.setdefault(gbp, {})[eng] = rec   # later lines overwrite
    return rows


def controlled_baselines():
    """Deep-rung reference baselines from the interleaved study:
    {gbp: (best, median, date)}. Uses the latest study record."""
    recs = load_jsonl("baseline_study_results.jsonl")
    if not recs:
        return {}
    rec = recs[-1]
    out = {}
    for gbp in DEEP_RUNGS:
        key = f"g{gbp:g}b_best"
        if key in rec:
            out[gbp] = (rec[key], rec.get(f"g{gbp:g}b_median"),
                        rec.get("date"))
    return out


def fmt_rate(x):
    if x is None:
        return "—"
    if x >= 10000:
        return f"{x / 1000:,.0f} K"
    if x >= 1000:
        return f"{x:,.0f}"
    return f"{x:,.1f}" if x < 100 else f"{x:,.0f}"


def baseline_of(gbp, recs, controlled):
    """(rate, label): the controlled-study best for deep rungs, the
    same-day jsonl baseline otherwise."""
    if gbp in controlled:
        best, med, date = controlled[gbp]
        return best, f"{best:,.0f} (controlled study best; median {med:,.0f})"
    # shallow rungs: the latest same-day reference timing of any engine row
    rates = [r.get("ref_guides_per_s") for r in recs.values()
             if r.get("ref_guides_per_s")]
    if not rates:
        return None, "—"
    rate = rates[-1]
    return rate, fmt_rate(rate)


def build_ladder_table():
    rungs = latest_rung_rows()
    controlled = controlled_baselines()
    if not rungs:
        return ("No ladder record yet: `scripts/scale_rung.py` appends one "
                "per rung and engine.")
    lines = [
        "| Genome scale | distinct sites | best engine (1 GPU) | "
        "pipeline path (hybrid) | reference (4 cores) | best ratio |",
        "|---|---|---|---|---|---|",
    ]
    for gbp in sorted(rungs):
        recs = rungs[gbp]
        name = RUNG_NAMES[gbp][1]
        sites = max(r.get("distinct_sites", 0) for r in recs.values())
        fast = {e: r for e, r in recs.items()
                if not e.startswith("hybrid")}
        best_eng, best = max(
            ((e, r) for e, r in fast.items()),
            key=lambda kv: kv[1].get("ours_guides_per_s", 0))
        hyb = {e: r for e, r in recs.items() if e.startswith("hybrid")}
        hyb_cell = "—"
        if hyb:
            he, hr = max(hyb.items(),
                         key=lambda kv: kv[1].get("ours_guides_per_s", 0))
            hyb_cell = (f"{fmt_rate(hr['ours_guides_per_s'])} "
                        f"({he.split('-')[1]}+re-score)")
        ref_rate, ref_label = baseline_of(gbp, recs, controlled)
        ratio = (f"**{best['ours_guides_per_s'] / ref_rate:,.1f}x**"
                 if ref_rate else "—")
        sites_s = f"{sites / 1e6:.1f} M" if sites >= 1e6 else f"{sites / 1e3:.0f} K"
        lines.append(
            f"| {name} | {sites_s} | "
            f"{fmt_rate(best['ours_guides_per_s'])} ({best_eng}) | "
            f"{hyb_cell} | {ref_label} | {ratio} |")
    return "\n".join(lines)


MARK = ("<!-- BEGIN GENERATED: perf-ladder -->",
        "<!-- END GENERATED: perf-ladder -->")


def generated_block():
    controlled = controlled_baselines()
    note = ""
    if controlled and latest_rung_rows():
        date = next(iter(controlled.values()))[2]
        note = (
            "\nDeep-rung reference baselines are from the controlled "
            f"interleaved study of {date} "
            "(`scripts/baseline_study_results.jsonl`: 3 rounds "
            "alternating mouse/human with host load recorded; best round "
            "quoted, so the ratios are conservative).\n")
    return "\n".join([
        MARK[0],
        "<!-- Generated by scripts/regen_tables.py — edit the jsonl "
        "records, not this block. -->",
        "", build_ladder_table(), note, MARK[1]])


def splice(path, block):
    text = path.read_text()
    pat = re.compile(re.escape(MARK[0]) + r".*?" + re.escape(MARK[1]),
                     re.DOTALL)
    if not pat.search(text):
        raise SystemExit(f"{path}: no generated-block markers")
    new = pat.sub(lambda _: block, text)
    return text, new


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) if any published table is stale")
    args = ap.parse_args()
    block = generated_block()
    stale = []
    for name in ("README.md",):
        path = ROOT / name
        old, new = splice(path, block)
        if old != new:
            if args.check:
                stale.append(name)
            else:
                path.write_text(new)
                print(f"updated {name}")
        else:
            print(f"{name} up to date")
    if stale:
        print(f"STALE: {', '.join(stale)} — run scripts/regen_tables.py")
        sys.exit(1)


if __name__ == "__main__":
    main()
