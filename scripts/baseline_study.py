"""Controlled same-day reference-baseline study.

Round 3 left the deep-rung C++ baselines unsettled: clean-but-separate
timings gave mouse 58.4 guides/s and human 339 guides/s at nearly equal
index size (111.3M vs 112.2M distinct sites) — an unexplained 6x spread
that bounds the deep-rung ratio only to 54x-317x. This script times both
rungs under identical, interleaved conditions so rung-to-rung differences
can't be explained by host drift:

  for round in 1..R:                 # alternation cancels slow drift
      for rung in (mouse, human):
          t1 = isslScoreOfftargets(issl, q1, 4, 75, and)   # N queries
          t5 = isslScoreOfftargets(issl, q5, ...)          # 5N queries
          rate = 4N / (t5 - t1)      # load time cancels

The same 4,096-query file the ladder rows used (bench_data/scale/
{tag}.q1.txt) is reused verbatim; 1-minute load average and /proc/stat
cpu time are sampled around every run so a loaded host is visible in the
record. Per-round rates plus min/median summaries are appended to
scripts/baseline_study_results.jsonl.

Run on a QUIET host (no concurrent compiles or index builds).

Usage: python scripts/baseline_study.py [--rounds 3] [--rungs 2.6 3.1]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "bench_data" / "scale"
REFBIN = ROOT / "bench_data" / "refbin" / "isslScoreOfftargets"


def log(msg):
    print(f"[study] {msg}", file=sys.stderr, flush=True)


def loadavg():
    return round(os.getloadavg()[0], 2)


def run_once(issl, qf, method="and"):
    t0 = time.time()
    subprocess.run([str(REFBIN), str(issl), str(qf), "4", "75", method],
                   check=True, capture_output=True)
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--rungs", type=float, nargs="+", default=[2.6, 3.1])
    ap.add_argument("--n", type=int, default=4096,
                    help="query count (must match an existing q1 file)")
    args = ap.parse_args()

    rungs = {}
    for gbp in args.rungs:
        tag = f"g{gbp:g}b"
        legacy = gbp == 2.6 and (DATA / "scale.issl").exists()
        issl = DATA / ("scale.issl" if legacy else f"{tag}.issl")
        q1 = DATA / f"{tag}.q1.txt"
        for p in (issl, q1):
            if not p.exists():
                raise SystemExit(f"missing rung artifact: {p} "
                                 "(run scripts/scale_rung.py first)")
        nq = sum(1 for _ in open(q1))
        if nq != args.n:
            raise SystemExit(f"{q1} has {nq} queries, expected {args.n}")
        q5 = DATA / f"{tag}.q5.txt"
        if not q5.exists():
            q5.write_text(q1.read_text() * 5)
        rungs[gbp] = (issl, q1, q5)

    rec = {"date": time.strftime("%Y-%m-%d"),
           "n_queries": args.n, "rounds": args.rounds,
           "nproc": os.cpu_count(), "per_round": []}

    # one warm pass per rung primes the .issl page cache
    for gbp, (issl, q1, _) in rungs.items():
        log(f"warm g{gbp:g}b (load {loadavg()})")
        dt = run_once(issl, q1)
        log(f"  warm t(N) = {dt:.0f}s")

    for r in range(args.rounds):
        for gbp, (issl, q1, q5) in rungs.items():
            la0 = loadavg()
            t1 = run_once(issl, q1)
            t5 = run_once(issl, q5)
            la1 = loadavg()
            rate = 4 * args.n / max(t5 - t1, 1e-9)
            row = {"round": r, "gbp": gbp, "t1_s": round(t1, 1),
                   "t5_s": round(t5, 1), "guides_per_s": round(rate, 1),
                   "load_before": la0, "load_after": la1}
            log(json.dumps(row))
            rec["per_round"].append(row)

    for gbp in rungs:
        rates = sorted(row["guides_per_s"] for row in rec["per_round"]
                       if row["gbp"] == gbp)
        rec[f"g{gbp:g}b_best"] = rates[-1]
        rec[f"g{gbp:g}b_median"] = rates[len(rates) // 2]
    log(json.dumps({k: v for k, v in rec.items() if k != "per_round"}))

    with open(ROOT / "scripts" / "baseline_study_results.jsonl", "a") as fp:
        fp.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
