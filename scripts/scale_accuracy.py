"""Quantify fast-engine score deviation at genome scale vs the reference
binary output saved by scale_rung.py.

Score error can compound with bucket depth and occurrence mass. This
probe loads a rung's cached index + query set + reference output and
reports, per engine:

* throughput (min over repeats, on the accelerator),
* verdict agreement and max/mean |score delta| over ACCEPTED guides
  (the reference's full sums — rejected guides carry frozen early-exit
  partials, a documented Tier-3 deviation, so deltas there are
  expected and meaningless),
* the count of guides whose fast score sits further than the hybrid
  re-score band (the compact engine's score_band) from the threshold
  *on the wrong side* — the only way a hybrid verdict can differ from
  the binary.

Usage: python scripts/scale_accuracy.py [--tag g2.6b] [--engines compact]
Appends one JSON line per engine to scripts/scale_accuracy_results.jsonl.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DATA = ROOT / "bench_data" / "scale"


def log(msg):
    print(f"[acc] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="g2.6b")
    ap.add_argument("--engines", nargs="+", default=["compact"],
                    choices=["compact"])
    ap.add_argument("--threshold", type=float, default=75.0)
    ap.add_argument("--band", type=float, default=0.05)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from crackling_jax.codec import strings_to_sigs
    from crackling_jax.index import load_native

    refout = sorted(DATA.glob(f"{args.tag}.refout*.txt"))
    if not refout:
        raise SystemExit(f"no {args.tag}.refout*.txt — run scale_rung first")
    refout = refout[0]
    lines = refout.read_text().strip().split("\n")
    ref_mit = np.array([float(l.split("\t")[1]) for l in lines])
    ref_cfd = np.array([float(l.split("\t")[2]) for l in lines])
    queries = strings_to_sigs([l.split("\t")[0] for l in lines], 20)
    log(f"{len(queries)} reference-scored queries from {refout.name}")

    log("loading index")
    index = load_native(str(DATA / f"{args.tag}.index.npz"))
    log(f"{index.num_sites:,} distinct sites")

    thr = args.threshold
    ref_ok = (ref_mit >= thr) & (ref_cfd >= thr)
    results = []
    for name in args.engines:
        from crackling_jax.ops.issl_compact import (CompactIsslScorer,
                                                    DepthBoundError)
        try:
            eng = CompactIsslScorer(index, max_dist=4)
        except DepthBoundError as e:
            log(f"compact unavailable: {e}")
            results.append({"tag": args.tag, "engine": name,
                            "error": str(e)})
            continue
        t0 = time.time()
        mit, cfd = eng.score(queries)
        log(f"{name}: compile+warm {time.time() - t0:.0f}s")
        dt = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            mit, cfd = eng.score(queries)
            dt = min(dt, time.time() - t0)
        our_ok = (mit >= thr) & (cfd >= thr)
        verdict_agree = float(np.mean(our_ok == ref_ok))
        acc = ref_ok & our_ok
        d = np.maximum(np.abs(mit - ref_mit), np.abs(cfd - ref_cfd))
        # hybrid escape: wrong verdict AND fast score outside the band
        esc = (our_ok != ref_ok) & (
            np.minimum(np.abs(mit - thr), np.abs(cfd - thr)) > args.band)
        rec = {
            "tag": args.tag, "engine": name,
            "n": int(len(queries)),
            "guides_per_s": round(len(queries) / dt, 1),
            "verdict_agreement": verdict_agree,
            "accepted_dev_max": round(float(d[acc].max()), 5)
            if acc.any() else None,
            "accepted_dev_mean": round(float(d[acc].mean()), 6)
            if acc.any() else None,
            "accepted_agree_002": round(float((d[acc] < 2e-2).mean()), 4)
            if acc.any() else None,
            "hybrid_band_escapes": int(esc.sum()),
        }
        log(json.dumps(rec))
        results.append(rec)
        del eng

    with open(ROOT / "scripts" / "scale_accuracy_results.jsonl", "a") as fp:
        for r in results:
            fp.write(json.dumps(r) + "\n")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
