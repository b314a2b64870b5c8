"""Measure the compact engine's per-page compaction populations and time
cap variants on the bench index (real chip).

The compact engine's decode cost is proportional to the CAPS, not the
populations — every gather/rescan runs at cap size and the header only
checks for overflow (ops/issl_compact.py). The default caps were sized
for safety; this script measures the real populations at the bench
operating point and times tightened variants, so the defaults can sit
~2x above the observed populations instead of ~10x.

Usage: python scripts/compact_caps.py [--page 65536] [--gbp 2.6]
(--gbp loads a scale-rung index, bench_data/scale/, instead of the
bench index). Appends one JSON line per configuration to
scripts/compact_caps_results.jsonl.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def log(msg):
    print(f"[caps] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--page", type=int, default=65536)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--gbp", type=float, default=None,
                    help="measure on a scale-rung index (e.g. 2.6 = the "
                         "mouse rung) instead of the bench index; queries "
                         "are the rung's own candidate guides")
    args = ap.parse_args()

    from crackling_jax.codec import strings_to_sigs
    from crackling_jax.index import load_native
    from crackling_jax.ops.issl_compact import CompactIsslScorer

    if args.gbp is not None:
        # the rung's own query derivation (scale_rung.py): DISTINCT
        # candidate guides — tiling a smaller query file would duplicate
        # queries and inflate the multi-hit populations being measured
        from scale_rung import DATA as SCALE_DATA

        from crackling_jax.index.extract import find_candidate_guides_seq

        tag = f"g{args.gbp:g}b"
        legacy = args.gbp == 2.6 and (SCALE_DATA / "scale.index.npz").exists()
        index_npz = SCALE_DATA / ("scale.index.npz" if legacy
                                  else f"{tag}.index.npz")
        with open(SCALE_DATA / f"{tag}.fa") as fp:
            fp.readline()
            seq = "".join(fp.readline().strip() for _ in range(12000))
        _, _, cand = find_candidate_guides_seq(seq)
        sigs = np.unique(cand & np.uint64((1 << 40) - 1))
        rng = np.random.default_rng(7)
        rng.shuffle(sigs)
    else:
        from bench import ensure_dataset

        index_npz, _issl, qfile = ensure_dataset()
        sigs = strings_to_sigs([s.strip() for s in open(qfile)], 20)
    index = load_native(str(index_npz))
    if len(sigs) < args.page:
        raise SystemExit(f"only {len(sigs)} distinct queries; "
                         f"lower --page below {args.page}")
    sigs = sigs[:args.page]

    results = []

    def timed(tag, **kw):
        sc = CompactIsslScorer(index, max_dist=4, query_page=args.page,
                               **kw)
        sc.score(sigs)                      # compile + warm
        dt = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            sc.score(sigs)
            dt = min(dt, time.time() - t0)
        stats = np.array(sc.page_stats[:1])  # first (only) page
        rec = {"tag": tag, "page": args.page, "gbp": args.gbp,
               "caps": list(sc._caps()),
               "superchunk": sc.superchunk,
               "pops": stats[0].tolist(),
               "t_s": round(dt, 4),
               "guides_per_s": round(args.page / dt, 1)}
        log(json.dumps(rec))
        results.append(rec)
        return rec

    base = timed("default")
    n1, nm, nsc, nsr, nc, n2c, _ = base["pops"]
    log(f"populations: direct={n1} mslot={nm} scell={nsc} sresc={nsr} "
        f"mcell={nc} rescan={n2c}")

    # tight variant: ~2x headroom over measured, rounded up to 1K
    def up(x):
        return max(1024, int(-(-2 * x // 1024)) * 1024)

    tight = tuple(up(p) for p in base["pops"])
    timed("tight-2x", caps=tight)
    timed("tight-4x", caps=tuple(2 * c for c in tight))

    with open(ROOT / "scripts" / "compact_caps_results.jsonl", "a") as fp:
        for r in results:
            fp.write(json.dumps(r) + "\n")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
