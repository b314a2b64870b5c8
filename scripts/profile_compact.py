"""Per-stage timing of the compact engine on a deep (scale-rung) index.

The compact engine's page time is kernel (phase 1) + moment decode
(phase 2, stages 1-3). `ops.issl_compact._STAGES` ablates the decode at
trace time (1 = single-hit slots only, 2 = + superchunk/chunk cells,
3 = full rescan), so timing the three variants in ONE process (one
index upload) attributes the page time to stages. A caps variant sized
from the measured populations is timed last.

Usage: python scripts/profile_compact.py [--gbp 2.6] [--page 16384]
Appends JSON lines to scripts/profile_compact_results.jsonl.
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
    print(f"[prof] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=2.6)
    ap.add_argument("--bench", action="store_true",
                    help="profile the 27 Mbp bench operating point "
                         "(bench.bench_point) instead of a scale rung")
    ap.add_argument("--page", type=int, default=16384)
    ap.add_argument("--caps", default=None,
                    help="comma-separated 7 caps; default: the mouse-"
                         "rung fixed caps (rung mode) or auto (bench)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from scale_rung import DATA as SCALE_DATA

    from crackling_jax.index import load_native
    from crackling_jax.index.extract import find_candidate_guides_seq
    from crackling_jax.ops import issl_compact
    from crackling_jax.ops.issl_compact import CompactIsslScorer

    if args.bench:
        from bench import bench_point

        _, index, sigs, _ = bench_point()
        sigs = sigs[: args.page]
    else:
        tag = f"g{args.gbp:g}b"
        legacy = (args.gbp == 2.6
                  and (SCALE_DATA / "scale.index.npz").exists())
        index_npz = SCALE_DATA / ("scale.index.npz" if legacy
                                  else f"{tag}.index.npz")
        index = load_native(str(index_npz))
        with open(SCALE_DATA / f"{tag}.fa") as fp:
            fp.readline()
            seq = "".join(fp.readline().strip() for _ in range(12000))
        _, _, cand = find_candidate_guides_seq(seq)
        sigs = np.unique(cand & np.uint64((1 << 40) - 1))
        rng = np.random.default_rng(7)
        rng.shuffle(sigs)
        sigs = sigs[: args.page]

    results = []

    def timed(tag_, stages, **kw):
        issl_compact._STAGES = stages
        try:
            sc = CompactIsslScorer(index, max_dist=4,
                                   query_page=args.page, **kw)
            t0 = time.time()
            sc.score_sums(sigs)
            log(f"{tag_}: compile+warm {time.time() - t0:.0f}s")
            dt = float("inf")
            for _ in range(args.repeats):
                t0 = time.time()
                sc.score_sums(sigs)
                dt = min(dt, time.time() - t0)
            rec = {"tag": tag_, "gbp": args.gbp, "page": args.page,
                   "stages": stages, "caps": list(sc._caps()),
                   "pops": list(sc.page_stats[0]),
                   "splits": len(sc.page_stats) - 1,
                   "t_s": round(dt, 4),
                   "guides_per_s": round(args.page / dt, 1)}
        finally:
            issl_compact._STAGES = 3
        log(json.dumps(rec))
        results.append(rec)
        return rec

    # stage ablation at generous caps (no splits): kernel+slots / +cells
    # / full. pops measured by the earlier run at this operating point —
    # cap ~1.5x above so the page never splits and decode cost is the
    # caps', not the overflow path's
    if args.caps:
        caps = tuple(int(c) for c in args.caps.split(","))
    elif args.bench:
        # the 64K-page bench-point populations (compact_caps study)
        # quantized ~1.5x up
        caps = (131072, 65536, 131072, 65536, 131072, 65536, 262144)
    else:
        caps = (32768, 98304, 311296, 131072, 327680, 65536, 196608)
    timed("stage1", 1, caps=caps)
    timed("stage2", 2, caps=caps)
    timed("stage3", 3, caps=caps)

    with open(ROOT / "scripts" / "profile_compact_results.jsonl", "a") as fp:
        for r in results:
            fp.write(json.dumps(r) + "\n")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
