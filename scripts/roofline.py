"""Roofline accounting for the compact engine's finder at the bench point.

For a measured finder time this script computes what the finder *moves
and computes* per query page, and compares it with the card's peaks:

* **device-memory bytes/page**: each (slice-bucket, chunk, query tile)
  block reads its chunk's packed lo/hi words (8 B per entry) once, so
  the entry planes are read ``qb / 64`` times per page (L2 serves part
  of that; the count is an upper bound on DRAM traffic);
* **integer ops/page**: every (entry, query slot) pair of a bucket costs
  ``OPS_PER_PAIR`` integer operations in ``_hit_mask`` and the moment
  reductions (XOR, pair-OR collapse, two popcounts, the SWAR dedup
  test, the compares and the count/min/max updates), counted in the
  source; the compiler fuses some of them (three-input logic ops), so
  the share is an upper estimate. The peak is the SM's issue rate: four
  warp schedulers each issue one 32-lane instruction per clock.

Peaks come from ``PEAKS``, keyed by ``jax.Device.device_kind``; a card
that is not in the table is an error.

Usage:
    python scripts/roofline.py --device-kind "NVIDIA H100 80GB HBM3" \\
        --finder-ms 9.3 [--index bench_data/...index.npz] [--qb 320]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Peaks at the card's boost clock and full power limit: NVIDIA H100 data
# sheet (memory bandwidth) and the Hopper architecture white paper (SM
# count, four schedulers x 32 lanes issued per SM per clock, boost
# clock). A card run below its maximum power limit cannot hold the boost
# clock under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(part="H100 SXM5", hbm_bps=3.35e12,
                                  issue_ops=132 * 128 * 1.98e9),
    "NVIDIA H100 PCIe": dict(part="H100 PCIe", hbm_bps=2.0e12,
                             issue_ops=114 * 128 * 1.755e9),
}

OPS_PER_PAIR = 29
TILE_Q = 64


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise SystemExit(f"no peaks for device kind {device_kind!r}; known: "
                         f"{sorted(PEAKS)}")
    return PEAKS[device_kind]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", required=True)
    ap.add_argument("--finder-ms", type=float, required=True,
                    help="measured finder time for one query page")
    ap.add_argument("--index", default=None,
                    help="native index (.npz); default: the bench point")
    ap.add_argument("--qb", type=int, required=True,
                    help="padded per-bucket query occupancy of the page")
    args = ap.parse_args()
    peaks = peaks_for(args.device_kind)

    from crackling_jax.index import load_native

    if args.index:
        index = load_native(args.index)
    else:
        import bench

        index = bench.bench_point()[1]
    lens = np.diff(index.bucket_offsets, axis=1)
    entries = int(lens.sum())                 # site-slice entries scanned
    pairs = entries * args.qb
    seconds = args.finder_ms / 1e3
    dram_bytes = entries * 8 * (args.qb // TILE_Q)
    ops = pairs * OPS_PER_PAIR
    rec = {
        "device_kind": args.device_kind,
        "part": peaks["part"],
        "distinct_sites": int(index.num_sites),
        "qb": args.qb,
        "finder_ms": args.finder_ms,
        "pairs_per_page": pairs,
        "dram_gb_per_page_upper": round(dram_bytes / 1e9, 3),
        "dram_share_upper": round(dram_bytes / seconds / peaks["hbm_bps"], 4),
        "int_tops_per_page": round(ops / 1e12, 3),
        "issue_share_upper": round(ops / seconds / peaks["issue_ops"], 4),
    }
    rec["bound"] = ("issue" if rec["issue_share_upper"]
                    >= rec["dram_share_upper"] else "dram")
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
