"""Quantify the positioning tie-break exposure.

The Bowtie2 replacement (pipeline/positioning.py) records, per guide,
the AGG-variant read's best alignment — fewest mismatches, then LOWEST
GENOMIC POSITION among equals. Real Bowtie2 picks pseudo-randomly among
equal-score alignments (PARITY.md Tier 3 item 2), so recorded
coordinates can only deviate when a read has MULTIPLE equal-mismatch
best alignments. This script measures how often that happens on a
ladder-rung genome: for every sampled candidate guide it finds the best
alignment distance (0/1/2 mismatches, both strands, the PAM-candidate
window universe — the exact search space of ``best_alignment``) and
counts the alignments at that distance.

Reported: tie rate overall, by best distance, and among guides the
Bowtie2 stage ACCEPTS (<= 1 perfect hit over the 8 PAM variants — the
guides whose coordinates feed countHitTranscripts). Appends one JSON
line to scripts/positioning_ties_results.jsonl; PARITY.md carries the
headline number.

Usage: python scripts/positioning_ties.py [--gbp 0.14] [--n 4096]
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
    print(f"[ties] {msg}", file=sys.stderr, flush=True)


def count_at_dist(reads, dist, win_sigs, win_pos, chunk=512):
    """Number of window alignments of each read at exactly-``dist``
    substitutions (both strands) — the size of the equal-score set the
    tie-break chooses from."""
    from crackling_jax.pipeline.positioning import (_dist_keys_min_pos,
                                                    rc_sig23, window_range)

    shifts = np.uint64(2) * np.arange(23, dtype=np.uint64)
    out = np.zeros(reads.shape[0], dtype=np.int64)
    for c0 in range(0, reads.shape[0], chunk):
        sub = reads[c0:c0 + chunk]
        if dist == 0:
            keys = sub[:, None]
        elif dist == 1:
            keys = ((sub[:, None, None]
                     & ~(np.uint64(3) << shifts[None, :, None]))
                    | (np.arange(4, dtype=np.uint64)[None, None, :]
                       << shifts[None, :, None])).reshape(sub.shape[0], -1)
        else:
            p1, p2 = np.triu_indices(23, k=1)
            b = np.arange(4, dtype=np.uint64)
            bb1 = np.repeat(b, 4)
            bb2 = np.tile(b, 4)
            cleared = (sub[:, None, None]
                       & ~(np.uint64(3) << shifts[p1])[None, :, None]
                       & ~(np.uint64(3) << shifts[p2])[None, :, None])
            keys = (cleared
                    | (bb1[None, None, :] << shifts[p1][None, :, None])
                    | (bb2[None, None, :] << shifts[p2][None, :, None])
                    ).reshape(sub.shape[0], -1)
        m, K = keys.shape
        flat = keys.reshape(-1)
        allk = np.concatenate([flat, rc_sig23(flat)])
        cnt, _ = window_range(win_sigs, win_pos, allk)
        both = cnt[: m * K] + cnt[m * K:]
        if dist == 1:
            # substitution enumeration includes the original read (base
            # re-written to itself): those keys are dist-0, not dist-1
            orig = (keys == sub[:, None])
            both = np.where(orig.reshape(-1), 0, both)
        elif dist == 2:
            # pairs where one or both positions rewrite to the original
            # base are dist-<2 keys; exclude them from the dist-2 count
            o1 = ((keys >> shifts[p1].repeat(16)[None, :])
                  & np.uint64(3)) == ((sub[:, None] >> shifts[p1].repeat(16)[None, :]) & np.uint64(3))
            o2 = ((keys >> shifts[p2].repeat(16)[None, :])
                  & np.uint64(3)) == ((sub[:, None] >> shifts[p2].repeat(16)[None, :]) & np.uint64(3))
            both = np.where((o1 | o2).reshape(-1), 0, both)
        out[c0:c0 + chunk] = both.reshape(m, K).sum(axis=1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=0.14)
    ap.add_argument("--pool-mbp", type=int, default=600)
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()

    from scale_rung import DATA, make_genome

    from crackling_jax.index.extract import find_candidate_guides_seq
    from crackling_jax.pipeline.positioning import (GenomeIndex,
                                                    best_alignment,
                                                    position_guides,
                                                    variant_sigs)

    DATA.mkdir(parents=True, exist_ok=True)
    tag = f"g{args.gbp:g}b"
    genome_fa = DATA / f"{tag}.fa"
    make_genome(genome_fa, args.gbp, args.pool_mbp)

    log("building genome window index")
    t0 = time.time()
    gi = GenomeIndex.from_fasta(str(genome_fa))
    win_sigs, win_pos = gi.window_index()
    log(f"{win_sigs.shape[0]:,} PAM-candidate windows in "
        f"{time.time() - t0:.0f}s")

    with open(genome_fa) as fp:
        fp.readline()
        seq = "".join(fp.readline().strip() for _ in range(30000))
    _, _, cand = find_candidate_guides_seq(seq)
    rng = np.random.default_rng(13)
    guides = np.unique(cand)
    rng.shuffle(guides)
    guides = guides[: args.n]
    log(f"{guides.shape[0]} candidate guides sampled")

    reads = variant_sigs(guides)[:, 0]          # the AGG-variant read
    best, best_d = best_alignment(reads, gi)
    aligned = best_d >= 0
    log(f"aligned: {aligned.mean():.4f} "
        f"(d0 {(best_d == 0).mean():.3f}, d1 {(best_d == 1).mean():.3f}, "
        f"d2 {(best_d == 2).mean():.3f})")

    n_best = np.zeros(guides.shape[0], dtype=np.int64)
    for d in (0, 1, 2):
        m = best_d == d
        if m.any():
            n_best[m] = count_at_dist(reads[m], d, win_sigs, win_pos)
    assert (n_best[aligned] >= 1).all()

    passed, _, _, _ = position_guides(guides, gi)
    tie = aligned & (n_best >= 2)
    rec = {
        "genome_gbp": args.gbp,
        "n_guides": int(guides.shape[0]),
        "aligned_fraction": round(float(aligned.mean()), 4),
        "tie_rate_overall": round(float(tie[aligned].mean()), 4),
        "tie_rate_by_dist": {
            str(d): round(float((n_best[best_d == d] >= 2).mean()), 4)
            for d in (0, 1, 2) if (best_d == d).any()},
        "bowtie_accepted_fraction": round(float(passed.mean()), 4),
        "tie_rate_among_accepted": round(
            float(tie[passed & aligned].mean()), 4) if (passed & aligned).any() else 0.0,
        "mean_equal_best_alignments": round(
            float(n_best[aligned].mean()), 2),
    }
    log(json.dumps(rec))
    with open(ROOT / "scripts" / "positioning_ties_results.jsonl", "a") as fp:
        fp.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
