"""Adversarial probe of the hybrid re-score band.

The HybridIsslScorer re-scores queries whose fast-engine score lands
within ``band`` (the fast engine's ``score_band``) of the threshold
through the exact path (ops/hybrid.py). That band is safe only while the
fast engine's worst-case score deviation stays far below it. This module
constructs the conditions the bench ladder never hits:

* **deep buckets**: every site within Hamming distance <= 4 of one
  query, so all of them share that query's slice buckets and the
  accumulation chain per (query, bucket) is maximally long;
* **log-sum stress**: mismatches planted at the strongest-penalty MIT
  positions (largest |log2(1-w)|) mixed with weak ones, and at zero/weak
  CFD penalty positions (products near the f32 rounding floor);
* **heavy occurrences**: hit contributions scaled x1000, pushing the
  sums into the score region of maximum d(score)/d(sum) sensitivity.

The assertion is 10x stricter than the compact engine's advertised band
(``score_band`` 0.05): a kernel change that moves the engine's error
past band/10 fails here long before the hybrid's verdict guarantee is at
risk.
"""

import numpy as np
import pytest

from crackling_jax.index import build_index
from crackling_jax.ops.oracle import score_bruteforce

COMPACT_MARGIN = 0.005  # score units; compact score_band is 0.05


def _mutate(sig, positions, rng):
    s = np.uint64(sig)
    for p in positions:
        old = (int(s) >> (2 * p)) & 3
        new = int(rng.integers(0, 3))
        new = new if new != old else 3 if old != 3 else 0
        s = (s & ~(np.uint64(3) << np.uint64(2 * p))) | (
            np.uint64(new) << np.uint64(2 * p))
    return s


@pytest.fixture(scope="module")
def adversarial():
    rng = np.random.default_rng(77)
    q = np.uint64(rng.integers(0, 1 << 40))
    # MIT weight extremes (isslCreateIndex.cpp:96): positions with the
    # largest penalties dominate the log-sum; mixing them with near-zero
    # ones maximizes the spread the f32 log-sum must represent
    strong = [5, 6, 18, 19, 16]          # M[] large
    weak = [0, 1, 2, 3, 4]               # M[] small / zero-ish
    sites = [q]                           # self-hit
    occs = [1]
    for k in range(1500):
        nmut = int(rng.integers(1, 5))
        pool = strong if k % 3 == 0 else weak if k % 3 == 1 else list(
            range(20))
        positions = rng.choice(pool, size=min(nmut, len(pool)),
                               replace=False)
        sites.append(_mutate(q, positions, rng))
        # heavy-tailed occurrences: many hits x1000 pile the sums up fast
        occs.append(int(rng.choice([1, 3, 1000, 250])))
    flat = np.concatenate(
        [np.repeat(np.uint64(s), o) for s, o in zip(sites, occs)])
    index = build_index(flat)
    # the probe query + its duplicates in one page + far-away controls
    queries = np.concatenate([
        np.repeat(q, 3),
        rng.integers(0, 1 << 40, 5).astype(np.uint64),
    ])
    mit_sum, cfd_sum = score_bruteforce(queries, index.site_sigs,
                                        index.occurrences, 4)
    mit_f64 = 10000.0 / (100.0 + mit_sum)
    cfd_f64 = 10000.0 / (100.0 + cfd_sum)
    return index, queries, mit_f64, cfd_f64


def test_compact_deviation_within_band_margin(adversarial):
    from crackling_jax.ops.issl_compact import CompactIsslScorer

    index, queries, mit_f64, cfd_f64 = adversarial
    sc = CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                           interpret=True)
    mit, cfd = sc.score(queries)
    dev = max(np.abs(mit - mit_f64).max(), np.abs(cfd - cfd_f64).max())
    print(f"\ncompact adversarial deviation: {dev:.2e}")
    assert dev < COMPACT_MARGIN, (
        f"compact engine deviates {dev:.4f} score units on the "
        f"adversarial index — approaching its score_band (0.05); if this "
        f"is a real accuracy regression, CompactIsslScorer.score_band "
        f"must grow with it")
