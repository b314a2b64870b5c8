"""Native host exact scorer (native/exact.cpp) vs the Python oracle.

The oracle (ops/oracle.score_exact) is itself %f-equal to the reference
binary (tests/test_scorer.py), so bit-equality against it transfers the
binary's contract (isslScoreOfftargets.cpp:344-496) to the C scanner:
per-slice bucket walk, first-encounter dedup, f64 MIT table + CFD
product op order, and the per-method early exit.
"""

import numpy as np
import pytest

from crackling_jax import native
from crackling_jax.index import build_index
from crackling_jax.ops.oracle import score_exact

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native library unavailable")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    base = rng.integers(0, 1 << 40, size=1200).astype(np.uint64)
    mutated = []
    for sig in base[:600]:
        for _ in range(3):
            pos = np.uint64(rng.integers(0, 20))
            mutated.append(
                (np.uint64(sig) & ~(np.uint64(3) << (np.uint64(2) * pos)))
                | (np.uint64(rng.integers(0, 4)) << (np.uint64(2) * pos)))
    # duplicates concentrate occurrences; shared slices exercise dedup
    sites = np.concatenate([base, np.array(mutated, dtype=np.uint64),
                            rng.choice(base, size=300)])
    index = build_index(sites, seq_length=20, slice_width=8)
    queries = np.concatenate([
        base[:24],                                   # self-hits
        np.array(mutated[:24], dtype=np.uint64),     # near neighbours
        rng.integers(0, 1 << 40, 16).astype(np.uint64),
    ])
    return index, queries


@pytest.mark.parametrize("method,threshold", [
    ("and", 75.0), ("or", 75.0), ("avg", 90.0),
    ("mit", 80.0), ("cfd", 80.0),
    ("and", 1e-9),          # astronomically large maximum_sum: no exit
])
def test_native_exact_equals_oracle(data, method, threshold):
    index, queries = data
    got = native.exact_score_native(index, queries, 4, threshold, method)
    assert got is not None
    mit_e, cfd_e = score_exact(index, queries, 4, threshold, method)
    np.testing.assert_array_equal(got[0], mit_e)
    np.testing.assert_array_equal(got[1], cfd_e)


def test_hybrid_prefers_native_exact(data):
    """Where the native library builds, the hybrid's re-score runs the
    native scanner and reproduces the exact emulation bit-for-bit."""
    from crackling_jax.ops.hybrid import HybridIsslScorer

    index, queries = data
    thr = 90.0
    mit_e, cfd_e = score_exact(index, queries, 4, thr, "avg")
    hy = HybridIsslScorer(index, max_dist=4, method="avg", threshold=thr,
                          band=np.inf, query_page=64, chunk=1024,
                          interpret=True)
    mit, cfd = hy.score(queries)
    assert hy._exact.path == "native"   # not the XLA f64 variant
    np.testing.assert_array_equal(mit, mit_e)
    np.testing.assert_array_equal(cfd, cfd_e)
