"""The compiled kernels on a CUDA GPU (marked ``gpu``; skip elsewhere).

chip_smoke.py runs these on the card before its own phases. The finder
kernel has no other compiled-mode test: everywhere else it runs in the
Pallas interpreter.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crackling_jax.codec import sig_split
from crackling_jax.index import build_index
from crackling_jax.ops.issl_compact import (CompactIsslScorer, find_moments,
                                            plan_on_device,
                                            plan_query_occupancy)
from crackling_jax.ops.oracle import score_bruteforce


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 1 << 40, size=4000).astype(np.uint64)
    mut = []
    for sig in base[:1500]:
        pos = rng.integers(0, 20)
        mut.append((np.uint64(sig) & ~(np.uint64(3) << np.uint64(2 * pos)))
                   | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos)))
    index = build_index(np.concatenate(
        [base, np.array(mut, np.uint64), np.repeat(base[:8], 40)]))
    queries = np.concatenate(
        [base[:200], rng.integers(0, 1 << 40, 56).astype(np.uint64)])
    return index, queries


@pytest.mark.gpu
@pytest.mark.parametrize("superchunk", [0, 1])
def test_compiled_finder_equals_plain(gpu, data, superchunk):
    index, queries = data
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024,
                           superchunk=superchunk)
    assert not sc.interpret
    qb, _ = plan_query_occupancy(queries, sc.S, sc.B, 8, sc.qb_cap)
    lo, hi = sig_split(queries)
    q_lo = jnp.asarray(lo.view(np.uint32))
    q_hi = jnp.asarray(hi.view(np.uint32))
    qsp = plan_on_device(q_lo, q_hi, S=sc.S, B=sc.B, qb=qb)
    out = {}
    for finder in ("kernel", "xla"):
        fn = jax.jit(partial(
            find_moments, nchmax=sc._nchmax, chunk=sc.chunk, max_dist=4,
            rows_per_slice=sc._rows_per_slice, superchunk=sc.superchunk,
            finder=finder))
        out[finder] = [np.asarray(x) for x in fn(
            q_lo, q_hi, qsp, sc.bucket_offsets, sc.bucket_lens, sc.entries)]
    for a, b in zip(out["kernel"], out["xla"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_compiled_compact_vs_bruteforce(gpu, data):
    index, queries = data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024)
    mit, cfd = sc.score_sums(queries)
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)
