"""The compact engine's phase-1 finder: the Pallas-Triton kernel (in the
Pallas interpreter here) against the plain XLA finder, moment for moment.

Both feed the same decode, so they must agree exactly on every chunk,
superchunk and bucket-total cell (count, min rank, max rank). Cases span
every max_dist the reference accepts at l=20 / w=8, a shallow index and
one deep enough for the superchunk tree level, and a query page that
fills its widest bucket's slot block exactly as well as one that leaves
most slots padded. The total hit count is also checked against brute
force: with the first-clean-slice dedup each (query, site) pair within
max_dist is found exactly once.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crackling_jax.codec import popcount64, sig_split
from crackling_jax.index import build_index
from crackling_jax.ops.issl_compact import (CompactIsslScorer, find_moments,
                                            plan_on_device,
                                            plan_query_occupancy)
from crackling_jax.ops.oracle import collapse_mismatches


def _mutants(rng, sigs, n_each, lo_pos=0):
    out = []
    for sig in sigs:
        for _ in range(n_each):
            v = np.uint64(sig)
            for pos in rng.integers(lo_pos, 20, size=int(rng.integers(1, 4))):
                v = ((v & ~(np.uint64(3) << np.uint64(2 * pos)))
                     | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos)))
            out.append(v)
    return np.array(out, dtype=np.uint64)


def _pin(sigs, low=0x55):
    return (sigs & ~np.uint64(0xFF)) | np.uint64(low)


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.default_rng(5)
    # shallow: random sites plus near neighbours of a few of them
    base = rng.integers(0, 1 << 40, size=500).astype(np.uint64)
    shallow = build_index(np.concatenate(
        [base, _mutants(rng, base[:100], 2), np.repeat(base[:3], 20)]))
    # deep: ~2.4K sites share slice-0 value 0x55, so that bucket spans
    # three 1024-entry chunks and the superchunk level (size 2) is live
    dbase = _pin(rng.integers(0, 1 << 40, size=40).astype(np.uint64))
    deep = build_index(np.concatenate(
        [dbase, _mutants(rng, dbase, 90, lo_pos=4),
         rng.integers(0, 1 << 40, size=300).astype(np.uint64)]))
    # "full": 64 queries in one slice-0 bucket -> qb = 64 with no padding
    # slot in that bucket; "padded": a few queries, most slots padding
    full_s = _pin(np.concatenate(
        [base[:32], rng.integers(0, 1 << 40, 32).astype(np.uint64)]))
    full_d = np.concatenate(
        [dbase[:32], _pin(rng.integers(0, 1 << 40, 32).astype(np.uint64))])
    padded_s = np.concatenate(
        [base[:6], rng.integers(0, 1 << 40, 3).astype(np.uint64)])
    padded_d = np.concatenate(
        [dbase[:6], rng.integers(0, 1 << 40, 3).astype(np.uint64)])
    return {
        "shallow": (shallow, 0, {"full": full_s, "padded": padded_s}),
        "superchunk": (deep, 2, {"full": full_d, "padded": padded_d}),
    }


def _moments(sc, queries, finder):
    qb, _ = plan_query_occupancy(queries, sc.S, sc.B, 8, sc.qb_cap)
    lo, hi = sig_split(queries)
    q_lo = jnp.asarray(lo.view(np.uint32))
    q_hi = jnp.asarray(hi.view(np.uint32))
    qsp = plan_on_device(q_lo, q_hi, S=sc.S, B=sc.B, qb=qb)
    fn = jax.jit(partial(
        find_moments, nchmax=sc._nchmax, chunk=sc.chunk,
        max_dist=sc.max_dist, rows_per_slice=sc._rows_per_slice,
        superchunk=sc.superchunk, finder=finder,
        interpret=finder == "kernel"))
    return qb, [np.asarray(x) for x in fn(
        q_lo, q_hi, qsp, sc.bucket_offsets, sc.bucket_lens, sc.entries)]


@pytest.mark.parametrize("block", ["full", "padded"])
@pytest.mark.parametrize("depth", ["shallow", "superchunk"])
@pytest.mark.parametrize("max_dist", [1, 2, 3, 4])
def test_kernel_finder_equals_plain_finder(worlds, max_dist, depth, block):
    index, superchunk, blocks = worlds[depth]
    queries = blocks[block]
    sc = CompactIsslScorer(index, max_dist=max_dist, chunk=1024,
                           superchunk=superchunk, finder="xla")
    if depth == "superchunk":
        assert sc._nchmax >= 3
    qb, kern = _moments(sc, queries, "kernel")
    _, plain = _moments(sc, queries, "xla")
    if block == "full":
        assert qb == 64 and len(queries) == 64
    for name, a, b in zip(("count", "min rank", "max rank"), kern, plain):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # bucket-total cells: every (query, site) hit exactly once
    d = popcount64(collapse_mismatches(
        queries[:, None] ^ index.site_sigs[None, :]))
    assert kern[0][:, :, -1, :].sum() == int((d <= max_dist).sum())
