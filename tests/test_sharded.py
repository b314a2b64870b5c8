"""Multi-device sharded scoring on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from crackling_jax.index import build_index
from crackling_jax.ops.oracle import score_bruteforce
from crackling_jax.parallel.sharded import ShardedIsslScorer, make_mesh, shard_index


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 1 << 40, size=2000).astype(np.uint64)
    mut = []
    for sig in base[:500]:
        pos = rng.integers(0, 20)
        mut.append(
            (np.uint64(sig) & ~(np.uint64(3) << np.uint64(2 * pos)))
            | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos))
        )
    sites = np.concatenate([base, np.array(mut, dtype=np.uint64)])
    index = build_index(sites)
    queries = np.concatenate([base[:50], rng.integers(0, 1 << 40, 14).astype(np.uint64)])
    return index, queries


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_shard_index_partition(data):
    index, _ = data
    shards = shard_index(index, 4)
    assert sum(s.num_sites for s in shards) == index.num_sites
    assert sum(s.seq_count for s in shards) == int(index.occurrences.sum())
    got = np.concatenate([s.site_sigs for s in shards])
    assert (got == index.site_sigs).all()


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)])
def test_sharded_matches_bruteforce(data, shape):
    index, queries = data
    n_q, n_shards = shape
    mesh = make_mesh(n_shards=n_shards, n_q=n_q)
    scorer = ShardedIsslScorer(index, mesh, max_dist=4,
                               query_block=16, work_block=1 << 10)
    mit, cfd = scorer.score_sums(queries)
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs, index.occurrences, 4)
    np.testing.assert_allclose(mit, mit_b, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(cfd, cfd_b, rtol=2e-6, atol=1e-6)


def test_sharded_matches_single_device(data):
    from crackling_jax.ops.issl_jax import IsslScorer

    index, queries = data
    mesh = make_mesh(n_shards=8, n_q=1)
    sharded = ShardedIsslScorer(index, mesh, max_dist=4,
                                query_block=16, work_block=1 << 10)
    single = IsslScorer(index, max_dist=4, query_block=16, work_block=1 << 10)
    m1, c1 = sharded.score(queries)
    m2, c2 = single.score(queries)
    np.testing.assert_allclose(m1, m2, rtol=2e-6)
    np.testing.assert_allclose(c1, c2, rtol=2e-6)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_compact_matches_bruteforce(data, shape):
    """The compact (fastest-path) engine under shard_map + psum agrees
    with the brute-force oracle; the pmax-merged cap header reports the
    worst device and small caps still converge via page splits."""
    from crackling_jax.parallel.sharded import ShardedCompactIsslScorer

    index, queries = data
    n_q, n_shards = shape
    mesh = make_mesh(n_shards=n_shards, n_q=n_q)
    scorer = ShardedCompactIsslScorer(index, mesh, max_dist=4,
                                      query_page=32, chunk=1024,
                                      interpret=True)
    mit, cfd = scorer.score_sums(queries)
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    # per-hit arithmetic is plain f32 (compact tier)
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)
    assert scorer.page_stats, "header stats not recorded"


def test_sharded_compact_matches_single_device(data):
    from crackling_jax.ops.issl_compact import CompactIsslScorer
    from crackling_jax.parallel.sharded import ShardedCompactIsslScorer

    index, queries = data
    mesh = make_mesh(n_shards=8, n_q=1)
    sharded = ShardedCompactIsslScorer(index, mesh, max_dist=4,
                                       query_page=64, chunk=1024,
                                       interpret=True)
    single = CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                               interpret=True)
    m1, c1 = sharded.score(queries)
    m2, c2 = single.score(queries)
    np.testing.assert_allclose(m1, m2, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(c1, c2, rtol=2e-5, atol=2e-5)
