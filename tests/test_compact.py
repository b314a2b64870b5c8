"""Compact two-phase engine (ops/issl_compact.py) vs the brute-force oracle.

The finder kernel runs in the Pallas interpreter here, so a single
module-scoped dataset is shared and each scorer construction is reused
across assertions. Coverage: score accuracy (plain f32 per-hit
arithmetic), paging, every decode stage (single-hit slots, single-hit
chunk cells, multi-hit chunk rescan), compaction-cap overflow page
splitting, and hybrid wrapping.
"""

import numpy as np
import pytest

from crackling_jax.index import build_index
from crackling_jax.ops.issl_compact import CompactIsslScorer
from crackling_jax.ops.oracle import score_bruteforce


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 1 << 40, size=600).astype(np.uint64)
    mut = []
    for sig in base[:150]:
        pos = rng.integers(0, 20)
        mut.append(
            (np.uint64(sig) & ~(np.uint64(3) << np.uint64(2 * pos)))
            | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos))
        )
    # heavy duplication of a few sites: multi-hit chunks for the rescan
    # stage even at chunk=1024 (all dups share one bucket position run)
    hot = np.repeat(base[:4], 64)
    sites = np.concatenate([base, np.array(mut, dtype=np.uint64), hot])
    index = build_index(sites)
    # self-hits, mutated neighbours, absent queries, duplicates (the same
    # query occupying several slots of one bucket)
    queries = np.concatenate([
        base[:16],
        rng.integers(0, 1 << 40, 8).astype(np.uint64),
        np.repeat(base[3:5], 4),
    ])
    return index, queries


def test_compact_engine_vs_bruteforce(data):
    index, queries = data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)

    sc = CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                           interpret=True)
    mit, cfd = sc.score_sums(queries)
    # per-hit math is plain f32 (no bf16 split): ~1e-6 relative
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)

    mit_s, cfd_s = sc.score(queries)
    assert ((mit_s >= 75) == (10000.0 / (100.0 + mit_b) >= 75)).all()
    assert ((cfd_s >= 75) == (10000.0 / (100.0 + cfd_b) >= 75)).all()

    # paging: 2 pages (page < n) must reproduce the single-page sums
    sc2 = CompactIsslScorer(index, max_dist=4, query_page=16, chunk=1024,
                            interpret=True)
    m2, c2 = sc2.score_sums(queries)
    np.testing.assert_allclose(m2, mit, rtol=1e-6)
    np.testing.assert_allclose(c2, cfd, rtol=1e-6)


def test_compact_overflow_splits_pages(data):
    """Compaction caps sized below the page's hit population must split
    the page and retry (score_sums drain loop) — results unchanged."""
    index, queries = data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    # cap_single = nz_cap = 24 < single-hit slots of the full 32-query
    # page (every self-hit query contributes >= 1); floors keep the
    # other caps safe so only the single-hit cap drives the splits
    sc = CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                           nz_cap=24, interpret=True)
    mit, cfd = sc.score_sums(queries)
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)


def test_compact_auto_caps_tunes_and_grows(data):
    """Auto-cap mode: the first page tunes every cap to ~1.25x its
    measured population (4096-grain); a later overflow grows the
    exceeded cap and retries (no splitting) — results match brute
    force."""
    index, queries = data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    sc = CompactIsslScorer(index, max_dist=4, query_page=16, chunk=1024,
                           auto_caps=True, interpret=True)
    mit, cfd = sc.score_sums(queries)
    assert sc._tuned
    # caps were shrunk from the 1<<17 defaults to quantized populations
    assert sc.cap_single < (1 << 17)
    assert all(c >= p for c, p in zip(sc._caps(), sc.page_stats[0]))
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)

    # force a grow: start from caps tuned far below the real populations
    sc2 = CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                            nz_cap=8, auto_caps=True, interpret=True)
    sc2._tuned = True            # skip first-page tuning; caps stay tiny
    m2, c2 = sc2.score_sums(queries)
    assert len(sc2.page_stats) > 1          # at least one grow-and-retry
    assert sc2.cap_single > 8               # the cap actually grew
    np.testing.assert_allclose(m2, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c2, cfd_b, rtol=1e-5, atol=1e-5)


def test_multi_page_auto_caps_overflow(data):
    """Dispatch-time caps, not drain-time caps, gate the overflow check.

    Two pages dispatch in one batch under the same small caps; page 1's
    overflow grows self._caps() mid-drain. Page 2 ran on device with the
    OLD caps (its compaction truncated at them), so it must be detected
    as overflowed against those dispatch-time caps and retried — a
    drain-time comparison against the grown caps silently accepts its
    truncated sums (advisor round-4 high finding)."""
    index, _ = data
    # both pages are distinct index sites: every query self-hits in >=1
    # slice, so each 16-query page has >8 direct (1-2 hit) slots and
    # MUST overflow cap_single=8
    queries = np.asarray(index.site_sigs[10:42:2], dtype=np.uint64)
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    sc = CompactIsslScorer(index, max_dist=4, query_page=8, chunk=1024,
                           nz_cap=4, auto_caps=True, interpret=True)
    sc._tuned = True      # skip first-page tuning: both pages dispatch
    mit, cfd = sc.score_sums(queries)  # together under the tiny caps
    n_pages = -(-queries.shape[0] // 8)
    assert n_pages >= 2
    # every page overflowed cap_single=4 (>=8 slice-0 self-hit slots),
    # so every page must have been retried at the grown caps
    assert len(sc.page_stats) >= 2 * n_pages
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)


def test_hybrid_with_compact_verdicts(data):
    """HybridIsslScorer accepts the compact engine as its fast path; the
    combined scorer's verdicts match the bit-exact oracle for the two
    methods with distinct exit semantics (and / avg)."""
    from crackling_jax.ops.hybrid import HybridIsslScorer
    from crackling_jax.ops.issl_jax import verdicts
    from crackling_jax.ops.oracle import score_exact

    index, queries = data
    for method, thr in (("and", 75.0), ("avg", 90.0)):
        ref_mit, ref_cfd = score_exact(index, queries, 4, thr, method)
        fast = CompactIsslScorer(index, max_dist=4, query_page=64,
                                 chunk=1024, interpret=True)
        hyb = HybridIsslScorer(index, max_dist=4, method=method,
                               threshold=thr, fast=fast)
        mit, cfd = hyb.score(queries)
        np.testing.assert_array_equal(
            verdicts(mit, cfd, thr, method),
            verdicts(ref_mit, ref_cfd, thr, method))


@pytest.fixture(scope="module")
def deep_data():
    """A deep bucket (3 chunks at chunk=1024) with clustered hits, to
    exercise the superchunk tree level of the decode: slice-0 value
    pinned so ~2.4K sites share one bucket; queries are cluster bases
    whose variants scatter across the bucket's rank range."""
    rng = np.random.default_rng(23)
    low = np.uint64(0x55)

    def pin(sigs):
        return (sigs & ~np.uint64(0xFF)) | low

    base = pin(rng.integers(0, 1 << 40, size=48).astype(np.uint64))
    variants = []
    for sig in base:
        for _ in range(64):
            v = np.uint64(sig)
            for pos in rng.integers(4, 20, size=int(rng.integers(1, 3))):
                v = ((v & ~(np.uint64(3) << np.uint64(2 * pos)))
                     | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos)))
            variants.append(v)
    filler = rng.integers(0, 1 << 40, size=300).astype(np.uint64)
    sites = np.concatenate([base, np.array(variants, np.uint64), filler])
    index = build_index(sites)
    queries = np.concatenate([
        base[:12],                     # many scattered hits in the deep bucket
        filler[:6],                    # single hits elsewhere
        rng.integers(0, 1 << 40, 6).astype(np.uint64),
    ])
    return index, queries


def test_superchunk_tree_vs_bruteforce(deep_data):
    index, queries = deep_data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    sc = CompactIsslScorer(index, max_dist=4, query_page=32, chunk=1024,
                           superchunk=2, interpret=True)
    assert sc._nchmax >= 3          # the deep bucket really spans chunks
    mit, cfd = sc.score_sums(queries)
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)
    # every tree stage must actually fire (populations in the header)
    pops = np.array(sc.page_stats).max(axis=0)
    assert pops[1] > 0, "no multi-hit slots"
    assert pops[2] > 0, "no nonzero superchunk cells"
    assert pops[3] > 0, "no multi-hit superchunk cells"
    assert pops[4] > 0, "no nonzero chunk cells"

    # the flat (no-tree) decode must agree with the tree decode
    flat = CompactIsslScorer(index, max_dist=4, query_page=32, chunk=1024,
                             superchunk=0, interpret=True)
    m0, c0 = flat.score_sums(queries)
    np.testing.assert_allclose(mit, m0, rtol=1e-6)
    np.testing.assert_allclose(cfd, c0, rtol=1e-6)


def test_superchunk_overflow_splits_pages(deep_data):
    """Superchunk-level cap overflow must split the page and retry."""
    index, queries = deep_data
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs,
                                    index.occurrences, 4)
    caps = (1 << 17, 1 << 16, 8, 4, 1 << 17, 1 << 15)  # tiny sc caps
    sc = CompactIsslScorer(index, max_dist=4, query_page=32, chunk=1024,
                           superchunk=2, caps=caps, interpret=True)
    mit, cfd = sc.score_sums(queries)
    assert len(sc.page_stats) > 1   # at least one split happened
    np.testing.assert_allclose(mit, mit_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cfd, cfd_b, rtol=1e-5, atol=1e-5)


def test_quant_cap_grain():
    """Caps quantize to 4096 multiples at 1.25x headroom — every decode
    gather runs at cap size, so a power-of-two rule's up-to-2x waste is
    work done for nothing."""
    from crackling_jax.ops.issl_compact import _quant_cap

    assert _quant_cap(0) == 4096
    assert _quant_cap(100) == 4096
    assert _quant_cap(5595) == 8192        # 1.25x = 6994 -> one grain up
    assert _quant_cap(34592) == 45056      # not 65536 (old pow2 rule)
    assert _quant_cap(292927) == 368640
    for pop in (1, 4096, 10000, 99999):
        cap = _quant_cap(pop)
        assert cap % 4096 == 0 and cap > 1.25 * pop
