"""Scoring parity: oracle vs reference binary, JAX engine vs oracle."""

import subprocess

import numpy as np
import pytest

from crackling_jax.codec import sigs_to_strings, strings_to_sigs
from crackling_jax.index import build_index, write_reference_issl
from crackling_jax.ops.issl_jax import IsslScorer, verdicts
from crackling_jax.ops.oracle import score_bruteforce, score_exact

NO_EXIT_THRESHOLD = 1e-9  # makes maximum_sum astronomically large


@pytest.fixture(scope="module")
def fixture_data():
    rng = np.random.default_rng(7)
    # a site population with near-duplicates so queries get real hits
    base = rng.integers(0, 1 << 40, size=1500).astype(np.uint64)
    mutated = []
    for sig in base[:800]:
        for _ in range(3):
            pos = rng.integers(0, 20)
            newbase = np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos)
            mask = ~(np.uint64(3) << np.uint64(2 * pos))
            mutated.append((sig & mask) | newbase)
    sites = np.concatenate([base, np.array(mutated, dtype=np.uint64),
                            rng.choice(base, size=400)])
    index = build_index(sites, seq_length=20, slice_width=8)
    # queries: exact sites, 1-4 mismatch neighbours, and random
    queries = [base[0], base[1]]
    for sig in base[2:40]:
        s = np.uint64(sig)
        for nmut in (1, 2, 3, 4, 5):
            v = s
            for _ in range(nmut):
                pos = np.uint64(rng.integers(0, 20))
                v = (v & ~(np.uint64(3) << (np.uint64(2) * pos))) | (
                    np.uint64(rng.integers(0, 4)) << (np.uint64(2) * pos)
                )
            queries.append(v)
    queries += list(rng.integers(0, 1 << 40, size=30).astype(np.uint64))
    return index, np.array(queries, dtype=np.uint64)


def run_reference_scorer(ref_bins, tmp_path, index, queries, max_dist, threshold, method):
    issl = tmp_path / "t.issl"
    write_reference_issl(index, str(issl))
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(s + "\n" for s in sigs_to_strings(queries, 20)))
    out = subprocess.run(
        [ref_bins["isslScoreOfftargets"], str(issl), str(qfile),
         str(max_dist), repr(threshold), method],
        check=True,
        capture_output=True,
        text=True,
    )
    mit, cfd = [], []
    for line in out.stdout.strip("\n").split("\n"):
        seq, m, c = line.split("\t")
        mit.append(m)
        cfd.append(c)
    return mit, cfd


@pytest.mark.parametrize("method", ["and", "or", "avg", "mit", "cfd"])
@pytest.mark.parametrize("threshold", [75.0, NO_EXIT_THRESHOLD])
def test_oracle_bit_exact_vs_reference(ref_bins, tmp_path, fixture_data, method, threshold):
    index, queries = fixture_data
    ref_mit, ref_cfd = run_reference_scorer(
        ref_bins, tmp_path, index, queries, 4, threshold, method
    )
    mit, cfd = score_exact(index, queries, 4, threshold, method)
    calc_mit = method in ("mit", "and", "or", "avg")
    calc_cfd = method in ("cfd", "and", "or", "avg")
    for i in range(len(queries)):
        if calc_mit:
            assert "%f" % mit[i] == ref_mit[i], f"MIT query {i}"
        else:
            assert ref_mit[i] == "-1"
        if calc_cfd:
            assert "%f" % cfd[i] == ref_cfd[i], f"CFD query {i}"
        else:
            assert ref_cfd[i] == "-1"


def test_fullscan_equals_bruteforce(fixture_data):
    """Full ISSL scan (no early exit) finds exactly the brute-force hit set."""
    index, queries = fixture_data
    mit_o, cfd_o = score_exact(index, queries, 4, NO_EXIT_THRESHOLD, "and")
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs, index.occurrences, 4)
    np.testing.assert_allclose(10000.0 / (100.0 + mit_b), mit_o, rtol=1e-12)
    np.testing.assert_allclose(10000.0 / (100.0 + cfd_b), cfd_o, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_matches_bruteforce(fixture_data, dtype):
    import jax.numpy as jnp

    index, queries = fixture_data
    scorer = IsslScorer(index, max_dist=4, query_block=64,
                        work_block=1 << 12, dtype=jnp.dtype(dtype))
    mit_sum, cfd_sum = scorer.score_sums(queries)
    mit_b, cfd_b = score_bruteforce(queries, index.site_sigs, index.occurrences, 4)
    rtol = 1e-12 if dtype == "float64" else 2e-6
    np.testing.assert_allclose(mit_sum, mit_b, rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(cfd_sum, cfd_b, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("method", ["and", "or", "avg", "mit", "cfd"])
def test_engine_early_exit_emulation(fixture_data, method):
    """With method+threshold set, the engine reproduces the reference's
    early-exit partial scores (not just verdicts)."""
    import jax.numpy as jnp

    index, queries = fixture_data
    scorer = IsslScorer(index, max_dist=4, query_block=64, work_block=1 << 12,
                        dtype=jnp.float64, method=method, threshold=75.0)
    mit, cfd = scorer.score(queries)
    mit_o, cfd_o = score_exact(index, queries, 4, 75.0, method)
    # compare only the channels the reference calculates for this method
    # (calcMit/calcCfd, isslScoreOfftargets.cpp:123-143)
    if method in ("mit", "and", "or", "avg"):
        np.testing.assert_allclose(mit, mit_o, rtol=1e-12)
    if method in ("cfd", "and", "or", "avg"):
        np.testing.assert_allclose(cfd, cfd_o, rtol=1e-12)
    ours = verdicts(mit, cfd, 75.0, method)
    theirs = verdicts(mit_o, cfd_o, 75.0, method)
    assert (ours == theirs).all()


def test_engine_f32_verdict_parity(fixture_data):
    """The f32 fast path must agree on verdicts with the exact oracle."""
    index, queries = fixture_data
    for method in ("and", "avg"):
        scorer = IsslScorer(index, max_dist=4, query_block=64,
                            work_block=1 << 12, method=method, threshold=75.0)
        mit, cfd = scorer.score(queries)
        mit_o, cfd_o = score_exact(index, queries, 4, 75.0, method)
        ours = verdicts(mit, cfd, 75.0, method)
        theirs = verdicts(mit_o, cfd_o, 75.0, method)
        assert (ours == theirs).all(), method


def test_scores_transform():
    sigs = strings_to_sigs(["A" * 20], 20)
    index = build_index(sigs, seq_length=20, slice_width=8)
    scorer = IsslScorer(index, query_block=8, work_block=256)
    mit, cfd = scorer.score(sigs)
    # self-hit: MIT sum 0 (dist==0 adds nothing), CFD sum 1*occ
    assert mit[0] == 100.0
    np.testing.assert_allclose(cfd[0], 10000.0 / 101.0, rtol=1e-6)
