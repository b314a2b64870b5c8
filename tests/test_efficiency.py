"""Efficiency-scorer parity vs the reference's string-based logic."""

import numpy as np
import pytest

from crackling_jax.codec import at_percentage, strings_to_sigs
from crackling_jax.ops import efficiency as eff


@pytest.fixture()
def targets(rng):
    # random 23-mers biased to end GG / start CC like real candidates
    seqs = []
    for _ in range(500):
        s = "".join(rng.choice(list("ACGT"), 21))
        seqs.append(s + "GG")
        seqs.append("CC" + s)
    seqs += ["T" + "A" * 20 + "GG", "CC" + "G" * 20 + "A", "TTTTT" + "C" * 16 + "GG"]
    return seqs


def test_g20(targets):
    sigs = strings_to_sigs(targets, 23)
    got = eff.g20_pass(sigs)
    want = np.array([t[19] == "G" for t in targets])
    assert (got == want).all()


def test_leading_t_trailing_a(targets):
    sigs = strings_to_sigs(targets, 23)
    got = eff.leading_t_trailing_a_pass(sigs)
    want = np.array(
        [not ((t[-2:] == "GG" and t[0] == "T") or (t[:2] == "CC" and t[-1] == "A"))
         for t in targets]
    )
    assert (got == want).all()


def test_at_percent(targets):
    sigs = strings_to_sigs(targets, 23)
    at = eff.at_percentages(sigs)
    want = np.array([at_percentage(t[0:20]) for t in targets])
    assert (at == want).all()
    got = eff.at_percent_pass(at)
    want_pass = ~((want < 20) | (want > 65))
    assert (got == want_pass).all()


def test_tttt(targets):
    sigs = strings_to_sigs(targets, 23)
    got = eff.tttt_pass(sigs)
    want = np.array(["TTTT" not in t for t in targets])
    assert (got == want).all()


def test_sgrnascorer2_matches_sklearn(targets):
    joblib = pytest.importorskip("joblib")
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            clf = joblib.load(
                "/root/reference/src/crackling/utils/data/model-py3.txt"
            )
    except Exception:
        pytest.skip("reference model not loadable")
    encoding = {"A": "0001", "C": "0010", "T": "0100", "G": "1000"}
    feats = np.array(
        [[int(encoding[t[x]][y]) for x in range(20) for y in range(4)] for t in targets]
    )
    want = clf.decision_function(feats)
    got = eff.sgrnascorer2_scores(strings_to_sigs(targets, 23))
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_consensus():
    a = np.array([True, True, False])
    b = np.array([True, False, False])
    c = np.array([False, True, True])
    assert (eff.consensus_counts(a, b, c) == np.array([2, 2, 1])).all()
