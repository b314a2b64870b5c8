"""Extraction parity vs the reference's regex semantics.

The expected values are computed with the reference's exact regex patterns
(Crackling.py:153-154, extractOfftargets.py:23-24) re-stated here, including
the reverse-strand first-20-then-rc quirk of the off-target extractor.
"""

import re

import numpy as np

from crackling_jax.codec import rc, strings_to_sigs
from crackling_jax.index.extract import (
    encode_seq,
    extract_offtarget_sites,
    find_candidate_guides,
)

P_CAND_FWD = re.compile(r"(?=([ATCG]{21}GG))")
P_CAND_REV = re.compile(r"(?=(CC[ACGT]{21}))")
P_OT_FWD = re.compile(r"(?=([ACG][ACGT]{19}[ACGT][AG]G))")
P_OT_REV = re.compile(r"(?=(C[CT][ACGT][ACGT]{19}[TGC]))")


def regex_candidates(seq):
    out = []
    for pattern, strand, mod in [
        (P_CAND_FWD, "+", lambda x: x),
        (P_CAND_REV, "-", rc),
    ]:
        for m in pattern.finditer(seq):
            out.append((m.start(), strand, mod(seq[m.start():m.start() + 23])))
    return out


def regex_offtargets(seq):
    out = []
    for pattern, mod in [(P_OT_FWD, lambda x: x), (P_OT_REV, rc)]:
        for m in pattern.findall(seq):
            out.append(mod(m[0:20]))
    return out


def test_candidates_match_regex(make_genome):
    seq = make_genome(20000, n_frac=0.01)
    starts, strands, sigs = find_candidate_guides(encode_seq(seq))
    expect = regex_candidates(seq)
    got = list(zip(starts.tolist(), strands.tolist()))
    assert got == [(s, st) for s, st, _ in expect]
    assert (sigs == strings_to_sigs([t for _, _, t in expect], 23)).all()


def test_candidates_ignore_lowercase(make_genome):
    # Crackling.py does not upcase: lowercase breaks matches
    seq = make_genome(5000, lower_frac=0.05)
    starts, strands, sigs = find_candidate_guides(encode_seq(seq))
    expect = regex_candidates(seq)
    assert len(starts) == len(expect)


def test_offtargets_match_regex(make_genome):
    seq = make_genome(20000, n_frac=0.01)
    sigs = extract_offtarget_sites(encode_seq(seq, to_upper=True))
    expect = regex_offtargets(seq)
    assert len(sigs) == len(expect)
    assert (sigs == strings_to_sigs(expect, 20)).all()


def test_offtargets_upcase(make_genome):
    # extractOfftargets upcases its input (extractOfftargets.py:56,92)
    seq = make_genome(5000, lower_frac=0.3)
    sigs = extract_offtarget_sites(encode_seq(seq, to_upper=True))
    expect = regex_offtargets(seq.upper())
    assert len(sigs) == len(expect)
    assert (sigs == strings_to_sigs(expect, 20)).all()


def test_reverse_quirk_concrete():
    # genomic + strand: CC A T*17 G A G -> 23-mer reverse match
    seq = "CCA" + "T" * 17 + "GAG"
    got = extract_offtarget_sites(encode_seq(seq))
    # this window matches both patterns; the reverse hit stores
    # rc(match[0:20]), which includes the PAM bases (reference quirk)
    expect = [seq[0:20], rc(seq[0:20])]
    assert (got == strings_to_sigs(expect, 20)).all()


def test_short_sequences():
    assert len(find_candidate_guides(encode_seq("ACGT"))[0]) == 0
    assert len(extract_offtarget_sites(encode_seq(""))) == 0
