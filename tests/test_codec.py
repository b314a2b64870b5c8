import numpy as np
import pytest

from crackling_jax import codec


def test_pack_lofirst_matches_reference_bit_layout():
    # sequenceToSignature (isslCreateIndex.cpp:39-47): position j at bits 2j.
    codes = codec.bytes_to_codes(codec.seq_to_bytes("ATCG"))
    sig = codec.pack_lofirst(codes)
    # A=0, T=3<<2, C=1<<4, G=2<<6
    assert int(sig) == 0 | (3 << 2) | (1 << 4) | (2 << 6)


def test_pack_unpack_roundtrip(rng):
    codes = rng.integers(0, 4, size=(50, 20)).astype(np.uint8)
    sigs = codec.pack_lofirst(codes)
    back = codec.unpack_lofirst(sigs, 20)
    assert (codes == back).all()


def test_strings_to_sigs_and_back(rng):
    seqs = ["".join(rng.choice(list("ACGT"), 20)) for _ in range(20)]
    sigs = codec.strings_to_sigs(seqs, 20)
    assert codec.sigs_to_strings(sigs, 20) == seqs


def test_lex_pack_orders_like_strings(rng):
    seqs = ["".join(rng.choice(list("ACGT"), 20)) for _ in range(200)]
    codes = np.stack([codec.bytes_to_codes(codec.seq_to_bytes(s)) for s in seqs])
    lex = codec.pack_lex(codes)
    by_lex = [seqs[i] for i in np.argsort(lex, kind="stable")]
    assert by_lex == sorted(seqs)


def test_lex_to_lofirst(rng):
    codes = rng.integers(0, 4, size=(100, 20)).astype(np.uint8)
    assert (
        codec.lex_to_lofirst(codec.pack_lex(codes), 20) == codec.pack_lofirst(codes)
    ).all()


def test_sig_split_join(rng):
    sigs = rng.integers(0, 1 << 40, size=1000).astype(np.uint64)
    lo, hi = codec.sig_split(sigs)
    assert lo.dtype == np.int32 and hi.dtype == np.int32
    assert (codec.sig_join(lo, hi) == sigs).all()


def test_rc_matches_reference_semantics():
    # reference Helpers.py:7-10 (IUPAC-aware, case-preserving)
    assert codec.rc("ACGT") == "ACGT"
    assert codec.rc("AAGG") == "CCTT"
    assert codec.rc("acgtACGT") == "ACGTacgt"
    assert codec.rc("RYMKBDHV") == "BDHVMKRY"


def test_codes_rc():
    codes = codec.bytes_to_codes(codec.seq_to_bytes("AACG"))
    rc_codes = codec.codes_rc(codes)
    assert codec.codes_to_str(rc_codes) == "CGTT"


def test_trans_to_dna():
    assert codec.trans_to_dna("GUUUA") == "GTTTA"


def test_at_percentage():
    # reference Helpers.py:21-27
    assert codec.at_percentage("AT") == 100.0
    assert codec.at_percentage("ATGC") == 50.0
    assert codec.at_percentage("GGCC") == 0.0


def test_popcount64(rng):
    x = rng.integers(0, 1 << 62, size=100).astype(np.uint64)
    expect = np.array([bin(int(v)).count("1") for v in x])
    assert (codec.popcount64(x) == expect).all()
