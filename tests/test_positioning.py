"""Positioning (Bowtie2-equivalent) vs brute-force string search."""

import numpy as np
import pytest

from crackling_jax.codec import rc, strings_to_sigs
from crackling_jax.pipeline.positioning import (GenomeIndex, best_alignment,
                                                position_guides, variant_sigs)

PAMS = ["AGG", "CGG", "GGG", "TGG", "AAG", "CAG", "GAG", "TAG"]


@pytest.fixture()
def world(tmp_path, rng):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    c1 = bases[rng.integers(0, 4, 30_000)].tobytes().decode()
    c2 = bases[rng.integers(0, 4, 20_000)].tobytes().decode()
    # plant a repeated site so some guide fails the <=1 perfect-hit rule
    repeat = "ACGTACGTACGTACGTACGT" + "TGG"
    c1 = c1[:5000] + repeat + c1[5000:15000] + repeat + c1[15000:]
    fa = tmp_path / "g.fa"
    fa.write_text(f">c1\n{c1}\n>c2\n{c2}\n")
    return fa, {"c1": c1, "c2": c2}


def brute_verdict(genome_by_name, guide23):
    """Reference-rule verdict by plain string counting."""
    counts = []
    for pam in PAMS:
        v = guide23[:20] + pam
        c = 0
        for name, seq in genome_by_name.items():
            for hay in (v, rc(v)):
                start = 0
                while True:
                    i = seq.find(hay, start)
                    if i < 0:
                        break
                    c += 1
                    start = i + 1
        counts.append(c)
    passed = sum(min(c, 2) for c in counts) <= 1
    return passed, counts


def brute_coord(genome_by_name, guide23, max_mm=2):
    """The emulated-Bowtie2 coordinate policy by brute force: the AGG
    read's best alignment over PAM-candidate windows — fewest mismatches,
    then lowest flat genomic position (chroms in file order), both
    strands."""
    read = guide23[:20] + "AGG"
    rcr = rc(read)

    def ham(a, b):
        return sum(x != y for x, y in zip(a, b))

    for mm in range(max_mm + 1):
        for name, seq in genome_by_name.items():
            for i in range(len(seq) - 22):
                w = seq[i:i + 23]
                if w[21:23] not in ("GG", "AG") and w[0:2] not in ("CC", "CT"):
                    continue
                if ham(w, read) == mm or ham(w, rcr) == mm:
                    return name, i + 1
    return "*", 0


def test_positioning_verdicts_match_bruteforce(world, rng):
    fa, chroms = world
    gi = GenomeIndex.from_fasta(str(fa))
    # guides taken from the genome (including the planted repeat) + random
    picks = []
    c1 = chroms["c1"]
    for _ in range(30):
        i = int(rng.integers(0, len(c1) - 23))
        picks.append(c1[i:i + 23])
    picks.append("ACGTACGTACGTACGTACGT" + "TGG")  # planted repeat
    picks.append("".join(rng.choice(list("ACGT"), 23)))  # probably absent
    sigs = strings_to_sigs(picks, 23)
    passed, chrom, start, end = position_guides(sigs, gi)

    for i, g in enumerate(picks):
        want_passed, counts = brute_verdict(chroms, g)
        assert passed[i] == want_passed, (g, counts)
        want_chrom, want_pos = brute_coord(chroms, g)
        assert chrom[i] == want_chrom, g
        assert start[i] == want_pos, g
        assert end[i] == start[i] + 22
    # the planted repeat must be rejected
    assert not passed[len(picks) - 2]


def test_best_alignment_mismatch_ladder(world, rng):
    """Reads at hamming distance 0/1/2 from a genomic window resolve to
    that window; hopeless reads stay unaligned."""
    fa, chroms = world
    gi = GenomeIndex.from_fasta(str(fa))
    c1 = chroms["c1"]
    # pick a PAM-candidate window (ends GG) so it is in the index universe
    i0 = next(i for i in range(700, len(c1) - 23)
              if c1[i + 21:i + 23] == "GG")
    base = c1[i0:i0 + 23]
    reads = [base]
    r1 = list(base)
    r1[5] = "A" if r1[5] != "A" else "C"
    reads.append("".join(r1))
    r2 = list(r1)
    r2[15] = "A" if r2[15] != "A" else "C"
    reads.append("".join(r2))
    # a read that cannot align within 2 mismatches of anything
    reads.append("A" * 23)
    if "AAA" in c1 or "AAA" in chroms["c2"]:
        pass  # poly-A stretches could make this alignable; tolerate below
    sigs = strings_to_sigs(reads, 23)
    best, dists = best_alignment(sigs, gi, max_mm=2)
    NOPOS = np.iinfo(np.int64).max

    def ham(a, b):
        return sum(x != y for x, y in zip(a, b))

    for k, (read, b) in enumerate(zip(reads[:3], best[:3])):
        assert b != NOPOS
        rec, pos1 = gi.locate(np.array([b]))
        seq = chroms[gi.names[rec[0]]]
        w = seq[int(pos1[0]) - 1:int(pos1[0]) + 22]
        d = min(ham(w, read), ham(w, rc(read)))
        assert d <= 2
        assert d == dists[k]
    # the exact read resolves at distance 0
    rec, pos1 = gi.locate(best[:1])
    w = chroms[gi.names[rec[0]]][int(pos1[0]) - 1:int(pos1[0]) + 22]
    assert w == base or rc(w) == base


def test_window_index_memmap_matches_inram(world):
    """The disk-resident (memmapped bucket-sorted) window index is
    entry-for-entry identical to the in-RAM build, and positioning
    verdicts/coordinates agree."""
    fa, chroms = world
    gi_ram = GenomeIndex.from_fasta(str(fa))
    sigs_ram, pos_ram = gi_ram.window_index()

    gi_mm = GenomeIndex.from_fasta(str(fa))
    # memmap_threshold=0 forces the on-disk build; a small chunk forces
    # multiple scan chunks so the bucket-scatter path is exercised
    sigs_mm, pos_mm = gi_mm.window_index(chunk=1 << 13, memmap_threshold=0)
    assert isinstance(sigs_mm, np.memmap)
    np.testing.assert_array_equal(np.asarray(sigs_mm), sigs_ram)
    np.testing.assert_array_equal(np.asarray(pos_mm), pos_ram)

    picks = [chroms["c1"][100:123], chroms["c2"][57:80],
             "ACGTACGTACGTACGTACGT" + "TGG"]
    q = strings_to_sigs(picks, 23)
    got = position_guides(q, gi_mm)
    want = position_guides(q, gi_ram)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_variant_sigs_layout():
    sigs = strings_to_sigs(["A" * 20 + "GGG"], 23)
    v = variant_sigs(sigs)
    from crackling_jax.codec import sigs_to_strings

    got = sigs_to_strings(v.reshape(-1), 23)
    assert got == ["A" * 20 + p for p in PAMS]
