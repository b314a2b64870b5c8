"""Memory-bounded extraction: spill runs + merge cascade parity."""

import numpy as np
import pytest

from crackling_jax.index.build import build_index, _lofirst_to_lex
from crackling_jax.index.extract import extract_offtarget_sites_seq
from crackling_jax.index.stream import (SpillSorter, build_index_streamed,
                                        iter_fasta_chunks, lex_block_to_text,
                                        run_length, stream_sorted_sites,
                                        write_sites_text)


def _write_fasta(path, records, width=60):
    with open(path, "w") as fp:
        for name, seq in records:
            fp.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fp.write(seq[i:i + width] + "\n")


@pytest.fixture()
def genome_file(tmp_path, make_genome):
    recs = [("chr1", make_genome(50_000)),
            ("chr2", make_genome(30_000, n_frac=0.01)),
            ("chr3", make_genome(200))]
    path = tmp_path / "g.fa"
    _write_fasta(path, recs)
    return path, recs


def test_fasta_chunks_cover_all_windows(genome_file):
    path, recs = genome_file
    # tiny chunks force many boundaries; extraction over chunks must equal
    # extraction over whole records
    chunks = list(iter_fasta_chunks(path, chunk_size=1000))
    got = np.concatenate(
        [extract_offtarget_sites_seq(c, to_upper=True) for c in chunks])
    want = np.concatenate(
        [extract_offtarget_sites_seq(seq.encode(), to_upper=True)
         for _, seq in recs])
    assert sorted(got.tolist()) == sorted(want.tolist())


def test_parallel_scan_matches_serial(genome_file, tmp_path):
    """Thread-parallel extraction (per-worker spill runs + shared merge
    cascade) is byte-equivalent to the single-threaded path."""
    path, _ = genome_file
    t1, b1 = stream_sorted_sites([path], tmp_dir=tmp_path / "a",
                                 run_size=4_000, threads=1)
    t3, b3 = stream_sorted_sites([path], tmp_dir=tmp_path / "b",
                                 run_size=4_000, threads=3)
    assert t1 == t3
    a = np.concatenate(list(b1))
    b = np.concatenate(list(b3))
    assert np.array_equal(a, b)


def test_merged_blocks_multi_sorter(tmp_path, rng):
    """Several sorters sharing one directory merge into one sorted
    stream (the per-worker spill layout)."""
    from crackling_jax.index.stream import merged_blocks

    keys = rng.integers(0, 1 << 40, size=120_000, dtype=np.uint64)
    sorters = [SpillSorter(tmp_dir=tmp_path / "m", run_size=7_000,
                           prefix=f"w{i}.") for i in range(3)]
    for i, k in enumerate(np.array_split(keys, 7)):
        sorters[i % 3].add(k)
    merged = np.concatenate(list(merged_blocks(sorters, block=9_999,
                                               threads=3)))
    assert np.array_equal(merged, np.sort(keys))


def test_fasta_reader_edge_cases(tmp_path, monkeypatch):
    """No trailing newline, blank lines, CRLF, tiny read blocks."""
    from crackling_jax.index import stream as stream_mod

    p = tmp_path / "edge.fa"
    p.write_bytes(b">r1\r\nACGT\r\n\r\nTTGGA\n>r2\nCCAAT")
    assert list(iter_fasta_chunks(p)) == [b"ACGTTTGGA", b"CCAAT"]
    # force block boundaries mid-line / mid-header
    monkeypatch.setattr(stream_mod, "READ_BLOCK", 3)
    assert list(iter_fasta_chunks(p)) == [b"ACGTTTGGA", b"CCAAT"]


def test_spill_sorter_matches_npsort(tmp_path, rng):
    keys = rng.integers(0, 1 << 40, size=300_000, dtype=np.uint64)
    sorter = SpillSorter(tmp_dir=tmp_path / "s", run_size=37_000)
    for i in range(0, keys.size, 9_999):
        sorter.add(keys[i:i + 9_999])
    merged = np.concatenate(list(sorter.sorted_blocks(block=10_000)))
    assert np.array_equal(merged, np.sort(keys))


def test_spill_sorter_in_ram_path(tmp_path, rng):
    keys = rng.integers(0, 1 << 40, size=5_000, dtype=np.uint64)
    sorter = SpillSorter(tmp_dir=tmp_path / "s", run_size=1 << 30)
    sorter.add(keys)
    merged = np.concatenate(list(sorter.sorted_blocks()))
    assert np.array_equal(merged, np.sort(keys))


def test_run_length_carry(rng):
    vals = np.sort(rng.integers(0, 50, size=10_000, dtype=np.uint64))
    blocks = [vals[i:i + 777] for i in range(0, vals.size, 777)]
    got_v, got_c = [], []
    for v, c in run_length(iter(blocks)):
        got_v.append(v)
        got_c.append(c)
    got_v = np.concatenate(got_v)
    got_c = np.concatenate(got_c)
    want_v, want_c = np.unique(vals, return_counts=True)
    assert np.array_equal(got_v, want_v)
    assert np.array_equal(got_c, want_c)


def test_streamed_text_matches_inmemory(genome_file, tmp_path):
    path, recs = genome_file
    total, blocks = stream_sorted_sites([path], tmp_dir=tmp_path / "t",
                                        run_size=10_000)
    out = tmp_path / "sites.txt"
    n = write_sites_text(blocks, out)
    assert n == total

    # in-memory reference: extract + lex sort + string render
    from crackling_jax.codec import sigs_to_strings

    sigs = np.concatenate(
        [extract_offtarget_sites_seq(seq.encode(), to_upper=True)
         for _, seq in recs])
    order = np.argsort(_lofirst_to_lex(sigs, 20), kind="stable")
    want = "".join(s + "\n" for s in sigs_to_strings(sigs[order], 20))
    assert out.read_text() == want


def test_streamed_index_matches_inmemory(genome_file, tmp_path):
    path, recs = genome_file
    idx_s = build_index_streamed([path], tmp_dir=tmp_path / "i",
                                 run_size=10_000)
    sigs = np.concatenate(
        [extract_offtarget_sites_seq(seq.encode(), to_upper=True)
         for _, seq in recs])
    idx_m = build_index(sigs)
    assert idx_s.seq_count == idx_m.seq_count
    assert np.array_equal(idx_s.site_sigs, idx_m.site_sigs)
    assert np.array_equal(idx_s.occurrences, idx_m.occurrences)
    assert np.array_equal(idx_s.order, idx_m.order)


def test_lex_block_to_text_roundtrip(rng):
    from crackling_jax.codec import sigs_to_strings
    from crackling_jax.index.build import lex_to_lofirst_checked

    lex = rng.integers(0, 1 << 40, size=100, dtype=np.uint64)
    txt = lex_block_to_text(lex, 20).tobytes().decode()
    lines = txt.strip().split("\n")
    want = sigs_to_strings(lex_to_lofirst_checked(lex, 20), 20)
    assert lines == list(want)


def test_build_index_from_sites_text(tmp_path, genome_file):
    """The streamed text->index CLI path matches the in-memory builder."""
    path, recs = genome_file
    total, blocks = stream_sorted_sites([path], run_size=1 << 14)
    sites_txt = tmp_path / "sites.txt"
    write_sites_text(blocks, sites_txt)

    from crackling_jax.index.stream import build_index_from_sites_text

    sigs = np.concatenate([
        extract_offtarget_sites_seq(seq.encode(), to_upper=True)
        for _, seq in recs
    ])
    ref = build_index(sigs)
    got = build_index_from_sites_text(sites_txt, run_size=1 << 14)
    assert got.seq_count == ref.seq_count
    assert (got.site_sigs == ref.site_sigs).all()
    assert (got.occurrences == ref.occurrences).all()
    assert (got.bucket_offsets == ref.bucket_offsets).all()
