"""Index build + serialization parity against the reference binaries."""

import subprocess

import numpy as np
import pytest

from crackling_jax.codec import sigs_to_strings
from crackling_jax.index import build_index, read_reference_issl, write_reference_issl
from crackling_jax.index.io import load_native, save_native
from crackling_jax.ops.tables import precalculated_mit_scores


@pytest.fixture()
def site_sigs(rng):
    # random 20-mers with duplicates
    uniq = rng.integers(0, 1 << 40, size=3000).astype(np.uint64)
    dup = rng.choice(uniq, size=800)
    return np.concatenate([uniq, dup])


def test_reference_format_byte_identical(tmp_path, ref_bins, site_sigs):
    # write the sorted site text file the reference builder consumes
    seqs = sorted(sigs_to_strings(site_sigs, 20))
    sites_txt = tmp_path / "sites.txt"
    sites_txt.write_text("".join(s + "\n" for s in seqs))

    ref_issl = tmp_path / "ref.issl"
    subprocess.run(
        [ref_bins["isslCreateIndex"], str(sites_txt), "20", "8", str(ref_issl)],
        check=True,
        capture_output=True,
    )

    index = build_index(site_sigs, seq_length=20, slice_width=8)
    our_issl = tmp_path / "ours.issl"
    write_reference_issl(index, str(our_issl))

    assert our_issl.read_bytes() == ref_issl.read_bytes()


def test_read_reference_issl_roundtrip(tmp_path, site_sigs):
    index = build_index(site_sigs, seq_length=20, slice_width=8)
    path = tmp_path / "x.issl"
    write_reference_issl(index, str(path))
    loaded, precalc = read_reference_issl(str(path))

    assert loaded.seq_length == index.seq_length
    assert loaded.seq_count == index.seq_count
    assert (loaded.site_sigs == index.site_sigs).all()
    assert (loaded.occurrences == index.occurrences).all()
    assert (loaded.order == index.order).all()
    assert (loaded.bucket_offsets == index.bucket_offsets).all()
    assert precalc == precalculated_mit_scores(20, 4)


def test_native_roundtrip(tmp_path, site_sigs):
    index = build_index(site_sigs, seq_length=20, slice_width=8)
    path = tmp_path / "x.npz"
    save_native(index, str(path))
    loaded = load_native(str(path))
    assert (loaded.site_sigs == index.site_sigs).all()
    assert (loaded.order == index.order).all()
    assert (loaded.bucket_offsets == index.bucket_offsets).all()


def test_native_dir_roundtrip(tmp_path, site_sigs):
    """The memmapped directory format loads entry-identical and scores
    identically to the in-RAM index."""
    index = build_index(site_sigs, seq_length=20, slice_width=8)
    path = tmp_path / "x.isslx"
    save_native(index, str(path))
    loaded = load_native(str(path))
    assert isinstance(loaded.site_sigs, np.memmap)
    assert loaded.seq_length == index.seq_length
    assert loaded.seq_count == index.seq_count
    assert (np.asarray(loaded.site_sigs) == index.site_sigs).all()
    assert (np.asarray(loaded.occurrences) == index.occurrences).all()
    assert (np.asarray(loaded.order) == index.order).all()
    assert (np.asarray(loaded.bucket_offsets) == index.bucket_offsets).all()

    from crackling_jax.ops.issl_jax import IsslScorer

    q = index.site_sigs[:32]
    m1, c1 = IsslScorer(index, max_dist=4, method="and",
                        threshold=75.0).score(q)
    m2, c2 = IsslScorer(loaded, max_dist=4, method="and",
                        threshold=75.0).score(q)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(c1, c2)


def test_occurrence_counting(rng):
    sigs = np.array([5, 5, 5, 9, 9, 1], dtype=np.uint64)
    index = build_index(sigs, seq_length=20, slice_width=8)
    assert index.seq_count == 6
    assert index.num_sites == 3
    # ids in lexicographic order of the decoded strings
    order = np.argsort([s for s in sigs_to_strings(index.site_sigs, 20)])
    assert (order == np.arange(3)).all()
    got = {int(s): int(o) for s, o in zip(index.site_sigs, index.occurrences)}
    assert got == {5: 3, 9: 2, 1: 1}


def test_csr_consistency(site_sigs):
    index = build_index(site_sigs, seq_length=20, slice_width=8)
    vals = index.slice_values(index.site_sigs)
    for s in range(index.slice_count):
        ids = index.order[s]
        offs = index.bucket_offsets[s]
        for b in [0, 7, 100, 255]:
            members = ids[offs[b]:offs[b + 1]]
            assert (vals[s][members] == b).all()
            # stable: ascending id within bucket (reference list order)
            assert (np.diff(members) > 0).all() if members.size > 1 else True
