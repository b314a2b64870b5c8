import numpy as np

from crackling_jax.ops import tables


def test_cfd_tables_spot_values():
    pos = tables.cfd_pos_penalties()
    assert pos.shape == (20, 16)
    # values quoted in the reference data header (cfdPenalties.h)
    assert pos[0, 2] == 0.857142857
    assert pos[0, 10] == 0.714285714
    assert pos[19, 14] == 0.090909091
    pam = tables.cfd_pam_penalties()
    assert pam.shape == (16,)
    assert pam[0b1010] == 1.0
    assert pam[0b0010] == 0.259259259


def test_mit_local_score_single_mismatch():
    # one mismatch: T1 = 1-M[p], d = 19 -> T2 = 1, T3 = 1
    s = tables.mit_local_score(np.array([5]))
    assert abs(s - (1.0 - 0.395) * 100.0) < 1e-12


def test_mit_dense_table_matches_exact_dict():
    exact = tables.precalculated_mit_scores(20, 4)
    dense = tables.mit_dense_table(20, 4)
    # masks in the dict are the reference's 2-bit collapsed form
    masks40 = np.fromiter(exact.keys(), dtype=np.uint64)
    masks20 = tables.mask40_to_mask20(masks40)
    got = dense[masks20.astype(np.int64)]
    want = np.array(list(exact.values()))
    assert (got == want).all()  # bit-exact


def test_precalculated_count():
    from math import comb

    exact = tables.precalculated_mit_scores(20, 4)
    assert len(exact) == sum(comb(20, i) for i in range(1, 5))  # 6195
    # std::map serialization order: ascending mask
    keys = list(exact.keys())
    assert keys == sorted(keys)


def test_mask40_collapse():
    # mismatches at positions 0 and 19
    mask40 = np.uint64((1 << 0) | (1 << 38))
    assert int(tables.mask40_to_mask20(mask40)) == (1 << 0) | (1 << 19)
