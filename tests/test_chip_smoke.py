"""chip_smoke.py's phases at a tiny size on the CPU, the finder kernel in
the Pallas interpreter. Its ``main`` refuses to run without a GPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

# small pages and compaction caps keep the CPU decode light
SMALL = dict(query_page=64, chunk=1024, nz_cap=8192)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("smoke")
    genome, index, queries, npz = cs.phase_data(60_000, 192, td)
    assert npz is not None and npz.exists()
    inputs = cs.write_inputs(td / "work", genome, npz, exon_bp=6_000,
                             n_exons=3)
    return dict(genome=genome, index=index, queries=queries, npz=npz,
                inputs=inputs)


@pytest.fixture(scope="module")
def hybrid(world):
    from crackling_jax.ops.hybrid import HybridIsslScorer

    return HybridIsslScorer(world["index"], max_dist=cs.MAX_DIST,
                            method=cs.METHOD, threshold=cs.THRESHOLD,
                            interpret=True, **SMALL)


def test_main_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(cs, "card_lines", lambda: [])
    monkeypatch.setattr(cs, "phase_gpu_tests", lambda: 0)
    with pytest.raises(cs.PhaseFailed, match="not a GPU"):
        cs.main([])
    with pytest.raises(cs.PhaseFailed, match="not a GPU"):
        cs.main(["--four-cards"])


def test_phase_data_is_seeded(world, tmp_path):
    genome, index, queries, _ = cs.phase_data(60_000, 192, None)
    assert genome == world["genome"]
    assert index.num_sites == world["index"].num_sites
    np.testing.assert_array_equal(queries, world["queries"])
    # the cached index is the one built from the seed
    again = cs.phase_data(60_000, 192, world["npz"].parent)[1]
    np.testing.assert_array_equal(again.site_sigs, index.site_sigs)


def test_served_scorer_follows_the_config(world):
    from crackling_jax.ops.hybrid import ExactIsslScorer
    from crackling_jax.ops.issl_jax import IsslScorer

    config = world["inputs"]["config"]
    # on the CPU auto builds the XLA engine; exact builds the exact path
    assert isinstance(cs.served_scorer(config("auto")), IsslScorer)
    assert isinstance(cs.served_scorer(config("exact", "avg")),
                      ExactIsslScorer)


def test_phase_served(world, hybrid):
    out = cs.phase_served(hybrid, world["index"], world["queries"],
                          n_check=128)
    assert out["mit"].shape == world["queries"].shape
    # too few re-scored queries to time: the nearest 1,024 stand in
    n = len(world["queries"])
    want = (hybrid.last_rescored if hybrid.last_rescored >= 64
            else min(1024, n))
    assert len(out["rescore"]) == want


def test_phase_finder(world, hybrid):
    times = cs.phase_finder(hybrid.fast, world["queries"], reps=1,
                            interpret=True)
    assert set(times) == {"kernel", "xla"}


def test_phase_page_times(world):
    times = cs.phase_page_times(world["index"], world["queries"], reps=1,
                                interpret=True, **SMALL)
    assert all(t > 0 for t in times.values())


def test_phase_exact(world, hybrid):
    queries = world["queries"]
    cs.phase_exact(world["inputs"]["config"], world["index"], queries[:48],
                   queries[:8])


def test_phase_pipeline_and_mfe(world):
    guides = cs.phase_pipeline(world["inputs"]["config"], world["index"])
    assert guides and all(len(g) == 23 for g in guides)
    cs.phase_mfe(guides, page=6)


def test_phase_sharded(world):
    cs.phase_sharded(world["index"], world["queries"], n_check=64,
                     interpret=True, **SMALL)


def test_failed_check_raises():
    with pytest.raises(cs.PhaseFailed, match="boom"):
        cs.check(False, "boom")
    cs.check(True, "never")
