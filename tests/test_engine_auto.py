"""engine = auto picks the hybrid-compact path at every depth wherever
the compact kernel compiles (ops/backend.py), the XLA engine elsewhere.

What remains depth-dependent is the construction-time fallback to the
XLA engine past the compact decoder's 2^22 rank-exactness bound,
exercised in the pipeline's engine selection. The reference has a single
scan loop at every depth (isslScoreOfftargets.cpp:344-461); engine choice
here is a performance contract only — every auto path is verdict-exact
through the hybrid wrapper.
"""

from types import SimpleNamespace

from crackling_jax.pipeline.run import select_auto_engine


def fake_index(num_sites, seq_length=20, slice_width=8):
    return SimpleNamespace(num_sites=num_sites, seq_length=seq_length,
                           slice_width=slice_width,
                           bucket_count=1 << slice_width)


def test_shallow_index_selects_compact():
    # 27 Mbp bench point: ~5.06M distinct sites -> ~20K average depth
    assert select_auto_engine(fake_index(5_060_000), "gpu") == "compact"


def test_deep_index_selects_compact():
    # mouse rung: 111.3M distinct sites -> ~435K average depth
    assert select_auto_engine(fake_index(111_300_000), "gpu") == "compact"


def test_band_tracks_fast_engine():
    """The hybrid's re-score band must come from the fast engine's
    advertised accuracy."""
    from crackling_jax.ops.hybrid import HybridIsslScorer
    from crackling_jax.ops.issl_compact import CompactIsslScorer
    from crackling_jax.ops.issl_jax import IsslScorer

    assert CompactIsslScorer.score_band == 0.05
    assert IsslScorer.score_band == 0.05
    fast = SimpleNamespace(score_band=0.5)
    assert HybridIsslScorer(fake_index(10), fast=fast).band == 0.5


def test_non_gpu_or_non_default_shape_selects_xla():
    assert select_auto_engine(fake_index(1_000), "cpu") == "xla"
    assert select_auto_engine(fake_index(1_000, seq_length=21), "gpu") == "xla"
    assert select_auto_engine(fake_index(1_000, slice_width=4), "gpu") == "xla"
