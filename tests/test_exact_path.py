"""The exact path and the hybrid around it, the capability check, the
compile-cache directory and the native library's build key.

The oracle (ops/oracle.score_exact) is %f-equal to the reference binary
(tests/test_scorer.py), so %f-equality against it carries the binary's
contract to both exact-path variants: the native host scanner and the
f64 XLA engine.
"""

import numpy as np
import pytest

from crackling_jax.index import build_index
from crackling_jax.ops.issl_jax import verdicts
from crackling_jax.ops.oracle import score_exact

METHODS = ["mit", "cfd", "and", "or", "avg"]
THRESHOLDS = {"mit": 80.0, "cfd": 80.0, "and": 75.0, "or": 75.0,
              "avg": 90.0}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    base = rng.integers(0, 1 << 40, size=900).astype(np.uint64)
    mutated = []
    for sig in base[:400]:
        for _ in range(3):
            pos = np.uint64(rng.integers(0, 20))
            mutated.append(
                (np.uint64(sig) & ~(np.uint64(3) << (np.uint64(2) * pos)))
                | (np.uint64(rng.integers(0, 4)) << (np.uint64(2) * pos)))
    sites = np.concatenate([base, np.array(mutated, dtype=np.uint64),
                            rng.choice(base, size=300)])
    index = build_index(sites, seq_length=20, slice_width=8)
    queries = np.concatenate([
        base[:20], np.array(mutated[:20], dtype=np.uint64),
        rng.integers(0, 1 << 40, 12).astype(np.uint64)])
    return index, queries


@pytest.fixture(scope="module")
def compact(data):
    from crackling_jax.ops.issl_compact import CompactIsslScorer

    index, _ = data
    return CompactIsslScorer(index, max_dist=4, query_page=64, chunk=1024,
                             interpret=True)


def _fmt(a):
    return ["%f" % x for x in a]


@pytest.mark.parametrize("method", METHODS)
def test_hybrid_compact_vs_oracle(data, compact, method):
    """Compact full scan + exact re-score: verdicts equal the oracle's,
    and every re-scored query carries the oracle's exact scores."""
    from crackling_jax.ops.hybrid import HybridIsslScorer

    index, queries = data
    thr = THRESHOLDS[method]
    hyb = HybridIsslScorer(index, max_dist=4, method=method, threshold=thr,
                           fast=compact)
    mit, cfd = hyb.score(queries)
    ref_m, ref_c = score_exact(index, queries, 4, thr, method)
    np.testing.assert_array_equal(verdicts(mit, cfd, thr, method),
                                  verdicts(ref_m, ref_c, thr, method))
    raw_m, raw_c = compact.score(queries)
    near = hyb._near_threshold(raw_m, raw_c)
    assert hyb.last_rescored == int(near.sum())
    np.testing.assert_array_equal(mit[near], ref_m[near])
    np.testing.assert_array_equal(cfd[near], ref_c[near])


@pytest.mark.parametrize("method", METHODS)
def test_f64_exact_path_matches_oracle(data, method):
    """The exact path's XLA variant (IsslScorer in f64 with the early-exit
    emulation) prints the oracle's %f strings on every channel the
    method calculates (isslScoreOfftargets.cpp:123-143)."""
    from crackling_jax.ops.hybrid import ExactIsslScorer

    index, queries = data
    thr = THRESHOLDS[method]
    ex = ExactIsslScorer(index, max_dist=4, method=method, threshold=thr,
                         path="xla")
    mit, cfd = ex.score(queries)
    ref_m, ref_c = score_exact(index, queries, 4, thr, method)
    if method != "cfd":
        assert _fmt(mit) == _fmt(ref_m)
    if method != "mit":
        assert _fmt(cfd) == _fmt(ref_c)


def test_exact_path_rejects_unknown(data):
    from crackling_jax.ops.hybrid import ExactIsslScorer

    with pytest.raises(ValueError):
        ExactIsslScorer(data[0], path="mxu")


# -- the capability check ---------------------------------------------------

@pytest.mark.parametrize("platform,compiles", [
    ("gpu", True), ("cpu", False), ("rocm", False)])
def test_kernels_compile_only_on_gpu(platform, compiles):
    from crackling_jax.ops.backend import kernels_compile, resolve_interpret

    assert kernels_compile(platform) is compiles
    assert resolve_interpret(True, platform) is True
    if compiles:
        assert resolve_interpret(None, platform) is False
    else:
        with pytest.raises(ValueError, match="interpret=True"):
            resolve_interpret(None, platform)


def test_auto_picks_compact_on_gpu_only():
    from types import SimpleNamespace

    from crackling_jax.pipeline.run import select_auto_engine

    index = SimpleNamespace(num_sites=5_060_000, seq_length=20,
                            slice_width=8, bucket_count=256)
    assert select_auto_engine(index, "gpu") == "compact"
    assert select_auto_engine(index, "cpu") == "xla"


def test_engines_refuse_to_interpret_quietly(data):
    """On the CPU the kernel engines build only with interpret=True; the
    plain finder builds anywhere."""
    from crackling_jax.ops.issl_compact import CompactIsslScorer
    from crackling_jax.parallel.sharded import (ShardedCompactIsslScorer,
                                                make_mesh)

    index, _ = data
    with pytest.raises(ValueError, match="interpret=True"):
        CompactIsslScorer(index, chunk=1024)
    with pytest.raises(ValueError, match="interpret=True"):
        ShardedCompactIsslScorer(index, make_mesh(n_shards=2), chunk=1024)
    assert CompactIsslScorer(index, chunk=1024, interpret=True).interpret
    assert not CompactIsslScorer(index, chunk=1024, finder="xla").interpret


def test_unknown_engine_lists_valid_ones(tmp_path):
    from crackling_jax.pipeline.run import ENGINES, Pipeline

    class Section(dict):
        def get(self, k, d=None):
            return dict.get(self, k, d)

    pipe = Pipeline.__new__(Pipeline)
    pipe._issl_scorer = None
    pipe.cm = {"input": Section({"offtarget-sites": str(tmp_path / "x")}),
               "offtargetscore": Section({"method": "and",
                                          "max-distance": "4",
                                          "score-threshold": "75"}),
               "accelerator": Section({"engine": "pallas"})}
    from crackling_jax.index import save_native

    save_native(build_index(np.arange(64, dtype=np.uint64)),
                str(tmp_path / "x.npz"))
    pipe.cm["input"]["offtarget-sites"] = str(tmp_path / "x.npz")
    with pytest.raises(ValueError) as e:
        pipe._get_issl_scorer()
    assert all(name in str(e.value) for name in ENGINES)


# -- the compile cache --------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_directory(monkeypatch, tmp_path, env_dir):
    import jax

    from crackling_jax.utils import jaxcache

    calls = {}
    monkeypatch.setattr(jaxcache, "_DONE", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache.enable_persistent_cache()
    root = jaxcache.CHECKOUT_CACHE.parents[1]
    assert (root / "crackling_jax").is_dir()
    if env_dir:
        # JAX reads the variable itself; no other directory is set
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == str(root / ".cache/jax")
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


# -- the native library's build key -------------------------------------------

def test_native_key_tracks_sources_flags_and_cpu(monkeypatch):
    from crackling_jax import native

    key = native.lib_key()
    assert key == native.lib_key()
    assert native.lib_path().parent.name == key
    assert native.lib_path().parents[1] == native._CACHE
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    cpu_key = native.lib_key()
    assert cpu_key != key
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-g"])
    assert native.lib_key() not in (key, cpu_key)


def test_native_library_lives_in_the_checkout_cache():
    from crackling_jax import native

    root = native._HERE.parents[1]
    assert native._CACHE == root / ".cache" / "native"
    if native.get_lib() is not None:
        assert native.lib_path().exists()
