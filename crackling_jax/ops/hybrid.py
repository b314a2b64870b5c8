"""The served scorer: a fast full-scan engine plus the exact path.

:class:`ExactIsslScorer` is the exact path — the reference binary's f64
arithmetic and early exit, ``%f``-identical to ops/oracle.score_exact:
the native host scanner (native/exact.cpp), or the order-exact XLA engine
(ops/issl_jax.IsslScorer) in f64 on the default device where no host
toolchain exists. :class:`HybridIsslScorer` runs a fast engine over every
query and re-scores through the exact path only the queries whose verdict
f32 rounding could flip.
"""

from __future__ import annotations

import numpy as np

from ..index.build import IsslIndex
from ..utils.x64 import enable_x64

EXACT_PATHS = ("native", "xla")


class ExactIsslScorer:
    """Reference-exact f64 MIT/CFD scores, early exit included.

    ``path`` picks the native host scanner or the f64 XLA engine on the
    default device; None takes the native scanner when the library
    builds (l=20, w=8 indexes), the XLA engine otherwise."""

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 method: str = "and", threshold: float = 75.0,
                 path: str | None = None):
        from .. import native

        self.index = index
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.method = method
        self.threshold = float(threshold)
        if path is None:
            probe = native.exact_score_native(
                index, np.empty(0, np.uint64), self.max_dist,
                self.threshold, method)
            path = "native" if probe is not None else "xla"
        if path not in EXACT_PATHS:
            raise ValueError(f"exact path must be one of {EXACT_PATHS}")
        self.path = path
        self._xla = None
        if path == "xla":
            from .issl_jax import IsslScorer

            with enable_x64():
                self._xla = IsslScorer(index, max_dist=self.max_dist,
                                       method=method,
                                       threshold=self.threshold,
                                       dtype=np.float64)

    def score(self, query_sigs: np.ndarray):
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        if self._xla is not None:
            with enable_x64():
                return self._xla.score(sigs)
        from .. import native

        out = native.exact_score_native(self.index, sigs, self.max_dist,
                                        self.threshold, self.method)
        if out is None:
            raise RuntimeError("native exact scanner unavailable")
        return out


class HybridIsslScorer:
    """Fast-engine speed with reference-exact verdicts for all 5 methods.

    For mit/cfd/and/or, full-scan verdicts match the binary's
    early-exit verdicts in exact arithmetic: those methods exit only
    once rejection is decided (note the reference's inverted naming —
    'and' REJECTS iff both scores are below threshold, 'or' iff either
    is, Crackling.py:814-828 — which makes the binary's exit conditions
    at isslScoreOfftargets.cpp:467-478 exactly reject-decided), and
    full-scan sums are >= partial sums, so the full scan can only
    confirm the rejection. The remaining risk there is f32 rounding
    flipping a comparison at the threshold, so this wrapper re-scores
    every query whose method-relevant margin ``|score - threshold|`` is
    within ``band`` through the exact path (built lazily, so clean runs
    never pay for it). Re-scored queries also get the binary's exact
    early-exit score values.

    ``avg`` is different: the binary exits on the average of the SUMS
    (isslScoreOfftargets.cpp:479-484) while the pipeline thresholds the
    average of the SCORES (Crackling.py:831), and by convexity of
    ``10000/(100+x)`` an exited query's frozen score average can sit
    ABOVE the threshold — i.e. the reference can accept a query whose
    full-scan average is arbitrarily far below it. Accepts are still
    safe under a full scan (frozen sums <= full sums componentwise, so
    frozen scores >= full scans'), so for ``avg`` every query the fast
    scan does NOT accept by more than ``band`` is re-scored exactly —
    the avg path degrades toward exact-path cost as the reject rate
    grows, but verdicts stay reference-exact.
    """

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 method: str = "and", threshold: float = 75.0,
                 band: float | None = None, fast=None, **fast_kw):
        self.index = index
        self.max_dist = max_dist
        self.method = method
        self.threshold = float(threshold)
        # ``fast`` may be any prebuilt full-scan engine with the score()
        # contract and a ``score_band`` — e.g. parallel/sharded.py's
        # ShardedCompactIsslScorer for the multi-device pipeline path
        if fast is None:
            from .issl_compact import CompactIsslScorer

            fast = CompactIsslScorer(index, max_dist=max_dist, **fast_kw)
        self.fast = fast
        # band=None: the fast engine's advertised rounding band
        self.band = float(fast.score_band if band is None else band)
        self._exact = None
        self.last_rescored = 0

    def _get_exact(self):
        if self._exact is None:
            self._exact = ExactIsslScorer(
                self.index, max_dist=self.max_dist, method=self.method,
                threshold=self.threshold)
        return self._exact

    def _near_threshold(self, mit, cfd):
        thr, band = self.threshold, self.band
        m_mit = np.abs(mit - thr) <= band
        m_cfd = np.abs(cfd - thr) <= band
        if self.method == "mit":
            return m_mit
        if self.method == "cfd":
            return m_cfd
        if self.method == "avg":
            # every non-clear-accept: the reference's avg early exit can
            # accept queries whose full-scan average is far below the
            # threshold (see class docstring)
            return (mit + cfd) / 2.0 < thr + band
        return m_mit | m_cfd          # and / or

    def score(self, query_sigs: np.ndarray):
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        mit, cfd = self.fast.score(sigs)
        near = self._near_threshold(mit, cfd)
        self.last_rescored = int(near.sum())   # diagnostics / perf studies
        if near.any():
            em, ec = self._get_exact().score(sigs[near])
            mit[near] = em
            cfd[near] = ec
        return mit, cfd
