"""Order-exact ISSL off-target scoring engine (plain JAX/XLA).

Re-architecture of the reference scorer's hot loop
(isslScoreOfftargets.cpp:308-511) as array code that runs on any JAX
device:

* the per-thread, per-query pointer walk over inverted lists becomes a
  **flat work expansion**: every (query, slice) pair contributes a
  contiguous span of bucket entries; spans are concatenated into one flat
  work axis processed in fixed-width vector rounds (static shapes for XLA);

* the per-query "seen" bitvector (isslScoreOfftargets.cpp:385-387,463)
  becomes a **pure function of the pair**: a hit is counted only in its
  *first clean slice* — slice ``s`` counts the hit iff no slice ``s' < s``
  of the XOR is all-zero. This is exactly equivalent to the reference's
  mark-seen logic under full scanning, and needs no state;

* MIT local scores are computed in closed form (no table gather),
  replicating ``single_score`` (isslCreateIndex.cpp:93-118);

* CFD is the reference per-position penalty product
  (isslScoreOfftargets.cpp:399-461) using small-table takes;

* accumulation uses two-float (TwoSum-compensated) f32 sums so the final
  scores track the reference's f64 accumulation to ~1e-7 relative. With
  x64 enabled the engine runs in f64 directly (the exact path's XLA
  variant, ops/hybrid.ExactIsslScorer).

Early-exit semantics: the engine scores in full. The reference's early exit
(isslScoreOfftargets.cpp:467-496) only fires once a guide's score is already
below threshold, so verdicts are identical and scores of *accepted* guides
are identical; scores the reference reports for early-exited (rejected)
guides are partial sums and differ by design. See ``ops/oracle.py`` for a
bit-exact emulation including the exit points.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import sig_split
from ..index.build import IsslIndex
from ..utils.jaxcache import enable_persistent_cache
from .tables import CFD_PAM_NGG_INDEX, MIT_WEIGHTS, cfd_pam_penalties, cfd_pos_penalties

enable_persistent_cache()

# Score methods (reference isslScoreOfftargets.cpp:44,121-143).
METHODS = ("mit", "cfd", "and", "or", "avg")


def _compact_even_bits_u32(x):
    """Keep bits at even positions of a uint32 and pack them into the low
     16 bits (Morton even-bit compaction)."""
    x = x & jnp.uint32(0x55555555)
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


def _mismatch_bits(xor_lo, xor_hi):
    """XOR words -> (mm20 uint32 one-bit-per-position mask, dist int32)."""
    coll_lo = ((xor_lo & jnp.uint32(0xAAAAAAAA)) >> 1) | (xor_lo & jnp.uint32(0x55555555))
    coll_hi = ((xor_hi & jnp.uint32(0xAAAAAAAA)) >> 1) | (xor_hi & jnp.uint32(0x55555555))
    mm20 = _compact_even_bits_u32(coll_lo) | (_compact_even_bits_u32(coll_hi) << 16)
    dist = (
        jax.lax.population_count(coll_lo) + jax.lax.population_count(coll_hi)
    ).astype(jnp.int32)
    return mm20, dist


def _base_at(lo, hi, pos: int):
    """2-bit base code at static position ``pos`` from (lo, hi) uint32."""
    if pos < 16:
        return (lo >> jnp.uint32(2 * pos)) & jnp.uint32(3)
    return (hi >> jnp.uint32(2 * (pos - 16))) & jnp.uint32(3)


def _mit_closed_form(mm20, dist, dtype):
    """Closed-form MIT local score from the 20-bit mismatch mask.

    Replicates single_score (isslCreateIndex.cpp:93-118):
    T1 = prod(1-M[p]) over mismatched p (ascending), d = (last-first)/(m-1)
    (telescoped mean gap; 19 when m == 1), T2 = 1/(((19-d)/19)*4+1),
    T3 = 1/m^2. Zero when dist == 0 (sscore, :128)."""
    one = jnp.asarray(1.0, dtype)
    t1 = jnp.ones_like(mm20, dtype=dtype)
    first = jnp.full(mm20.shape, 99, dtype=jnp.int32)
    last = jnp.full(mm20.shape, -1, dtype=jnp.int32)
    for p in range(20):
        bit = (mm20 >> jnp.uint32(p)) & jnp.uint32(1)
        is_mm = bit != 0
        t1 = t1 * jnp.where(is_mm, jnp.asarray(1.0 - MIT_WEIGHTS[p], dtype), one)
        first = jnp.where(is_mm & (first == 99), p, first)
        last = jnp.where(is_mm, p, last)
    m = dist.astype(dtype)
    d = jnp.where(
        dist == 1,
        jnp.asarray(19.0, dtype),
        (last - first).astype(dtype) / jnp.maximum(m - 1.0, 1.0),
    )
    t2 = 1.0 / ((19.0 - d) / 19.0 * 4.0 + 1.0)
    t3 = 1.0 / jnp.maximum(m * m, 1.0)
    return jnp.where(dist > 0, t1 * t2 * t3 * 100.0, jnp.zeros_like(t1))


def _cfd_product(q_lo, q_hi, o_lo, o_hi, dist, pos_pen_flat, pam_ngg, dtype):
    """Per-hit CFD score (isslScoreOfftargets.cpp:399-461): product over
    mismatched positions of cfdPosPenalties[pos<<4 | q<<2 | (ot^3)], times
    the NGG PAM penalty; 1.0 when dist == 0."""
    cfd = jnp.full(q_lo.shape, pam_ngg, dtype=dtype)
    one = jnp.asarray(1.0, dtype)
    for p in range(20):
        qb = _base_at(q_lo, q_hi, p)
        ob = _base_at(o_lo, o_hi, p)
        idx = (jnp.uint32(p * 16) | (qb << 2) | (ob ^ jnp.uint32(3))).astype(jnp.int32)
        pen = jnp.take(pos_pen_flat, idx)
        cfd = cfd * jnp.where(qb != ob, pen, one)
    return jnp.where(dist == 0, one, cfd)


def _searchsorted_right(cum, w):
    """Branchless binary search: first index i with cum[i] > w.

    ``jnp.searchsorted``'s default lowering is a linear scan; this unrolled
    log2(n) ladder has a static trip count and no data-dependent control
    flow."""
    n = cum.shape[0]
    lo = jnp.zeros_like(w)
    hi = jnp.full_like(w, n)
    for _ in range(max(1, (n).bit_length())):
        mid = (lo + hi) >> 1
        v = cum[jnp.minimum(mid, n - 1)]
        go_right = v <= w
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def _two_sum(hi, lo, x):
    """Compensated accumulation: (hi, lo) += x with TwoSum error tracking."""
    s = hi + x
    bb = s - hi
    err = (hi - (s - bb)) + (x - bb)
    return s, lo + err


from typing import NamedTuple


class ScorerConfig(NamedTuple):
    """Static (hashable) parameters of the scoring program."""

    slice_count: int
    slice_width: int
    work_block: int
    max_dist: int
    npad: int
    pam_ngg: float
    dtype: str
    method: str | None
    maximum_sum: float | None


def score_page_core(cfg: ScorerConfig, q_lo, q_hi, q_valid, list_lo, list_hi,
                    list_occ, bucket_offsets, pos_pen_flat):
    """Score one padded page of queries against one index (shard).

    Pure function of its array arguments + the static ``cfg`` — jitted
    directly for single-device use and wrapped in ``shard_map`` for the
    index-sharded multi-chip path (parallel/sharded.py). Returns raw
    (mit_sum, cfd_sum) accumulations of shape (Q,).
    """
    dtype = jnp.dtype(cfg.dtype)
    Q = q_lo.shape[0]
    S = cfg.slice_count
    W = cfg.work_block
    w_bits = cfg.slice_width
    bmask = jnp.uint32((1 << w_bits) - 1)

    # --- work plan: one segment per (query, slice) -----------------
    def slice_val(s):
        shift = s * w_bits
        if shift < 32:
            v = (q_lo >> jnp.uint32(shift)) & bmask
        else:
            v = (q_hi >> jnp.uint32(shift - 32)) & bmask
        return v.astype(jnp.int32)

    # (Q, S) bucket ids -> starts/lens from CSR offsets
    vals = jnp.stack([slice_val(s) for s in range(S)], axis=1)
    s_idx = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (Q, S))
    starts = bucket_offsets[s_idx, vals]
    lens = bucket_offsets[s_idx, vals + 1] - starts
    lens = jnp.where(q_valid[:, None], lens, 0)  # padded queries do no work
    seg_bucket_start = starts.reshape(-1)       # (Q*S,)
    seg_lens = lens.reshape(-1).astype(jnp.int32)
    seg_cum = jnp.cumsum(seg_lens)              # inclusive
    seg_work_start = seg_cum - seg_lens
    total = seg_cum[-1]
    nrounds = (total + W - 1) // W

    def exit_cond(mit_tot, cfd_tot):
        """Reference early-exit predicate on the running sums
        (isslScoreOfftargets.cpp:467-496)."""
        ms = jnp.asarray(cfg.maximum_sum, dtype)
        m = cfg.method
        if m == "and":
            return (mit_tot > ms) & (cfd_tot > ms)
        if m == "or":
            return (mit_tot > ms) | (cfd_tot > ms)
        if m == "avg":
            return (mit_tot + cfd_tot) / 2.0 > ms
        if m == "mit":
            return mit_tot > ms
        return cfd_tot > ms

    def round_body(r, acc):
        mit_hi, mit_lo, cfd_hi, cfd_lo, crossed = acc
        w = r * W + jnp.arange(W, dtype=jnp.int32)
        inb = w < total
        seg = _searchsorted_right(seg_cum, w).astype(jnp.int32)
        seg = jnp.minimum(seg, Q * S - 1)
        q = seg // S
        s = seg - q * S
        entry = seg_bucket_start[seg] + (w - seg_work_start[seg])
        flat = s * cfg.npad + entry
        o_lo = list_lo[flat]
        o_hi = list_hi[flat]
        occ = list_occ[flat].astype(dtype)

        ql = q_lo[q]
        qh = q_hi[q]
        x_lo = ql ^ o_lo
        x_hi = qh ^ o_hi
        mm20, dist = _mismatch_bits(x_lo, x_hi)

        # first-clean-slice dedup: slice s' clean iff its XOR bits are 0
        bases_per_slice = w_bits // 2
        smask = jnp.uint32((1 << bases_per_slice) - 1)
        clean = jnp.zeros_like(mm20)
        for sp in range(S):
            c = ((mm20 >> jnp.uint32(sp * bases_per_slice)) & smask) == 0
            clean = clean | (c.astype(jnp.uint32) << jnp.uint32(sp))
        earlier_mask = (jnp.uint32(1) << s.astype(jnp.uint32)) - jnp.uint32(1)
        seen_earlier = (clean & earlier_mask) != 0

        valid = inb & (dist <= cfg.max_dist) & (~seen_earlier)

        mit_local = _mit_closed_form(mm20, dist, dtype)
        cfd_local = _cfd_product(
            ql, qh, o_lo, o_hi, dist, pos_pen_flat, cfg.pam_ngg, dtype
        )
        vf = valid.astype(dtype) * occ
        mit_c = mit_local * vf          # dist==0 contributes 0 (closed form)
        cfd_c = cfd_local * vf

        if cfg.maximum_sum is not None:
            # Exact exit emulation. Work items for one query arrive in
            # reference scan order (slice-major, bucket order), so the
            # first item whose *previous* running sums satisfy the exit
            # predicate — and everything after it — is dropped, freezing
            # the totals exactly where the reference breaks.
            cs_mit = jnp.cumsum(mit_c)
            cs_cfd = jnp.cumsum(cfd_c)
            all_mit_q = jax.ops.segment_sum(mit_c, q, num_segments=Q)
            all_cfd_q = jax.ops.segment_sum(cfd_c, q, num_segments=Q)
            base_mit = (jnp.cumsum(all_mit_q) - all_mit_q)[q]
            base_cfd = (jnp.cumsum(all_cfd_q) - all_cfd_q)[q]
            prev_mit = (mit_hi + mit_lo)[q] + (cs_mit - mit_c - base_mit)
            prev_cfd = (cfd_hi + cfd_lo)[q] + (cs_cfd - cfd_c - base_cfd)
            drop = crossed[q] | exit_cond(prev_mit, prev_cfd)
            keepf = jnp.where(drop, jnp.zeros_like(mit_c), jnp.ones_like(mit_c))
            mit_c = mit_c * keepf
            cfd_c = cfd_c * keepf

        mit_part = jax.ops.segment_sum(mit_c, q, num_segments=Q)
        cfd_part = jax.ops.segment_sum(cfd_c, q, num_segments=Q)
        mit_hi, mit_lo = _two_sum(mit_hi, mit_lo, mit_part)
        cfd_hi, cfd_lo = _two_sum(cfd_hi, cfd_lo, cfd_part)
        if cfg.maximum_sum is not None:
            crossed = crossed | exit_cond(mit_hi + mit_lo, cfd_hi + cfd_lo)
        return mit_hi, mit_lo, cfd_hi, cfd_lo, crossed

    # derive the init carry from both query- and index-varying inputs so
    # shard_map's manual-axes typing matches the loop outputs (plain zeros
    # would be axis-invariant and reject the carry)
    zeros = (q_lo & jnp.uint32(0)).astype(dtype) + (list_occ[0] * 0).astype(dtype)
    init = (zeros, zeros, zeros, zeros, zeros != 0)

    if cfg.maximum_sum is not None:
        # while-loop so the page stops as soon as every live query has
        # exited (the vectorized analogue of the reference's break).
        def cond(state):
            r, acc = state
            return (r < nrounds) & ~jnp.all(acc[4] | ~q_valid)

        def body(state):
            r, acc = state
            return r + 1, round_body(r, acc)

        _, (mit_hi, mit_lo, cfd_hi, cfd_lo, _) = jax.lax.while_loop(
            cond, body, (jnp.int32(0), init)
        )
    else:
        mit_hi, mit_lo, cfd_hi, cfd_lo, _ = jax.lax.fori_loop(
            0, nrounds, round_body, init
        )
    return mit_hi + mit_lo, cfd_hi + cfd_lo


class IsslScorer:
    """Batched ISSL off-target scorer resident on one device.

    Parameters
    ----------
    index: the host-side :class:`IsslIndex`.
    max_dist: maximum Hamming distance scored (reference CLI arg, default
        ``slice_count - 1`` which guarantees full recall by pigeonhole).
    query_block: queries per compiled step (padded).
    work_block: flat work items per vector round.
    dtype: compute dtype — float32 (with compensated accumulation) or
        float64 (needs x64 enabled) for reference-exact arithmetic.
    """

    # near-threshold re-score band when this engine is the hybrid's fast
    # path: compensated f32 sums track the f64 reference to ~1e-7
    # relative (tests/test_scorer.py)
    score_band = 0.05

    def __init__(
        self,
        index: IsslIndex,
        max_dist: int | None = None,
        query_block: int = 256,
        work_block: int = 1 << 17,
        dtype=jnp.float32,
        device=None,
        method: str | None = None,
        threshold: float | None = None,
    ):
        if index.slice_width not in (2, 4, 8, 16):
            raise ValueError("slice width must divide 32 bits")
        if method is not None and method not in METHODS:
            raise ValueError(f"unknown score method: {method}")
        # Early-exit emulation (reference isslScoreOfftargets.cpp:326,467-496):
        # when a method+threshold are given, each query stops accumulating at
        # the exact hit where the reference would break, so reported scores
        # match the reference's partial sums for rejected guides too, and the
        # engine skips rounds once every query in the page has exited.
        self.method = method
        self.threshold = threshold
        if method is not None and threshold is not None and threshold > 0:
            self.maximum_sum = (10000.0 - threshold * 100.0) / threshold
        else:
            self.maximum_sum = None
        self.seq_length = index.seq_length
        self.slice_width = index.slice_width
        self.slice_count = index.slice_count
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.query_block = int(query_block)
        self.work_block = int(work_block)
        self.dtype = jnp.dtype(dtype)

        arrs = index.device_arrays()
        put = partial(jax.device_put, device=device) if device else jax.device_put
        s, npad = arrs["list_lo"].shape
        self._npad = npad
        self.list_lo = put(arrs["list_lo"].reshape(-1).view(np.uint32))
        self.list_hi = put(arrs["list_hi"].reshape(-1).view(np.uint32))
        self.list_occ = put(arrs["list_occ"].reshape(-1))
        self.bucket_offsets = put(arrs["bucket_offsets"])  # (S, B+1) int32
        self.pos_pen_flat = put(cfd_pos_penalties().reshape(-1).astype(self.dtype))
        self.pam_ngg = float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
        self.cfg = ScorerConfig(
            slice_count=self.slice_count,
            slice_width=self.slice_width,
            work_block=self.work_block,
            max_dist=self.max_dist,
            npad=npad,
            pam_ngg=self.pam_ngg,
            dtype=str(self.dtype),
            method=self.method,
            maximum_sum=self.maximum_sum,
        )
        # Index arrays are passed as jit *arguments* (not captured constants)
        # so the multi-GB index is never embedded in the HLO.
        self._score_page = jax.jit(partial(score_page_core, self.cfg))

    # ------------------------------------------------------------------

    def score_sums(self, query_sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw per-query (MIT sum, CFD sum) accumulations, f64 on host."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        qb = self.query_block
        mit = np.zeros(n, dtype=np.float64)
        cfd = np.zeros(n, dtype=np.float64)
        for i in range(0, n, qb):
            chunk = sigs[i:i + qb]
            pad = qb - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros(pad, dtype=np.uint64)])
            lo, hi = sig_split(chunk)
            q_valid = np.arange(qb) < (qb - pad)
            m, c = self._score_page(
                jnp.asarray(lo.view(np.uint32)),
                jnp.asarray(hi.view(np.uint32)),
                jnp.asarray(q_valid),
                self.list_lo, self.list_hi, self.list_occ,
                self.bucket_offsets, self.pos_pen_flat,
            )
            m = np.asarray(m, dtype=np.float64)
            c = np.asarray(c, dtype=np.float64)
            mit[i:i + qb] = m[: qb - pad] if pad else m
            cfd[i:i + qb] = c[: qb - pad] if pad else c
        return mit, cfd

    def score(self, query_sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global per-query scores 10000/(100+sum)
        (isslScoreOfftargets.cpp:505-506)."""
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)


def verdicts(mit, cfd, threshold: float, method: str) -> np.ndarray:
    """Accept/reject per the score method (reference Crackling.py:797-835).

    True == accepted (score not below threshold under the method)."""
    mit = np.asarray(mit)
    cfd = np.asarray(cfd)
    if method == "mit":
        rejected = mit < threshold
    elif method == "cfd":
        rejected = cfd < threshold
    elif method == "and":
        rejected = (mit < threshold) & (cfd < threshold)
    elif method == "or":
        rejected = (mit < threshold) | (cfd < threshold)
    elif method == "avg":
        rejected = (mit + cfd) / 2.0 < threshold
    else:
        raise ValueError(f"unknown score method: {method}")
    return ~rejected
