"""Multi-chip ISSL scoring: index sharding + data-parallel query streams.

The scaling design (SURVEY.md §2.3/§7.9): the ISSL index is sharded by
**site-id range** across devices — every site keeps all of its slice-bucket
entries on one shard, so the first-clean-slice dedup stays shard-local and
exact — while query pages are either replicated (index-parallel only) or
split along a second data-parallel axis. Each device scores the full query
page against its shard; per-query MIT/CFD partial sums merge with ``psum``
over the shard axis (the reference's per-thread accumulators + implicit
reduction, isslScoreOfftargets.cpp:308-509, re-expressed as an XLA
collective over the device interconnect); the 10000/(100+sum) transform
and thresholding happen after the merge.

Early-exit emulation is not applied across shards (the reference's exit
point depends on a global scan order that sharding interleaves); sharded
scoring always computes full sums, which preserves verdicts for the
mit/cfd/and/or methods and scores of accepted guides everywhere.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import sig_split
from ..index.build import IsslIndex
from ..ops.backend import resolve_interpret
from ..ops.issl_compact import (ALIGN, LANES, DepthBoundError,
                                auto_superchunk, build_run, normalize_caps,
                                plan_query_occupancy)
from ..ops.issl_jax import ScorerConfig, score_page_core
from ..ops.tables import CFD_PAM_NGG_INDEX, cfd_pam_penalties, cfd_pos_penalties


def shard_index(index: IsslIndex, n_shards: int) -> list[IsslIndex]:
    """Split an index into ``n_shards`` site-id-contiguous sub-indexes."""
    n = index.num_sites
    bounds = [(n * k) // n_shards for k in range(n_shards + 1)]
    shards = []
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        shards.append(
            IsslIndex(
                seq_length=index.seq_length,
                slice_width=index.slice_width,
                seq_count=int(index.occurrences[lo:hi].sum()),
                site_sigs=index.site_sigs[lo:hi].copy(),
                occurrences=index.occurrences[lo:hi].copy(),
            )
        )
    return shards


def shard_bounds(num_sites: int, n_shards: int) -> list[tuple[int, int]]:
    """Deterministic site-range split — every host computes the same
    bounds (and hence the same pad size) from the global site count."""
    b = [(num_sites * k) // n_shards for k in range(n_shards + 1)]
    return [(b[k], b[k + 1]) for k in range(n_shards)]


class ShardedIsslScorer:
    """ISSL scorer over a device mesh.

    Single-process meshes: ('shard',) or ('q', 'shard'). Multi-host
    meshes (jax.distributed): ('host', 'q', 'shard') with the index
    sharded over ``index_axes = ('host', 'shard')`` — the partial-sum
    merge then psums over both axes, crossing the network on 'host' and
    the host's device interconnect on 'shard'. Construct with :meth:`from_local_shards` in multi-host mode
    so each process only ever materializes its own site ranges
    (SURVEY.md §2.3 distributed-backend row).
    """

    # the per-device arithmetic is IsslScorer's compensated f32 tier
    score_band = 0.05

    def __init__(
        self,
        index: IsslIndex | None,
        mesh: Mesh,
        max_dist: int | None = None,
        query_block: int = 256,
        work_block: int = 1 << 16,
        dtype=jnp.float32,
        index_axes: tuple[str, ...] = ("shard",),
        _local: dict | None = None,
    ):
        for a in index_axes:
            if a not in mesh.axis_names:
                raise ValueError(f"mesh must have a {a!r} axis")
        self.mesh = mesh
        self.index_axes = tuple(index_axes)
        self.n_shards = int(np.prod([mesh.shape[a] for a in self.index_axes]))
        self.n_q = mesh.shape.get("q", 1)
        self.has_q_axis = "q" in mesh.axis_names
        self.query_block = int(query_block)
        self.dtype = jnp.dtype(dtype)
        spec_sharded = P(self.index_axes)

        if _local is None:
            shards = shard_index(index, self.n_shards)
            npad = max(s.num_sites for s in shards)
            stacked = {k: [] for k in ("list_lo", "list_hi", "list_occ",
                                       "bucket_offsets")}
            for s in shards:
                arrs = s.device_arrays(pad_to=npad)
                for k in stacked:
                    stacked[k].append(arrs[k])
            stacked = {k: np.stack(v) for k, v in stacked.items()}
            meta = dict(seq_length=index.seq_length,
                        slice_width=index.slice_width,
                        slice_count=index.slice_count,
                        max_dist=index.max_dist)

            def put(a, p):
                return jax.device_put(a, NamedSharding(mesh, p))
        else:
            stacked, npad, meta = (_local["stacked"], _local["npad"],
                                   _local["meta"])

            def put(a, p):
                sh = NamedSharding(mesh, p)
                rows = self.n_shards  # global leading dim
                return jax.make_array_from_process_local_data(
                    sh, a, (rows,) + a.shape[1:])

        self.list_lo = put(
            stacked["list_lo"].reshape(stacked["list_lo"].shape[0], -1)
            .view(np.uint32), spec_sharded)
        self.list_hi = put(
            stacked["list_hi"].reshape(stacked["list_hi"].shape[0], -1)
            .view(np.uint32), spec_sharded)
        self.list_occ = put(
            stacked["list_occ"].reshape(stacked["list_occ"].shape[0], -1),
            spec_sharded)
        self.bucket_offsets = put(stacked["bucket_offsets"], spec_sharded)
        self.pos_pen = put(
            np.broadcast_to(
                cfd_pos_penalties().reshape(-1).astype(self.dtype),
                (stacked["bucket_offsets"].shape[0], 320),
            ).copy(),
            spec_sharded,
        )

        self.cfg = ScorerConfig(
            slice_count=meta["slice_count"],
            slice_width=meta["slice_width"],
            work_block=int(work_block),
            max_dist=meta["max_dist"] if max_dist is None else int(max_dist),
            npad=npad,
            pam_ngg=float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX]),
            dtype=str(self.dtype),
            method=None,
            maximum_sum=None,
        )
        self._step = self._build_step()

    @classmethod
    def from_local_shards(
        cls,
        local_shards: list[IsslIndex],
        mesh: Mesh,
        global_num_sites: int,
        *,
        max_dist: int | None = None,
        query_block: int = 256,
        work_block: int = 1 << 16,
        dtype=jnp.float32,
        index_axes: tuple[str, ...] = ("host", "shard"),
    ):
        """Multi-host construction: this process supplies only its own
        site-range shards (in global shard order for this host's rows of
        the index axes); the global device array is assembled across
        processes without any host materializing the full index."""
        n_shards = int(np.prod([mesh.shape[a] for a in index_axes]))
        bounds = shard_bounds(global_num_sites, n_shards)
        npad = max(hi - lo for lo, hi in bounds)
        stacked = {k: [] for k in ("list_lo", "list_hi", "list_occ",
                                   "bucket_offsets")}
        for s in local_shards:
            arrs = s.device_arrays(pad_to=npad)
            for k in stacked:
                stacked[k].append(arrs[k])
        stacked = {k: np.stack(v) for k, v in stacked.items()}
        s0 = local_shards[0]
        meta = dict(seq_length=s0.seq_length, slice_width=s0.slice_width,
                    slice_count=s0.slice_count, max_dist=s0.max_dist)
        return cls(None, mesh, max_dist=max_dist, query_block=query_block,
                   work_block=work_block, dtype=dtype, index_axes=index_axes,
                   _local=dict(stacked=stacked, npad=npad, meta=meta))

    def _build_step(self):
        cfg = self.cfg
        mesh = self.mesh
        index_axes = self.index_axes

        def per_device(q_lo, q_hi, q_valid, list_lo, list_hi, list_occ,
                       bucket_offsets, pos_pen):
            mit, cfd = score_page_core(
                cfg, q_lo, q_hi, q_valid,
                list_lo[0], list_hi[0], list_occ[0], bucket_offsets[0],
                pos_pen[0],
            )
            # merge partial sums across index shards (and hosts, when
            # the mesh has a 'host' axis)
            mit = jax.lax.psum(mit, axis_name=index_axes)
            cfd = jax.lax.psum(cfd, axis_name=index_axes)
            return mit, cfd

        qspec = P("q") if self.has_q_axis else P()
        shard_spec = P(self.index_axes)
        mapped = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(qspec, qspec, qspec, shard_spec, shard_spec,
                      shard_spec, shard_spec, shard_spec),
            out_specs=(qspec, qspec),
        )
        return jax.jit(mapped)

    def _to_global(self, arr: np.ndarray):
        """Host numpy -> global device array (replicated over 'host')."""
        if jax.process_count() == 1:
            return jnp.asarray(arr)
        spec = P("q") if self.has_q_axis else P()
        return jax.make_array_from_process_local_data(
            NamedSharding(self.mesh, spec), arr, arr.shape)

    @staticmethod
    def _to_local(arr) -> np.ndarray:
        """Global device array -> host numpy. Works in multi-host mode
        because query outputs are replicated over 'host': this process's
        addressable shards cover the full global array."""
        if jax.process_count() == 1:
            return np.asarray(arr)
        out = np.empty(arr.shape, arr.dtype)
        for sh in arr.addressable_shards:
            out[sh.index] = np.asarray(sh.data)
        return out

    def score_sums(self, query_sigs: np.ndarray):
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        qb = self.query_block * self.n_q
        mit = np.zeros(n, dtype=np.float64)
        cfd = np.zeros(n, dtype=np.float64)
        for i in range(0, n, qb):
            chunk = sigs[i:i + qb]
            pad = qb - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros(pad, dtype=np.uint64)])
            lo, hi = sig_split(chunk)
            q_valid = np.arange(qb) < (qb - pad)
            m, c = self._step(
                self._to_global(lo.view(np.uint32)),
                self._to_global(hi.view(np.uint32)),
                self._to_global(q_valid),
                self.list_lo, self.list_hi, self.list_occ,
                self.bucket_offsets, self.pos_pen,
            )
            m = self._to_local(m).astype(np.float64)
            c = self._to_local(c).astype(np.float64)
            mit[i:i + qb] = m[: qb - pad] if pad else m
            cfd[i:i + qb] = c[: qb - pad] if pad else c
        return mit, cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)


class ShardedCompactIsslScorer:
    """The compact two-phase engine over a device mesh.

    Same sharding contract as :class:`ShardedIsslScorer` — site-range
    index shards (shard-local first-clean-slice dedup stays exact,
    isslScoreOfftargets.cpp:385-387), queries replicated over the index
    axes (optionally split over 'q'), one ``psum`` of the per-query
    partial MIT/CFD sums — but the per-device program is the compact
    engine's full pipeline (ops/issl_compact.build_run): the hit-moment
    finder, moment decode, sparse f32 scoring of the hits. The only
    data-dependent shape, the max per-bucket query occupancy QB, is a
    property of the query page alone, so all shards share one compiled
    program. The
    compaction-cap header is ``pmax``-merged across shards so the host's
    overflow check sees the worst device; an overflowing page splits and
    retries exactly like the single-chip engine.

    Full-scan semantics: verdicts exact for mit/cfd/and/or; wrap with the
    hybrid near-threshold re-score for reference-exact verdicts on all
    five methods.
    """

    # per-shard score path is the compact engine's plain-f32 tier; the
    # cross-shard psum adds one f32 reduction — same band as single-chip
    score_band = 0.05

    def __init__(self, index: IsslIndex | None, mesh: Mesh,
                 max_dist: int | None = None, query_page: int = 65536,
                 chunk: int = 4096, qb_cap: int = 512, nz_cap: int = 1 << 17,
                 caps: tuple | None = None,
                 superchunk: int | None = None,
                 interpret: bool | None = None,
                 index_axes: tuple[str, ...] = ("shard",),
                 _local: dict | None = None):

        for a in index_axes:
            if a not in mesh.axis_names:
                raise ValueError(f"mesh must have a {a!r} axis")
        self.mesh = mesh
        self.index_axes = tuple(index_axes)
        self.n_shards = int(np.prod([mesh.shape[a] for a in self.index_axes]))
        self.n_q = mesh.shape.get("q", 1)
        self.has_q_axis = "q" in mesh.axis_names
        self.query_page = int(query_page)
        self.chunk = int(chunk)
        self.qb_cap = int(qb_cap)
        self.caps = normalize_caps(caps, nz_cap)
        self.interpret = resolve_interpret(interpret,
                                           mesh.devices.flat[0].platform)

        if _local is None:
            if index.slice_width != 8 or index.seq_length != 20:
                raise ValueError("compact engine supports l=20, w=8")
            shards = shard_index(index, self.n_shards)
            per = [s.device_arrays_aligned(align=ALIGN, tail=self.chunk)
                   for s in shards]
            meta = dict(slice_count=index.slice_count,
                        slice_width=index.slice_width,
                        max_dist=index.max_dist,
                        maxblen=max(int(p["bucket_lens"].max())
                                    for p in per))
            stacked = _stack_dense_shards(per, LANES)

            def put(a, p):
                return jax.device_put(a, NamedSharding(mesh, p))
        else:
            stacked, meta = _local["stacked"], _local["meta"]

            def put(a, p):
                sh = NamedSharding(mesh, p)
                return jax.make_array_from_process_local_data(
                    sh, a, (self.n_shards,) + a.shape[1:])

        if meta["maxblen"] >= (1 << 22):
            raise DepthBoundError(
                f"bucket with {meta['maxblen']:,} entries exceeds the "
                "moment decoder's 2^22 rank-exactness bound")
        self._nchmax = max(1, -(-meta["maxblen"] // self.chunk))
        # global nchmax => same superchunk size on every shard/process
        self.superchunk = (auto_superchunk(self._nchmax)
                           if superchunk is None else int(superchunk))
        self.S = meta["slice_count"]
        self.B = 1 << meta["slice_width"]
        self.slice_width = meta["slice_width"]
        self.max_dist = (meta["max_dist"] if max_dist is None
                         else int(max_dist))
        self._rows_per_slice = stacked["entries"].shape[2] // self.S
        spec = P(self.index_axes)
        self.entries = put(stacked["entries"], spec)       # (K, 3, rows, 128)
        self.bucket_offsets = put(stacked["bucket_offsets"], spec)
        self.bucket_lens = put(stacked["bucket_lens"], spec)
        self.page_stats: list[tuple[int, ...]] = []
        self._steps: dict[int, callable] = {}

    @classmethod
    def from_local_shards(cls, local_shards: list[IsslIndex], mesh: Mesh,
                          global_num_sites: int, *,
                          max_dist: int | None = None,
                          query_page: int = 65536, chunk: int = 4096,
                          qb_cap: int = 512, nz_cap: int = 1 << 17,
                          caps: tuple | None = None,
                          superchunk: int | None = None,
                          interpret: bool | None = None,
                          index_axes: tuple[str, ...] = ("host", "shard")):
        """Multi-host construction from this process's own site-range
        shards (cf. ShardedIsslScorer.from_local_shards). Two global
        quantities must agree across processes for a common compiled
        program: the padded entry width and the moment-plane depth
        nchmax. The entry width uses an analytic bound every process
        computes alike: device_arrays_aligned pads each bucket to an
        ALIGN multiple (< ALIGN waste per bucket), adds a ``chunk`` tail
        and rounds the total up to ALIGN, which (B+1)*ALIGN + chunk
        over-covers. nchmax comes from the global max bucket length via
        one tiny process_allgather at build time."""
        s0 = local_shards[0]
        per = [s.device_arrays_aligned(align=ALIGN, tail=chunk)
               for s in local_shards]
        local_maxblen = max(int(p["bucket_lens"].max()) for p in per)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            global_maxblen = int(multihost_utils.process_allgather(
                np.asarray(local_maxblen, dtype=np.int64)).max())
        else:
            global_maxblen = local_maxblen
        n_shards = int(np.prod([mesh.shape[a] for a in index_axes]))
        bounds = shard_bounds(global_num_sites, n_shards)
        worst = max(hi - lo for lo, hi in bounds)
        b_count = 1 << s0.slice_width
        epad_bound = worst + (b_count + 1) * ALIGN + chunk
        epad_bound = -(-epad_bound // ALIGN) * ALIGN
        stacked = _stack_dense_shards(per, LANES, epad=epad_bound)
        meta = dict(slice_count=s0.slice_count, slice_width=s0.slice_width,
                    max_dist=s0.max_dist, maxblen=global_maxblen)
        return cls(None, mesh, max_dist=max_dist, query_page=query_page,
                   chunk=chunk, qb_cap=qb_cap, nz_cap=nz_cap, caps=caps,
                   superchunk=superchunk, interpret=interpret,
                   index_axes=index_axes,
                   _local=dict(stacked=stacked, meta=meta))

    def _get_step(self, qb: int):
        if qb in self._steps:
            return self._steps[qb]
        run = build_run(S=self.S, B=self.B, nchmax=self._nchmax,
                        chunk=self.chunk, qb=qb, max_dist=self.max_dist,
                        rows_per_slice=self._rows_per_slice,
                        caps=self.caps, superchunk=self.superchunk,
                        interpret=self.interpret)
        index_axes = self.index_axes

        def per_device(q_lo, q_hi, boff, blens, entries):
            header, mit, cfd = run(q_lo, q_hi, boff[0], blens[0],
                                   entries[0])
            mit = jax.lax.psum(mit, axis_name=index_axes)
            cfd = jax.lax.psum(cfd, axis_name=index_axes)
            # worst per-device compaction populations decide overflow
            header = jax.lax.pmax(header, axis_name=index_axes)
            return header, mit, cfd

        qspec = P("q") if self.has_q_axis else P()
        sspec = P(self.index_axes)
        mapped = jax.shard_map(
            per_device, mesh=self.mesh,
            in_specs=(qspec, qspec, sspec, sspec, sspec),
            out_specs=(qspec, qspec, qspec), check_vma=False)
        fn = jax.jit(mapped)
        self._steps[qb] = fn
        return fn

    def _to_global(self, arr: np.ndarray):
        if jax.process_count() == 1:
            return jnp.asarray(arr)
        spec = P("q") if self.has_q_axis else P()
        return jax.make_array_from_process_local_data(
            NamedSharding(self.mesh, spec), arr, arr.shape)

    def score_sums(self, query_sigs: np.ndarray):
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        out_mit = np.zeros(n, dtype=np.float64)
        out_cfd = np.zeros(n, dtype=np.float64)
        pending = []

        def dispatch(lo_idx, page):
            # whole-page occupancy upper-bounds every 'q' sub-page
            qb, _need = plan_query_occupancy(
                page, self.S, self.B, self.slice_width, self.qb_cap)
            if qb is None:
                half = page.shape[0] // 2
                if half == 0:
                    raise RuntimeError("query bucket overflow; raise qb_cap")
                dispatch(lo_idx, page[:half])
                dispatch(lo_idx + half, page[half:])
                return
            pad = (-page.shape[0]) % self.n_q
            padded = (np.concatenate([page, np.zeros(pad, np.uint64)])
                      if pad else page)
            lo, hi = sig_split(padded)
            fn = self._get_step(qb)
            out = fn(self._to_global(lo.view(np.uint32)),
                     self._to_global(hi.view(np.uint32)),
                     self.bucket_offsets, self.bucket_lens, self.entries)
            pending.append((lo_idx, page, out))

        for i in range(0, n, self.query_page):
            dispatch(i, sigs[i:i + self.query_page])

        while pending:
            if jax.process_count() == 1:
                fetched = jax.device_get([o for _, _, o in pending])
            else:
                fetched = [tuple(ShardedIsslScorer._to_local(x) for x in o)
                           for _, _, o in pending]
            retry = []
            for (lo_idx, page, _), (header, m, c) in zip(pending, fetched):
                # per-'q'-group headers stack along axis 0: take the max
                hdr = np.asarray(header).reshape(-1, 8).max(axis=0)
                pops = tuple(int(x) for x in hdr[:7])
                self.page_stats.append(pops)
                if any(p > cap for p, cap in zip(pops, self.caps)):
                    if page.shape[0] < 2:
                        raise RuntimeError(
                            "hit compaction overflow on a single query; "
                            "raise nz_cap")
                    retry.append((lo_idx, page))
                    continue
                ln = page.shape[0]
                out_mit[lo_idx:lo_idx + ln] = m[:ln]
                out_cfd[lo_idx:lo_idx + ln] = c[:ln]
            pending = []
            for lo_idx, page in retry:
                half = page.shape[0] // 2
                dispatch(lo_idx, page[:half])
                dispatch(lo_idx + half, page[half:])
        return out_mit, out_cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)


def _stack_dense_shards(per: list[dict], lanes: int,
                        epad: int | None = None) -> dict[str, np.ndarray]:
    """Per-shard device_arrays_aligned dicts -> stacked entry planes.

    Pads every shard's entry dimension to a common ``epad`` (dead
    entries: impossible signature, occ 0 — they never contribute) and
    deinterleaves to the compact engine's (K, 3, S*epad/lanes, lanes) u32
    plane layout."""
    if epad is None:
        epad = max(p["list_lo"].shape[1] for p in per)
    else:
        have = max(p["list_lo"].shape[1] for p in per)
        if have > epad:
            raise ValueError(f"shard epad {have} exceeds bound {epad}")
    planes, boffs, blens = [], [], []
    for p in per:
        s_count, e = p["list_lo"].shape
        width = epad - e

        def padded(a, fill):
            return (np.pad(a, ((0, 0), (0, width)), constant_values=fill)
                    if width else a)

        planes.append(np.stack([
            padded(p["list_lo"], -1).reshape(-1, lanes).view(np.uint32),
            padded(p["list_hi"], -1).reshape(-1, lanes).view(np.uint32),
            padded(p["list_occ"], 0).reshape(-1, lanes).astype(np.uint32),
        ]))
        boffs.append(p["bucket_offsets"])
        blens.append(p["bucket_lens"])
    return dict(entries=np.stack(planes),
                bucket_offsets=np.stack(boffs),
                bucket_lens=np.stack(blens))


def make_mesh(n_shards: int | None = None, n_q: int = 1,
              devices=None) -> Mesh:
    """Build a ('q', 'shard') mesh over ``devices`` (default: all)."""
    devices = np.array(jax.devices() if devices is None else devices)
    if n_shards is None:
        n_shards = devices.size // n_q
    use = devices[: n_q * n_shards].reshape(n_q, n_shards)
    return Mesh(use, axis_names=("q", "shard"))
