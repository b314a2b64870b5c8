"""Multi-host ISSL scoring: jax.distributed entry points.

SURVEY.md §2.3's north-star row: scale the sharded scorer beyond one host
with a ('host', 'q', 'shard') mesh — the index is sharded over
('host', 'shard') site ranges, query pages ride the within-host 'q' axis,
and the partial-sum merge psums across both index axes (the device
interconnect within a host, the network between hosts; the reference's
OpenMP-threaded single-host scan at isslScoreOfftargets.cpp:308-509 has
no equivalent).

Each process materializes only its own site ranges:
:func:`load_index_range` reads a site-id slice straight out of a
reference-format ``.issl`` file (signatures by seek, occurrences by a
single streamed pass over the slice-0 entry list), and
:meth:`ShardedIsslScorer.from_local_shards` assembles the global device
array from per-process local data.

Tested with 2 CPU processes over localhost (tests/test_distributed.py);
on real fleets, pass the coordinator address of process 0 and per-host
process ids, exactly like any jax.distributed program.
"""

from __future__ import annotations

import numpy as np

from ..index.build import IsslIndex
from .sharded import ShardedIsslScorer, shard_bounds

_HEADER_FIELDS = 6


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_devices: int | None = None):
    """Initialize jax.distributed for this process.

    ``cpu_devices`` forces the CPU backend with that many virtual devices
    per process (test/dev mode); leave None on accelerator hosts.
    """
    import jax

    if cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(cpu_devices))
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_mesh(n_q: int = 1, shards_per_host: int | None = None):
    """('host', 'q', 'shard') mesh: processes on the host axis, each
    host's local devices split q x shard."""
    import jax
    from jax.sharding import Mesh

    procs = jax.process_count()
    by_proc: dict[int, list] = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, []).append(d)
    local = len(by_proc[min(by_proc)])
    if shards_per_host is None:
        shards_per_host = local // n_q
    rows = []
    for p in sorted(by_proc):
        devs = by_proc[p][: n_q * shards_per_host]
        rows.append(np.array(devs).reshape(n_q, shards_per_host))
    return Mesh(np.stack(rows), axis_names=("host", "q", "shard"))


def load_index_range(path: str, lo: int, hi: int) -> IsslIndex:
    """Load sites [lo, hi) of a reference-format .issl file.

    Reads only the signature range (seek) plus one streamed pass over the
    slice-0 entry list for the occurrence counts — never the full index.
    The shard rebuilds its slice CSR locally, which keeps the first-clean-
    slice dedup shard-exact (see parallel/sharded.py docstring).
    """
    with open(path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.uint64, count=_HEADER_FIELDS)
        n, seq_length, _seq_count, slice_width, slice_count, scores_count = (
            int(x) for x in header)
        if not (0 <= lo <= hi <= n):
            raise ValueError(f"site range [{lo}, {hi}) outside 0..{n}")
        sigs_off = 8 * (_HEADER_FIELDS + 2 * scores_count)
        fp.seek(sigs_off + 8 * lo)
        site_sigs = np.fromfile(fp, dtype=np.uint64, count=hi - lo)
    entries_off = (sigs_off + 8 * n
                   + 8 * slice_count * (1 << slice_width))
    slice0 = np.memmap(path, dtype=np.uint64, mode="r",
                       offset=entries_off, shape=(n,))
    ids = (slice0 & np.uint64(0xFFFFFFFF)).astype(np.int64)
    occ_by_id = np.zeros(hi - lo, dtype=np.uint32)
    m = (ids >= lo) & (ids < hi)
    occ_by_id[ids[m] - lo] = (slice0[m] >> np.uint64(32)).astype(np.uint32)
    del slice0
    return IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=int(occ_by_id.sum()),
        site_sigs=site_sigs,
        occurrences=occ_by_id,
    )


def _local_shards_of(issl_path: str, mesh):
    import jax

    with open(issl_path, "rb") as fp:
        n = int(np.fromfile(fp, dtype=np.uint64, count=1)[0])
    n_hosts = mesh.shape["host"]
    n_shard = mesh.shape["shard"]
    bounds = shard_bounds(n, n_hosts * n_shard)
    pid = jax.process_index()
    return n, [
        load_index_range(issl_path, *bounds[pid * n_shard + k])
        for k in range(n_shard)
    ]


def multihost_scorer(issl_path: str, mesh, **kwargs) -> ShardedIsslScorer:
    """Build the sharded (order-exact XLA) scorer for this process from
    an .issl file, loading only the site ranges this host's devices own."""
    n, local_shards = _local_shards_of(issl_path, mesh)
    return ShardedIsslScorer.from_local_shards(
        local_shards, mesh, n, index_axes=("host", "shard"), **kwargs)


def multihost_fast_scorer(issl_path: str, mesh, **kwargs):
    """Build the fast multi-host scorer: the compact two-phase program
    per shard. Same loading contract as :func:`multihost_scorer` — each
    process materializes only its own site ranges. Raises DepthBoundError
    past the compact decoder's bucket-depth bound (the caller then
    builds :func:`multihost_scorer`)."""
    from .sharded import ShardedCompactIsslScorer

    n, local_shards = _local_shards_of(issl_path, mesh)
    return ShardedCompactIsslScorer.from_local_shards(
        local_shards, mesh, n, index_axes=("host", "shard"), **kwargs)
