"""Multi-host scoring: 2-process jax.distributed CPU test.

Spawns two real processes that each initialize jax.distributed over
localhost, build a ('host', 'q', 'shard') mesh, load only their own site
ranges from the shared .issl file, and score a query page — exercising
the DCN-crossing psum over the ('host', 'shard') index axes. Results are
checked against the single-process brute-force oracle.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from crackling_jax.index import build_index
from crackling_jax.index.io import write_reference_issl
from crackling_jax.ops.oracle import score_bruteforce

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    pid = int(sys.argv[1]); port = sys.argv[2]; tmp = sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    from crackling_jax.parallel.distributed import (
        initialize, host_mesh, multihost_scorer)
    initialize(f"localhost:{port}", 2, pid, cpu_devices=4)
    import jax
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8
    mesh = host_mesh(n_q=2)          # (host=2, q=2, shard=2)
    assert dict(mesh.shape) == {"host": 2, "q": 2, "shard": 2}
    sc = multihost_scorer(os.path.join(tmp, "g.issl"), mesh,
                          max_dist=4, query_block=16, work_block=1 << 10)
    exp = np.load(os.path.join(tmp, "expected.npz"))
    mit, cfd = sc.score_sums(exp["queries"])
    np.testing.assert_allclose(mit, exp["mit"], rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(cfd, exp["cfd"], rtol=2e-6, atol=1e-6)
    # the fast path over the same mesh: compact program per shard,
    # DCN-crossing psum + process_allgather'd moment depth
    from crackling_jax.parallel.distributed import multihost_fast_scorer
    fast = multihost_fast_scorer(os.path.join(tmp, "g.issl"), mesh,
                                 max_dist=4, chunk=1024, query_page=128,
                                 interpret=True)
    fm, fc = fast.score_sums(exp["queries"])
    np.testing.assert_allclose(fm, exp["mit"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fc, exp["cfd"], rtol=1e-5, atol=1e-5)
    print(f"DIST_OK {pid}", flush=True)
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(17)
    base = rng.integers(0, 1 << 40, size=3000).astype(np.uint64)
    mut = []
    for sig in base[:600]:
        pos = rng.integers(0, 20)
        mut.append(
            (np.uint64(sig) & ~(np.uint64(3) << np.uint64(2 * pos)))
            | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos))
        )
    sites = np.concatenate([base, np.array(mut, dtype=np.uint64)])
    index = build_index(sites)
    write_reference_issl(index, str(td / "g.issl"))
    queries = np.concatenate(
        [base[:40], rng.integers(0, 1 << 40, 24).astype(np.uint64)])
    mit, cfd = score_bruteforce(queries, index.site_sigs,
                                index.occurrences, 4)
    np.savez(td / "expected.npz", queries=queries, mit=mit, cfd=cfd)
    return td, index


def test_load_index_range_matches_full(world):
    from crackling_jax.parallel.distributed import load_index_range

    td, index = world
    n = index.num_sites
    cuts = [0, n // 3, (2 * n) // 3, n]
    parts = [load_index_range(str(td / "g.issl"), cuts[k], cuts[k + 1])
             for k in range(3)]
    sigs = np.concatenate([p.site_sigs for p in parts])
    occ = np.concatenate([p.occurrences for p in parts])
    assert (sigs == index.site_sigs).all()
    assert (occ == index.occurrences).all()
    assert sum(p.seq_count for p in parts) == int(index.occurrences.sum())


def test_two_process_dcn_scoring(world, tmp_path):
    td, _ = world
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ)
    # the workers pick their own device count via jax_num_cpu_devices
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port), str(td),
             str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"DIST_OK {pid}" in out, out
