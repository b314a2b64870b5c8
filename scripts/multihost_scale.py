"""Multihost scoring at bench scale: 2 real processes on the 27 Mbp index.

The 2-process e2e test (tests/test_distributed.py) runs a toy index;
this script gives the multihost path a scale datapoint. Two real
processes initialize ``jax.distributed`` over
localhost, build the ('host', 'q', 'shard') CPU mesh, load only their
own site ranges of the 5.06M-site bench .issl (per-process range
loading, parallel/distributed.load_index_range), and score a bench
query slice — the per-query partial MIT/CFD sums psum across the
process boundary. Process 0 records throughput; the parent checks
verdict agreement vs the reference binary on the same queries.

The engine is the sharded order-exact XLA scorer on a CPU mesh: each
worker forces the CPU backend (``cpu_devices``), so no process opens a
GPU and the two never contend for one card. Throughput here measures the
multihost *machinery* at scale, not accelerator speed.

Usage: python scripts/multihost_scale.py [--queries 4096]
Appends a record to scripts/multihost_scale_results.jsonl.
"""

import argparse
import json
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DATA = ROOT / "bench_data"

WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np
    pid = int(sys.argv[1]); port = sys.argv[2]
    issl = sys.argv[3]; qnpz = sys.argv[4]; out = sys.argv[5]
    sys.path.insert(0, sys.argv[6])
    from crackling_jax.parallel.distributed import (
        initialize, host_mesh, multihost_scorer)
    initialize(f"localhost:{port}", 2, pid, cpu_devices=2)
    import jax
    assert jax.process_count() == 2
    mesh = host_mesh(n_q=1)          # (host=2, q=1, shard=2)
    sc = multihost_scorer(issl, mesh, max_dist=4,
                          query_block=512, work_block=1 << 17)
    queries = np.load(qnpz)["queries"]
    t0 = time.time()
    sc.score_sums(queries[:512])     # compile + warm
    print(f"[worker {pid}] warm {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    mit, cfd = sc.score_sums(queries)
    dt = time.time() - t0
    if pid == 0:
        np.savez(out, mit=mit, cfd=cfd, seconds=dt)
    print(f"[worker {pid}] scored {len(queries)} in {dt:.1f}s "
          f"({len(queries) / dt:,.0f} guides/s)", flush=True)
""")


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=4096)
    args = ap.parse_args()

    issl = DATA / "g27m.issl"
    qfile = DATA / "g27m.queries65536.txt"
    refbin = DATA / "refbin" / "isslScoreOfftargets"
    for p in (issl, qfile, refbin):
        if not p.exists():
            raise SystemExit(f"missing {p} — run `python bench.py` once "
                             "to build the bench dataset")
    from crackling_jax.codec import sigs_to_strings, strings_to_sigs

    qstrs = qfile.read_text().split()[: args.queries]
    queries = strings_to_sigs(qstrs, 20)
    tmp = ROOT / "bench_data" / "mh_tmp"
    tmp.mkdir(exist_ok=True)
    qnpz = tmp / "queries.npz"
    np.savez(qnpz, queries=queries)
    out = tmp / "result.npz"

    port = free_port()
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port), str(issl),
             str(qnpz), str(out), str(ROOT)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    logs = [p.communicate(timeout=3600)[0] for p in procs]
    for pid, (p, lg) in enumerate(zip(procs, logs)):
        sys.stderr.write(lg)
        if p.returncode != 0:
            raise SystemExit(f"worker {pid} failed rc={p.returncode}")
    wall = time.time() - t0

    res = np.load(out)
    mit_sum, cfd_sum, dt = res["mit"], res["cfd"], float(res["seconds"])
    mit = 10000.0 / (100.0 + mit_sum)
    cfd = 10000.0 / (100.0 + cfd_sum)

    # reference binary on the same queries for verdict agreement
    qtxt = tmp / "q.txt"
    qtxt.write_text("".join(s + "\n" for s in sigs_to_strings(queries, 20)))
    ref = subprocess.run(
        [str(refbin), str(issl), str(qtxt), "4", "75", "and"],
        check=True, capture_output=True, text=True)
    lines = ref.stdout.strip().split("\n")
    ref_mit = np.array([float(l.split("\t")[1]) for l in lines])
    ref_cfd = np.array([float(l.split("\t")[2]) for l in lines])

    from crackling_jax.ops.issl_jax import verdicts

    ours_ok = verdicts(mit, cfd, 75.0, "and")
    ref_ok = verdicts(ref_mit, ref_cfd, 75.0, "and")
    agree = float(np.mean(ours_ok == ref_ok))
    acc = ours_ok & ref_ok
    sagree = float(np.mean(
        (np.abs(mit[acc] - ref_mit[acc]) < 2e-2)
        & (np.abs(cfd[acc] - ref_cfd[acc]) < 2e-2))) if acc.any() else 1.0

    rec = {
        "index": "g27m.issl",
        "distinct_sites": 5_063_644,
        "processes": 2,
        "mesh": {"host": 2, "q": 1, "shard": 2},
        "engine": "sharded-xla (CPU mesh)",
        "n_queries": int(len(queries)),
        "score_seconds": round(dt, 2),
        "guides_per_s": round(len(queries) / dt, 1),
        "wall_seconds": round(wall, 1),
        "verdict_agreement": agree,
        "accepted_score_agreement": sagree,
    }
    with open(ROOT / "scripts" / "multihost_scale_results.jsonl", "a") as fp:
        fp.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
