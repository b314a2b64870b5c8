"""Multihost pipeline wiring: 2-process end-to-end run.

Two real processes each run the FULL pipeline (extract -> efficiency ->
positioning -> sharded ISSL scoring) from one shared config, connected
through ``[accelerator] coordinator-address / process-count`` ->
jax.distributed.
Each process loads only its own site ranges from the .issl file; the
per-query partial sums psum across the ('host','q','shard') mesh, so
both processes must emit identical CSVs — compared here against each
other (byte-equal) and against a single-process ``engine = sharded`` run
on the same inputs (verdicts and all non-score cells equal; the float
score cells to f32 reduction-order tolerance).
"""

import csv
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from crackling_jax.constants import GUIDE_COLUMNS

REPO = Path(__file__).resolve().parent.parent

CONFIG = """
[general]
name = mh
optimisation = high

[consensus]
n = 2
mm10db = True
sgrnascorer2 = True
chopchop = True

[input]
exon-sequences = {exons}
offtarget-sites = {issl}
gff-annotation =
bowtie2-index = {genome}
batch-size = 5000000

[output]
dir = {outdir}
filename = guides.txt
delimiter = ,

[offtargetscore]
enabled = True
binary = ignored
method = and
threads = 4
page-length = 5000000
score-threshold = 75
max-distance = 4

[sgrnascorer2]
model = shipped
score-threshold = 0

[bowtie2]
binary = ignored
threads = 4
page-length = 5000000

[rnafold]
binary = RNAfold
threads = 4
page-length = 5000000
low_energy_threshold = -30
high_energy_threshold = -18

[accelerator]
engine = sharded
{extra}
"""

WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[2])
    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.run import Crackling
    cm = ConfigManager(sys.argv[1], print)
    assert cm.isConfigured()
    Crackling(cm)
    print("PIPE_OK", flush=True)
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chrom = bases[rng.integers(0, 4, 30_000)].tobytes().decode()
    genome = td / "genome.fa"
    genome.write_text(">chr1\n" + "\n".join(
        chrom[i:i + 70] for i in range(0, len(chrom), 70)) + "\n")
    exons = td / "exons.fa"
    exons.write_text(">exon1\n" + chrom[2000:2900] + "\n")

    sites_txt = td / "sites.txt"
    out = subprocess.run(
        [sys.executable, "-m", "crackling_jax.utils.run_cli",
         "extractOfftargets", str(sites_txt), str(genome)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr

    # multihost needs the reference-format .issl (range loading)
    from crackling_jax.codec import strings_to_sigs
    from crackling_jax.index import build_index, write_reference_issl

    sigs = strings_to_sigs(sites_txt.read_text().split(), 20)
    index = build_index(sigs)
    issl = td / "g.issl"
    write_reference_issl(index, str(issl))
    return dict(td=td, genome=genome, exons=exons, issl=issl)


def run_worker(config_path, env_extra=None, timeout=600):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-c", WORKER, str(config_path), str(REPO)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)


def read_csv(path):
    with open(path) as fp:
        return list(csv.reader(fp))


def test_two_process_pipeline_matches_single(world, tmp_path):
    td = world["td"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    # single-process sharded run (8 virtual CPU devices = same 8 index
    # shards as the 2-host x 4-device mesh)
    out_single = tmp_path / "single"
    out_single.mkdir()
    cfg_single = tmp_path / "single.ini"
    cfg_single.write_text(CONFIG.format(
        exons=world["exons"], issl=world["issl"], genome=world["genome"],
        outdir=out_single, extra="cpu-devices = 8"))
    p = run_worker(cfg_single)
    out, _ = p.communicate(timeout=900)
    assert p.returncode == 0 and "PIPE_OK" in out, out

    # 2-process multihost run, each with its own output dir
    procs, outdirs = [], []
    for pid in (0, 1):
        outdir = tmp_path / f"proc{pid}"
        outdir.mkdir()
        outdirs.append(outdir)
        cfg = tmp_path / f"mh{pid}.ini"
        cfg.write_text(CONFIG.format(
            exons=world["exons"], issl=world["issl"],
            genome=world["genome"], outdir=outdir,
            extra=(f"coordinator-address = localhost:{port}\n"
                       "process-count = 2\n"
                       f"process-id = {pid}\n"
                       "cpu-devices = 4\n"
                       "mesh-q = 1\n")))
        procs.append(run_worker(cfg))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert "PIPE_OK" in out

    rows0 = read_csv(outdirs[0] / "mh-guides.txt")
    rows1 = read_csv(outdirs[1] / "mh-guides.txt")
    rows_s = read_csv(out_single / "mh-guides.txt")
    assert rows0 == rows1, "the two processes' CSVs differ"
    assert rows0[0] == GUIDE_COLUMNS
    assert len(rows0) == len(rows_s) > 10

    col = {c: i for i, c in enumerate(GUIDE_COLUMNS)}
    float_cols = {col["mitOfftargetscore"], col["cfdOfftargetscore"]}
    for rm, rs in zip(rows0[1:], rows_s[1:]):
        for i, (a, b) in enumerate(zip(rm, rs)):
            if i in float_cols and a not in ("?", "-") and b not in ("?", "-"):
                # f32 psum reduction order differs between the meshes
                assert abs(float(a) - float(b)) < 1e-3, (i, a, b)
            else:
                assert a == b, (GUIDE_COLUMNS[i], a, b)
