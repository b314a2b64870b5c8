"""CSV-level pipeline parity: the reference Crackling, driven end-to-end
with our engines as its external binaries (scoreOfftargets CLI + the
RNAfold/bowtie2 shims), vs our pipeline on the same inputs — the output
CSVs must agree column-for-column (floats to 1e-6 relative).

This closes the 26-column contract beyond per-stage unit parity: every
divergence in gating order, pagination, keying quirks, or formatting
shows up as a cell diff.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")

pytestmark = pytest.mark.skipif(not REFERENCE.exists(),
                                reason="reference repo not available")


def _write_fasta(path, records, width=70):
    with open(path, "w") as fp:
        for name, seq in records:
            fp.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fp.write(seq[i:i + width] + "\n")


CONFIG = """
[general]
name = parity
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
binary = {issl_bin}
method = and
threads = 4
page-length = 5000000
score-threshold = 75
max-distance = 4

[sgrnascorer2]
model = {model}
score-threshold = 0

[bowtie2]
binary = {bowtie2_bin}
threads = 4
page-length = 5000000

[rnafold]
binary = {rnafold_bin}
threads = 4
page-length = 5000000
low_energy_threshold = -30
high_energy_threshold = -18

[accelerator]
engine = auto
rnafold-backend = native
"""


@pytest.fixture(scope="module")
def parity_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(2026)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    c1 = bases[rng.integers(0, 4, 60_000)].tobytes().decode()
    c2 = bases[rng.integers(0, 4, 40_000)].tobytes().decode()
    genome = td / "genome.fa"
    _write_fasta(genome, [("chr1", c1), ("chr2", c2)])
    exons = td / "exons.fa"
    # include a duplicated exon so duplicate marking is exercised
    _write_fasta(exons, [("e1", c1[2000:4200]), ("e2", c2[1000:2600]),
                         ("e3", c1[2000:4200])])

    env = dict(os.environ)
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "crackling_jax.utils.run_cli", *a],
        check=True, capture_output=True, cwd=REPO, env=env)
    sites = td / "sites.txt"
    run("extractOfftargets", str(sites), str(genome))
    issl = td / "g.issl"
    run("createIsslIndex", str(sites), "20", "8", str(issl))

    from crackling_jax.utils.shims import write_shim_scripts

    shims = write_shim_scripts(str(td))
    # ISSL scorer shim: argv/stdout-compatible scoreOfftargets CLI
    issl_shim = td / "issl-shim"
    issl_shim.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from crackling_jax.utils.cli import main_score_offtargets\n"
        "sys.exit(main_score_offtargets(sys.argv[1:]) or 0)\n")
    issl_shim.chmod(0o755)

    model = REFERENCE / "src/crackling/utils/data/model-py3.txt"
    return dict(td=td, genome=genome, exons=exons, issl=issl,
                shims=shims, issl_shim=issl_shim, model=model)


def _config_for(world, outdir):
    return CONFIG.format(
        exons=world["exons"], issl=world["issl"], genome=world["genome"],
        outdir=outdir, issl_bin=world["issl_shim"],
        bowtie2_bin=world["shims"]["bowtie2"],
        rnafold_bin=world["shims"]["rnafold"], model=world["model"])


def test_csv_parity_vs_reference(parity_world):
    td = parity_world["td"]

    ref_out = td / "ref_out"
    ref_out.mkdir()
    ref_cfg = td / "ref_config.ini"
    ref_cfg.write_text(_config_for(parity_world, ref_out))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REFERENCE / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "crackling.utils.Crackling_cli",
         "-c", str(ref_cfg)],
        capture_output=True, text=True, cwd=td, env=env, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]

    our_out = td / "our_out"
    our_out.mkdir()
    our_cfg = td / "our_config.ini"
    our_cfg.write_text(_config_for(parity_world, our_out))
    env2 = dict(os.environ)
    env2["CRACKLING_PLATFORM"] = "cpu"
    env2["PYTHONPATH"] = str(REPO)
    r2 = subprocess.run(
        [sys.executable, "-m", "crackling_jax.utils.run_cli", "Crackling",
         "-c", str(our_cfg)],
        capture_output=True, text=True, cwd=td, env=env2, timeout=900)
    assert r2.returncode == 0, r2.stdout[-3000:] + r2.stderr[-3000:]

    ref_rows = list(csv.reader(open(ref_out / "parity-guides.txt")))
    our_rows = list(csv.reader(open(our_out / "parity-guides.txt")))
    assert ref_rows[0] == our_rows[0], "header mismatch"
    assert len(ref_rows) == len(our_rows), (
        f"row count: ref {len(ref_rows)} vs ours {len(our_rows)}")

    header = ref_rows[0]
    diffs = []
    for rno, (ra, rb) in enumerate(zip(ref_rows[1:], our_rows[1:]), 1):
        for col, (a, b) in enumerate(zip(ra, rb)):
            if a == b:
                continue
            try:
                fa, fb = float(a), float(b)
                if np.isclose(fa, fb, rtol=1e-6, atol=1e-9):
                    continue
            except ValueError:
                pass
            diffs.append((rno, header[col], a, b))
    assert not diffs, f"{len(diffs)} cell diffs, first 20: {diffs[:20]}"
