"""End-to-end pipeline tests on a synthetic mini-genome."""

import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from crackling_jax.constants import GUIDE_COLUMNS


@pytest.fixture(scope="module")
def mini_world(tmp_path_factory):
    """A tiny genome + exon file + off-target site list + config."""
    td = tmp_path_factory.mktemp("mini")
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chrom1 = bases[rng.integers(0, 4, 60_000)].tobytes().decode()
    chrom2 = bases[rng.integers(0, 4, 40_000)].tobytes().decode()

    genome = td / "genome.fa"
    genome.write_text(
        ">chr1 test\n" + "\n".join(chrom1[i:i + 70] for i in range(0, len(chrom1), 70))
        + "\n>chr2\n" + "\n".join(chrom2[i:i + 70] for i in range(0, len(chrom2), 70))
        + "\n"
    )
    exons = td / "exons.fa"
    exons.write_text(
        ">exon1\n" + chrom1[1000:2500] + "\n>exon2\n" + chrom2[5000:6200] + "\n"
    )

    sites = td / "offtargetSites.txt"
    out = subprocess.run(
        [sys.executable, "-m", "crackling_jax.utils.run_cli", "extractOfftargets",
         str(sites), str(genome)],
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr
    outdir = td / "out"
    outdir.mkdir()
    config = td / "config.ini"
    config.write_text(f"""
[general]
name = mini
optimisation = high

[consensus]
n = 2
mm10db = True
sgrnascorer2 = True
chopchop = True

[input]
exon-sequences = {exons}
offtarget-sites = {sites}
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
""")
    return dict(td=td, genome=genome, exons=exons, sites=sites,
                config=config, outdir=outdir, chrom1=chrom1, chrom2=chrom2)


def test_extract_offtargets_cli_sorted(mini_world):
    lines = mini_world["sites"].read_text().split()
    assert len(lines) > 1000
    assert lines == sorted(lines)
    assert all(len(l) == 20 for l in lines[:50])


def test_full_pipeline(mini_world):
    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.run import Crackling

    cm = ConfigManager(str(mini_world["config"]), lambda m: None)
    assert cm.isConfigured()
    Crackling(cm)

    out_file = mini_world["outdir"] / "mini-guides.txt"
    assert out_file.exists()
    rows = list(csv.reader(open(out_file)))
    assert rows[0] == GUIDE_COLUMNS
    body = rows[1:]
    assert len(body) > 50
    col = {c: i for i, c in enumerate(GUIDE_COLUMNS)}

    # every guide seq is a 23-mer ending in GG (candidate contract)
    for r in body[:100]:
        assert len(r[col["seq"]]) == 23
        assert r[col["seq"]][-2:] == "GG"

    # consensus counts are consistent with the three tool verdicts
    for r in body:
        votes = sum(r[col[f]] == "1" for f in
                    ("acceptedByMm10db", "acceptedBySgRnaScorer", "passedG20"))
        assert r[col["consensusCount"]] == str(votes)

    # with optimisation=high, specificity runs only for consensus-passing
    # guides: rejected-consensus guides keep '?' for off-target fields
    for r in body:
        if int(r[col["consensusCount"]]) < 2:
            assert r[col["passedOffTargetScore"]] == "?"

    # guides extracted from the genome itself should position on chr1/chr2
    positioned = [r for r in body if r[col["bowtieChr"]] not in ("?", "")]
    assert positioned, "no guides reached positioning"
    for r in positioned[:20]:
        assert r[col["bowtieChr"]] in ("chr1", "chr2")
        start = int(r[col["bowtieStart"]])
        end = int(r[col["bowtieEnd"]])
        assert end == start + 22
        # verify the located site actually matches the guide's 20-mer
        chrom = mini_world["chrom1" if r[col["bowtieChr"]] == "chr1" else "chrom2"]
        window = chrom[start - 1:start + 22]
        from crackling_jax.codec import rc

        # the located 23-mer window must contain the guide on one strand:
        # forward (guide spelled out) or reverse (window is rc of the guide)
        g23 = r[col["seq"]]
        assert window in (g23, rc(g23)), (g23, window)
    # off-target scores for scored guides are in (0, 100]
    scored = [r for r in body if r[col["mitOfftargetscore"]] not in ("?", "")]
    for r in scored:
        assert 0.0 < float(r[col["mitOfftargetscore"]]) <= 100.0
        assert 0.0 < float(r[col["cfdOfftargetscore"]]) <= 100.0


def test_pipeline_output_blocked_without_resume(mini_world):
    from crackling_jax.pipeline.config import ConfigManager

    msgs = []
    cm = ConfigManager(str(mini_world["config"]), msgs.append)
    # output file now exists from the previous test -> must refuse
    assert not cm.isConfigured()
    assert any("already exists" in m for m in msgs)


def test_resume_manifest(tmp_path):
    from crackling_jax.pipeline.metrics import ResumeManifest, Metrics

    out = tmp_path / "g.csv"
    out.write_text("x")
    m = ResumeManifest(str(out), "abc")
    assert not m.exists()
    assert m.load() == 0
    m.mark(2, 5)
    assert m.exists()
    m2 = ResumeManifest(str(out), "abc")
    assert m2.load() == 2
    # config changed -> manifest ignored
    m3 = ResumeManifest(str(out), "different")
    assert m3.load() == 0
    m.finish()
    assert not m.exists()

    metrics = Metrics(str(tmp_path / "m.json"))
    with metrics.stage("phase1"):
        pass
    metrics.count("items", 7)
    metrics.flush()
    import json

    d = json.load(open(tmp_path / "m.json"))
    assert "phase1" in d["stage_seconds"]
    assert d["counters"]["items"] == 7


def test_pipeline_resume_skips_completed(mini_world, tmp_path):
    """A crashed run resumes at the right batch and completes the output."""
    import shutil

    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.metrics import ResumeManifest, config_fingerprint
    from crackling_jax.pipeline.run import Crackling

    outdir = tmp_path / "resume-out"
    outdir.mkdir()
    cfg = tmp_path / "config.ini"
    text = mini_world["config"].read_text().replace(
        str(mini_world["outdir"]), str(outdir))
    cfg.write_text(text + "\nresume = True\n"
                   if "[output]" not in text else
                   text.replace("[output]", "[output]\nresume = True"))

    cm = ConfigManager(str(cfg), lambda m: None)
    assert cm.isConfigured()
    out_file = outdir / "mini-guides.txt"
    # simulate a crash after 0 completed batches: header written, manifest at 0
    out_file.write_text("")
    ResumeManifest(str(out_file), config_fingerprint(cm._parser)).mark(0, 1)
    cm2 = ConfigManager(str(cfg), lambda m: None)
    assert cm2.isConfigured()  # resume=True allows existing output
    Crackling(cm2)
    rows = out_file.read_text().strip().split("\n")
    assert len(rows) > 50
    assert not (outdir / "mini-guides.txt.resume.json").exists()


def test_v1_0_0_config_migration(mini_world, tmp_path, monkeypatch):
    """A v1.0.0 Python-dict config (reference ConfigManager.py:58-134)
    loads, migrates to INI, and writes the <path>.ini copy."""
    from crackling_jax.pipeline.config import ConfigManager

    outdir = tmp_path / "o"
    outdir.mkdir()
    mod = tmp_path / "oldconf.py"
    mod.write_text(f"""
CONFIG = {{
    'name': 'legacy',
    'consensus': {{'n': 2}},
    'input': {{
        'exon-sequences': r'{mini_world["exons"]}',
        'offtarget-sites': r'{mini_world["sites"]}',
        'gff-annotation': '',
        'bowtie2-index': r'{mini_world["genome"]}',
    }},
    'output': {{'dir': r'{outdir}', 'fileName': 'g.txt', 'delimiter': ','}},
    'offtargetscore': {{'binary': 'x', 'threads': 4,
                        'score-threshold': 75, 'max-distance': 4}},
    'sgrnascorer2': {{'model': 'shipped', 'score-threshold': 0}},
    'bowtie2': {{'binary': 'x', 'threads': 4}},
    'rnafold': {{'binary': 'x', 'threads': 4,
                 'low_energy_threshold': -30, 'high_energy_threshold': -18}},
}}
""")
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    msgs = []
    cm = ConfigManager("oldconf", msgs.append)
    assert cm.isConfigured(), msgs
    assert cm["general"]["name"] == "legacy"
    assert cm["consensus"].getboolean("mm10db") is True
    assert cm["offtargetscore"]["score-threshold"] == "75"
    assert (tmp_path / "oldconf.ini").exists()


def test_multibatch_spill_matches_single_batch(mini_world, tmp_path):
    """batch-size smaller than the candidate count spills the record
    arrays to disk (memmap-backed batches) and produces the same CSV as a
    single-batch run; the spill dir is cleaned up afterwards."""
    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.run import Crackling

    outdir = tmp_path / "mb-out"
    outdir.mkdir()
    text = mini_world["config"].read_text().replace(
        str(mini_world["outdir"]), str(outdir)).replace(
        "batch-size = 5000000", "batch-size = 150")
    cfg = tmp_path / "config.ini"
    cfg.write_text(text)
    cm = ConfigManager(str(cfg), lambda m: None)
    assert cm.isConfigured()
    Crackling(cm)

    single = (mini_world["outdir"] / "mini-guides.txt").read_text()
    multi = (outdir / "mini-guides.txt").read_text()
    assert multi == single
    assert not list(outdir.glob("crackling-batches-*")), "spill not cleaned"


def test_w4_index_through_pipeline(mini_world, tmp_path):
    """A sliceWidth=4 index runs through the pipeline on the general XLA
    engine, and the emitted scores match the bit-exact oracle.

    The reference binary accepts any seqLength <= 32 and even slice
    width (isslCreateIndex.cpp:135-145); the fast compact engine here
    bakes in l=20/w=8, so ``engine = auto`` must route other
    operating points to ops/issl_jax.IsslScorer (README "Engine
    operating points")."""
    from crackling_jax.codec import strings_to_sigs
    from crackling_jax.index import build_index, save_native
    from crackling_jax.ops.oracle import score_exact
    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.run import Crackling, select_auto_engine

    site_strs = mini_world["sites"].read_text().split()
    sites = strings_to_sigs(site_strs, 20)
    index4 = build_index(sites, seq_length=20, slice_width=4)
    assert index4.slice_count == 10
    npz = tmp_path / "w4.index.npz"
    save_native(index4, str(npz))
    # auto never offers a fast engine at w=4, even on a GPU
    assert select_auto_engine(index4, "gpu") == "xla"

    outdir = tmp_path / "w4-out"
    outdir.mkdir()
    text = mini_world["config"].read_text().replace(
        str(mini_world["outdir"]), str(outdir)).replace(
        str(mini_world["sites"]), str(npz))
    cfg = tmp_path / "config.ini"
    cfg.write_text(text)
    cm = ConfigManager(str(cfg), lambda m: None)
    assert cm.isConfigured()
    Crackling(cm)

    rows = list(csv.reader(open(outdir / "mini-guides.txt")))
    col = {c: i for i, c in enumerate(rows[0])}
    scored = [r for r in rows[1:] if r[col["mitOfftargetscore"]]
              not in ("?", "", "-1.0")]
    assert scored, "no guides reached w=4 off-target scoring"
    sigs20 = strings_to_sigs([r[col["seq"]][:20] for r in scored], 20)
    mit_o, cfd_o = score_exact(index4, sigs20, 4, 75.0, "and")
    for r, mo, co in zip(scored, mit_o, cfd_o):
        assert abs(float(r[col["mitOfftargetscore"]]) - float(f"{mo:.6f}")) < 1e-9
        assert abs(float(r[col["cfdOfftargetscore"]]) - float(f"{co:.6f}")) < 1e-9
