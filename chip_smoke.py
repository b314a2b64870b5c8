"""Smoke run of the served path on CUDA GPUs, through the user entry points.

    python chip_smoke.py               one GPU: every phase below
    python chip_smoke.py --four-cards  four GPUs: the site-range-sharded
                                       index against one card and the
                                       exact scanner, nothing else

Phases, in one process; the first that fails ends the run with a non-zero
exit:

1. device — ``nvidia-smi`` name and power limit, the tests marked ``gpu``
   (run in a child before this process opens the card), and JAX's first
   device, which must be a GPU;
2. data — the bench point from its seed (bench.py): a 27 Mbp genome,
   ~5.06M distinct sites in an l=20 / w=8 index, 65,536 candidate guides;
3. served — ``engine = auto`` built by the pipeline's own selection scores
   every query (method and, threshold 75, maxDist 4); verdicts and
   accepted scores are checked against the exact scanner
   (native/exact.cpp) on 4,096 of them;
4. finder — the Pallas-Triton finder kernel against the plain XLA finder
   at the bench shape: identical moments, device times, and the page
   time of the compact engine with each;
5. exact — ``engine = exact`` for all five methods, ``%f``-identical to
   the exact scanner; the exact path's two variants timed;
6. pipeline — ``Crackling -c config.ini`` on a 120 Kbp exon set cut from
   the genome, against the pre-built index: the 26-column CSV, with every
   off-target verdict equal to the exact scanner's;
7. mfe — the JAX fold DP (ops/mfe.py) on one page of guide constructs,
   equal to native/fold.cpp.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
METHODS = ("mit", "cfd", "and", "or", "avg")
METHOD = "and"
THRESHOLD = 75.0
MAX_DIST = 4
SCORE_TOL = 0.02
EXON_BP = 120_000

CONFIG = """
[general]
name = smoke
optimisation = high

[consensus]
n = 2
mm10db = True
sgrnascorer2 = True
chopchop = True

[input]
exon-sequences = {exons}
offtarget-sites = {index}
gff-annotation =
bowtie2-index = {genome}
batch-size = 5000000

[output]
dir = {outdir}
filename = guides.txt
delimiter = ,

[offtargetscore]
enabled = True
binary = unused
method = {method}
threads = 4
page-length = 5000000
score-threshold = {threshold}
max-distance = {max_dist}

[sgrnascorer2]
model = shipped
score-threshold = 0

[bowtie2]
binary = unused
threads = 4
page-length = 5000000

[rnafold]
binary = unused
threads = 4
page-length = 5000000
low_energy_threshold = -30
high_energy_threshold = -18

[accelerator]
engine = {engine}
rnafold-backend = native
"""


def say(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# -- phases -----------------------------------------------------------------

def phase_gpu_tests() -> int:
    """The tests marked ``gpu``, in a child process that has the card to
    itself (this process has not opened it yet). Returns the pass count;
    a skip means the child found no GPU, which fails the phase."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    say(f"gpu tests: {tail}")
    passed = re.search(r"(\d+) passed", tail)
    check(r.returncode == 0 and passed is not None and "skipped" not in tail,
          "gpu tests failed:\n" + r.stdout[-4000:] + r.stderr[-2000:])
    return int(passed.group(1))


def phase_device(expect: int = 1) -> dict:
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX's first device is {devs[0].platform!r}, not a GPU")
    check(len(devs) >= expect, f"need {expect} GPUs, JAX sees {len(devs)}")
    dev = dict(platform=devs[0].platform, kind=devs[0].device_kind,
               count=len(devs))
    say(f"device: {dev['kind']} x{dev['count']} ({dev['platform']})")
    return dev


def phase_data(genome_bp: int, n_queries: int, cache: Path | None):
    import bench

    t0 = time.perf_counter()
    genome, index, queries, index_npz = bench.bench_point(
        genome_bp=genome_bp, n_queries=n_queries, cache=cache)
    say(f"data: {len(genome):,} bp genome, {index.num_sites:,} distinct "
        f"sites (avg bucket depth "
        f"{index.num_sites / index.bucket_count:,.0f}), "
        f"{len(queries):,} queries in {time.perf_counter() - t0:.1f}s")
    return genome, index, queries, index_npz


def write_inputs(workdir: Path, genome: bytes, index_path: Path,
                 exon_bp: int = EXON_BP, n_exons: int = 40) -> dict:
    """Genome and exon FASTA files plus a config writer for the
    pipeline's entry points."""
    workdir.mkdir(parents=True, exist_ok=True)
    fa = workdir / "genome.fa"
    with open(fa, "wb") as fp:
        fp.write(b">chr1 synthetic\n")
        for i in range(0, len(genome), 70):
            fp.write(genome[i:i + 70] + b"\n")
    # exons spread over the genome, as an annotation's exon set would be
    size = exon_bp // n_exons
    step = len(genome) // n_exons
    exons = workdir / "exons.fa"
    with open(exons, "wb") as fp:
        for k in range(n_exons):
            fp.write(f">exon{k}\n".encode())
            fp.write(genome[k * step:k * step + size] + b"\n")
    runs = iter(range(1 << 30))

    def config(engine: str, method: str = METHOD) -> Path:
        k = next(runs)
        outdir = workdir / f"out{k}"
        outdir.mkdir()
        path = workdir / f"config{k}.ini"
        path.write_text(CONFIG.format(
            exons=exons, index=index_path, genome=fa, outdir=outdir,
            method=method, threshold=THRESHOLD, max_dist=MAX_DIST,
            engine=engine))
        return path

    return dict(genome=fa, exons=exons, config=config)


def served_scorer(config_path: Path):
    """The off-target scorer the pipeline builds for a config."""
    from crackling_jax.pipeline.config import ConfigManager
    from crackling_jax.pipeline.run import Pipeline

    cm = ConfigManager(str(config_path), say)
    check(cm.isConfigured(), f"config {config_path} rejected")
    return Pipeline(cm)._get_issl_scorer()


def same_f(got, ref, method) -> bool:
    """%f-identical on every channel the method calculates
    (isslScoreOfftargets.cpp:123-143)."""
    chans = [k for k, on in enumerate((method != "cfd", method != "mit"))
             if on]
    return all(["%f" % x for x in got[k]] == ["%f" % x for x in ref[k]]
               for k in chans)


def _exact(index, sigs, method=METHOD, threshold=THRESHOLD):
    from crackling_jax import native

    out = native.exact_score_native(index, sigs, MAX_DIST, threshold,
                                    method)
    check(out is not None, "native exact scanner unavailable")
    return out


def phase_served(scorer, index, queries, n_check: int = 4096) -> dict:
    """Score every query through the served scorer; check verdicts and
    accepted scores against the exact scanner on ``n_check`` of them."""
    from crackling_jax.ops.issl_jax import verdicts

    t0 = time.perf_counter()
    mit, cfd = scorer.score(queries)
    first = time.perf_counter() - t0
    rescored = scorer.last_rescored
    t0 = time.perf_counter()
    scorer.score(queries)              # compiles the cap-tuned program
    second = time.perf_counter() - t0
    steady = _median_time(lambda: scorer.score(queries), 3)
    say(f"served: {len(queries):,} queries, first call {first:.2f}s "
        f"(compile + cap tuning), second {second:.2f}s (compile at tuned "
        f"caps), then {steady:.4f}s (median of 3); hybrid re-scored "
        f"{rescored} of {len(queries):,}")
    sub = queries[:n_check]
    ref_m, ref_c = _exact(index, sub)
    ours = verdicts(mit[:n_check], cfd[:n_check], THRESHOLD, METHOD)
    ref = verdicts(ref_m, ref_c, THRESHOLD, METHOD)
    agreement = float(np.mean(ours == ref))
    dev = max(float(np.max(np.abs(mit[:n_check] - ref_m)[ref], initial=0)),
              float(np.max(np.abs(cfd[:n_check] - ref_c)[ref], initial=0)))
    # the fast engine alone against the full-scan exact scores: the
    # deviation the hybrid's score_band has to cover
    raw_m, raw_c = scorer.fast.score(queries)
    full_m, full_c = _exact(index, sub, threshold=None)
    d_mit = float(np.max(np.abs(raw_m[:n_check] - full_m)))
    d_cfd = float(np.max(np.abs(raw_c[:n_check] - full_c)))
    say(f"served vs exact scanner on {n_check:,}: verdict agreement "
        f"{agreement}, accepted {int(ref.sum()):,} with max |d| {dev:.3g}; "
        f"raw fast engine max |dMIT| {d_mit:.3g} |dCFD| {d_cfd:.3g} "
        f"(score_band {scorer.band})")
    check(agreement == 1.0, f"verdict agreement {agreement} != 1.0")
    check(dev <= SCORE_TOL, f"accepted scores differ by {dev} > {SCORE_TOL}")
    # the queries the hybrid sends down the exact path; where there are
    # too few to time, the 1,024 nearest the threshold stand in for them
    near = scorer._near_threshold(raw_m, raw_c)
    if near.sum() < 64:
        margin = np.minimum(np.abs(raw_m - THRESHOLD),
                            np.abs(raw_c - THRESHOLD))
        near = np.argsort(margin, kind="stable")[:1024]
        say(f"re-score set has {rescored} queries; timing the exact path "
            f"on the {len(near)} nearest the threshold instead")
    return dict(mit=mit, cfd=cfd, rescore=queries[near])


def print_memory(fast, queries) -> None:
    """``memory_analysis()`` of the compact engine's page program and the
    device's peak bytes in use."""
    import jax
    import jax.numpy as jnp

    from crackling_jax.codec import sig_split
    from crackling_jax.ops.issl_compact import plan_query_occupancy

    page = queries[:fast.query_page]
    qb, _ = plan_query_occupancy(page, fast.S, fast.B, 8, fast.qb_cap)
    lo, hi = sig_split(page)
    compiled = fast._get_run(qb).lower(
        jnp.asarray(lo.view(np.uint32)), jnp.asarray(hi.view(np.uint32)),
        fast.bucket_offsets, fast.bucket_lens, fast.entries).compile()
    say(f"page program memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def _median_time(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_finder(fast, queries, reps: int = 7,
                 interpret: bool = False) -> dict:
    """Finder kernel against the plain XLA finder on the bench page:
    identical moments, and the median device time of each."""
    import jax
    import jax.numpy as jnp

    from crackling_jax.codec import sig_split
    from crackling_jax.ops.issl_compact import (FINDERS, find_moments,
                                                plan_on_device,
                                                plan_query_occupancy)

    page = queries[:fast.query_page]
    qb, _ = plan_query_occupancy(page, fast.S, fast.B, 8, fast.qb_cap)
    lo, hi = sig_split(page)
    q_lo = jnp.asarray(lo.view(np.uint32))
    q_hi = jnp.asarray(hi.view(np.uint32)) & jnp.uint32(0xFF)
    qsp = jax.jit(partial(plan_on_device, S=fast.S, B=fast.B, qb=qb))(
        q_lo, q_hi)
    args = (q_lo, q_hi, qsp, fast.bucket_offsets, fast.bucket_lens,
            fast.entries)
    moments, times = {}, {}
    for finder in FINDERS:
        fn = jax.jit(partial(
            find_moments, nchmax=fast._nchmax, chunk=fast.chunk,
            max_dist=fast.max_dist, rows_per_slice=fast._rows_per_slice,
            superchunk=fast.superchunk, finder=finder,
            interpret=interpret and finder == "kernel"))
        moments[finder] = jax.device_get(fn(*args))
        times[finder] = _median_time(lambda: fn(*args), reps)
    same = all(np.array_equal(a, b)
               for a, b in zip(moments["kernel"], moments["xla"]))
    say(f"finder at qb={qb}, nchmax={fast._nchmax}: kernel "
        f"{times['kernel'] * 1e3:.3f} ms, plain XLA "
        f"{times['xla'] * 1e3:.3f} ms (median of {reps}); moments "
        f"identical: {same}")
    check(same, "finder kernel and plain finder disagree")
    return times


def phase_page_times(index, queries, reps: int = 5, interpret: bool = False,
                     **engine_kw) -> dict:
    """End to end: the compact engine's page time with each finder."""
    from crackling_jax.ops.issl_compact import FINDERS, CompactIsslScorer

    times = {}
    for finder in FINDERS:
        sc = CompactIsslScorer(index, max_dist=MAX_DIST, finder=finder,
                               interpret=interpret and finder == "kernel",
                               **engine_kw)
        sc.score(queries)                  # compile + cap tuning
        times[finder] = _median_time(lambda: sc.score(queries), reps)
        del sc
    say(f"compact engine, {len(queries):,} queries: kernel finder "
        f"{times['kernel']:.4f}s, plain XLA finder {times['xla']:.4f}s "
        f"(median of {reps})")
    return times


def phase_exact(config, index, queries, rescore) -> None:
    """``engine = exact`` for every method, %f-identical to the exact
    scanner; then both exact-path variants timed on the re-score set and
    on ``avg``."""
    from crackling_jax.ops.hybrid import ExactIsslScorer

    for method in METHODS:
        scorer = served_scorer(config("exact", method))
        check(isinstance(scorer, ExactIsslScorer),
              f"engine = exact built {type(scorer).__name__}")
        t0 = time.perf_counter()
        got = scorer.score(queries)
        dt = time.perf_counter() - t0
        same = same_f(got, _exact(index, queries, method), method)
        say(f"exact {method}: {len(queries):,} queries in {dt:.3f}s "
            f"({scorer.path}); %f-identical: {same}")
        check(same, f"engine = exact differs from the scanner ({method})")
    for label, method, sigs in (("re-score set", METHOD, rescore),
                                ("avg", "avg", queries)):
        line = []
        for path in ("native", "xla"):
            sc = ExactIsslScorer(index, MAX_DIST, method, THRESHOLD,
                                 path=path)
            got = sc.score(sigs)                      # compile (xla)
            t0 = time.perf_counter()
            sc.score(sigs)
            dt = time.perf_counter() - t0
            same = same_f(got, _exact(index, sigs, method), method)
            line.append(f"{path} {dt:.3f}s (%f-identical: {same})")
        say(f"exact path on the {label} ({len(sigs):,} queries, {method}): "
            + ", ".join(line))


def phase_pipeline(config, index) -> list[str]:
    """``Crackling -c config.ini`` on the exon set; returns the guides'
    23-mers."""
    from crackling_jax.codec import strings_to_sigs
    from crackling_jax.constants import GUIDE_COLUMNS
    from crackling_jax.ops.issl_jax import verdicts
    from crackling_jax.utils.cli import main_crackling

    cfg = config("auto")
    t0 = time.perf_counter()
    main_crackling(["-c", str(cfg)])
    dt = time.perf_counter() - t0
    out = next((cfg.parent / f"out{cfg.stem[len('config'):]}").glob(
        "*-guides.txt"))
    rows = list(csv.reader(open(out)))
    check(rows and rows[0] == GUIDE_COLUMNS, "CSV header is not the "
          "26-column guide header")
    check(all(len(r) == len(GUIDE_COLUMNS) for r in rows),
          "a CSV row does not have 26 columns")
    col = {c: i for i, c in enumerate(GUIDE_COLUMNS)}
    scored = [r for r in rows[1:]
              if r[col["passedOffTargetScore"]] in ("0", "1")]
    check(len(scored) > 0, "no guide reached off-target scoring")
    sigs = strings_to_sigs([r[col["seq"]][:20] for r in scored], 20)
    ref = verdicts(*_exact(index, sigs), THRESHOLD, METHOD)
    ours = np.array([r[col["passedOffTargetScore"]] == "1" for r in scored])
    agreement = float(np.mean(ours == ref))
    say(f"pipeline: {len(rows) - 1:,} guides in {dt:.1f}s, "
        f"{len(scored):,} off-target scored, verdict agreement with the "
        f"exact scanner {agreement}")
    check(agreement == 1.0, "pipeline verdicts differ from the scanner")
    return [r[col["seq"]] for r in rows[1:]]


def phase_mfe(guides23: list[str], page: int = 1024) -> None:
    """The JAX fold DP on the default device against native/fold.cpp."""
    from crackling_jax import native
    from crackling_jax.constants import SCAFFOLD_RNA
    from crackling_jax.ops.mfe import encode_rna, fold_sequences

    seqs = [f"G{t[1:20]}{SCAFFOLD_RNA}" for t in guides23[:page]]
    t0 = time.perf_counter()
    s_jax, e_jax = fold_sequences(seqs)
    dt = time.perf_counter() - t0
    out = native.fold_batch_native(np.stack([encode_rna(s) for s in seqs]))
    check(out is not None, "native fold library unavailable")
    s_nat, e_nat = out
    same_s = sum(a == b for a, b in zip(s_jax, s_nat))
    same_e = sum(f"{a:6.2f}" == f"{b:6.2f}" for a, b in zip(e_jax, e_nat))
    say(f"mfe: {len(seqs):,} constructs in {dt:.2f}s; structures equal "
        f"{same_s}/{len(seqs)}, energies equal {same_e}/{len(seqs)}")
    check(same_s == len(seqs) and same_e == len(seqs),
          "JAX fold differs from native/fold.cpp")


def phase_sharded(index, queries, n_check: int = 4096, n_shards: int = 4,
                  interpret: bool = False, **engine_kw) -> None:
    """The site-range-sharded compact engine over ``n_shards`` devices
    against the single-device compact engine and the exact scanner."""
    from crackling_jax.ops.hybrid import HybridIsslScorer
    from crackling_jax.ops.issl_compact import CompactIsslScorer
    from crackling_jax.ops.issl_jax import verdicts
    from crackling_jax.parallel.sharded import (ShardedCompactIsslScorer,
                                                make_mesh)

    mesh = make_mesh(n_shards=n_shards, n_q=1)
    kw = dict(max_dist=MAX_DIST, method=METHOD, threshold=THRESHOLD)
    sharded = HybridIsslScorer(index, fast=ShardedCompactIsslScorer(
        index, mesh, max_dist=MAX_DIST, interpret=interpret, **engine_kw),
        **kw)
    single = HybridIsslScorer(index, fast=CompactIsslScorer(
        index, max_dist=MAX_DIST, interpret=interpret, **engine_kw), **kw)
    t0 = time.perf_counter()
    m4, c4 = sharded.score(queries)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded.score(queries)
    second = time.perf_counter() - t0
    m1, c1 = single.score(queries)
    say(f"sharded over {n_shards} devices: {len(queries):,} queries, first "
        f"call {first:.2f}s, second {second:.3f}s; re-scored "
        f"{sharded.last_rescored}")
    v4 = verdicts(m4, c4, THRESHOLD, METHOD)
    v1 = verdicts(m1, c1, THRESHOLD, METHOD)
    acc = v1 & v4
    d_single = max(float(np.max(np.abs(m4 - m1)[acc], initial=0)),
                   float(np.max(np.abs(c4 - c1)[acc], initial=0)))
    ref_m, ref_c = _exact(index, queries[:n_check])
    ref = verdicts(ref_m, ref_c, THRESHOLD, METHOD)
    d_ref = max(float(np.max(np.abs(m4[:n_check] - ref_m)[ref], initial=0)),
                float(np.max(np.abs(c4[:n_check] - ref_c)[ref], initial=0)))
    a_single = float(np.mean(v4 == v1))
    a_ref = float(np.mean(v4[:n_check] == ref))
    say(f"sharded vs single device: verdict agreement {a_single}, "
        f"accepted max |d| {d_single:.3g}; vs exact scanner on "
        f"{n_check:,}: agreement {a_ref}, accepted max |d| {d_ref:.3g}")
    check(a_single == 1.0 and a_ref == 1.0, "sharded verdicts disagree")
    check(d_single <= SCORE_TOL and d_ref <= SCORE_TOL,
          "sharded accepted scores differ by more than the tolerance")


# -- driver -----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded index over four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import bench  # noqa: F401  (fails outside a checkout)
    from crackling_jax.utils.jaxcache import enable_persistent_cache

    for line in card_lines():
        say(line)
    if not args.four_cards:
        phase_gpu_tests()
    enable_persistent_cache()
    dev = phase_device(expect=4 if args.four_cards else 1)
    (ROOT / "bench_data").mkdir(exist_ok=True)
    genome, index, queries, index_npz = phase_data(
        27_000_000, 65_536, ROOT / "bench_data")
    if args.four_cards:
        phase_sharded(index, queries)
    else:
        work = Path(tempfile.mkdtemp(prefix="chip-smoke-",
                                     dir=ROOT / "bench_data"))
        inputs = write_inputs(work, genome, index_npz)
        scorer = served_scorer(inputs["config"]("auto"))
        check(type(scorer).__name__ == "HybridIsslScorer"
              and type(scorer.fast).__name__ == "CompactIsslScorer",
              "engine = auto did not build the hybrid compact engine")
        served = phase_served(scorer, index, queries)
        print_memory(scorer.fast, queries)
        phase_finder(scorer.fast, queries)
        del scorer
        phase_page_times(index, queries)
        phase_exact(inputs["config"], index, queries[:1024],
                    served["rescore"])
        guides = phase_pipeline(inputs["config"], index)
        phase_mfe(guides)
    say(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
