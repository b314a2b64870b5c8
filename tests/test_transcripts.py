"""Transcript-hit counter tests (pipeline/transcripts.py).

Fixture parity with the reference's built-in sample
(countHitTranscripts.py:246-305): guides at Chr1:60/200/320/460 must
count 2/4, 2/4, 4/4, 0/0 transcripts. Also covers the pickle-cache
reuse path (countHitTranscripts.py:62-71) and the CLI output file.
"""

import csv
import os
import pickle

from crackling_jax.pipeline import transcripts as tr


def test_sample_fixture_counts():
    gff, crk = tr.use_sample_data()
    try:
        rows = tr.process(gff, crk)
        header = rows[0]
        assert header[-1] == "hits"
        seq_i = header.index("seq")
        got = {r[seq_i]: r[-1] for r in rows[1:]}
        assert got == tr.SAMPLE_EXPECTED  # {AAAA:2/4, AAAT:2/4, AATA:4/4, ATAA:0/0}
    finally:
        for p in (gff, crk, gff + ".p"):
            if os.path.exists(p):
                os.remove(p)


def test_pickle_cache_reuse_and_invalidate(tmp_path):
    gff = tmp_path / "ann.gff"
    gff.write_text(tr.SAMPLE_ANNOTATION)
    maps1 = tr.load_annotation(str(gff))
    cache = str(gff) + ".p"
    assert os.path.exists(cache)

    # poison the cache: a reuse must come from the pickle, not a re-parse
    poisoned = list(maps1)
    poisoned[1] = {"sentinel-gene": {}}
    with open(cache, "wb") as fp:
        pickle.dump(poisoned, fp)
    os.utime(cache, None)  # cache mtime >= gff mtime -> reused
    maps2 = tr.load_annotation(str(gff))
    assert "sentinel-gene" in maps2[1]

    # touching the GFF after the cache invalidates it (re-parse)
    later = os.path.getmtime(cache) + 10
    os.utime(str(gff), (later, later))
    maps3 = tr.load_annotation(str(gff))
    assert "sentinel-gene" not in maps3[1]
    assert maps3[1].keys() == maps1[1].keys()

    # force_reload always re-parses
    with open(cache, "wb") as fp:
        pickle.dump(poisoned, fp)
    os.utime(cache, None)
    maps4 = tr.load_annotation(str(gff), force_reload=True)
    assert "sentinel-gene" not in maps4[1]


def test_unpositioned_guides_get_question_marks(tmp_path):
    gff = tmp_path / "ann.gff"
    gff.write_text(tr.SAMPLE_ANNOTATION)
    crk = tmp_path / "res.csv"
    crk.write_text(
        "seq,bowtieChr,bowtieStart,bowtieEnd\n"
        "AAAA,?,?,?\n"
        "CCCC,Chr1,320,343\n")
    rows = tr.process(str(gff), str(crk))
    got = {r[0]: r[-1] for r in rows[1:]}
    assert got == {"AAAA": "?/?", "CCCC": "4/4"}


def test_cli_writes_output_csv(tmp_path):
    gff, crk = tr.use_sample_data()
    out = tmp_path / "out.csv"
    try:
        tr.main(["-a", gff, "-c", crk, "-o", str(out)])
        with open(out) as fp:
            rows = list(csv.reader(fp))
        assert rows[0][-1] == "hits"
        got = {r[rows[0].index("seq")]: r[-1] for r in rows[1:]}
        assert got == tr.SAMPLE_EXPECTED
    finally:
        for p in (gff, crk, gff + ".p"):
            if os.path.exists(p):
                os.remove(p)
