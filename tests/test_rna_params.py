"""ViennaRNA parameter-file loading: parser mapping, engine override
round-trip, and default restoration.

A synthetic ``.par`` file in ViennaRNA's v2.0 layout (deterministic
non-default values, INF tokens, comment blocks, enthalpy sections to be
skipped) is parsed and spot-checked against the raw values; then the
override is installed and the C++ fold, the JAX fold, and the
brute-force enumeration oracle (tests/test_mfe.py) are cross-checked
under the new model — which exercises every dedicated loop path
(int11/int21/int22, 1xn/2x3 mismatch families, special-hairpin totals)
with values that differ from the generic decomposition.
"""

import numpy as np
import pytest

from crackling_jax.ops import rna_params as rp
from crackling_jax.ops.mfe import encode_rna, fold_sequences

from test_mfe import _dotbracket_pairs, _enumerate_structures, _structure_energy

native = pytest.importorskip("crackling_jax.native")


def _vals(n, seed, lo=-300, hi=200):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n)


def _fmt(vals):
    out = []
    for i in range(0, len(vals), 10):
        out.append(" ".join(f"{int(v):6d}" for v in vals[i:i + 10]))
    return "\n".join(out)


def write_synthetic_par(path):
    """A full v2.0-layout parameter file with deterministic values."""
    sections = []
    sections.append("## RNAfold parameter file v2.0\n")
    sections.append("/* synthetic test values, dcal/mol */\n")

    def sec(name, vals):
        sections.append(f"\n# {name}\n{_fmt(vals)}\n")

    sec("stack", _vals(49, 1))
    sec("stack_enthalpies", _vals(49, 100))          # must be ignored
    for i, name in enumerate(["mismatch_hairpin", "mismatch_interior",
                              "mismatch_interior_1n",
                              "mismatch_interior_23",
                              "mismatch_multi", "mismatch_exterior"]):
        sec(name, _vals(7 * 5 * 5, 2 + i))
        sec(name + "_enthalpies", _vals(7 * 5 * 5, 200 + i))
    sec("dangle5", _vals(35, 8, lo=-80, hi=10))
    sec("dangle3", _vals(35, 9, lo=-80, hi=10))
    sec("int11", _vals(7 * 7 * 5 * 5, 10))
    sec("int21", _vals(7 * 7 * 5 * 5 * 5, 11))
    sec("int22", _vals(6 * 6 * 4 * 4 * 4 * 4, 12))
    hp = [10000000, 10000000, 10000000] + list(_vals(28, 13, lo=300, hi=700))
    sections.append("\n# hairpin\nINF INF INF " + _fmt(hp[3:]) + "\n")
    sec("bulge", [10000000] + list(_vals(30, 14, lo=200, hi=600)))
    sec("interior", [10000000] * 4 + list(_vals(27, 15, lo=100, hi=400)))
    sections.append("\n# NINIO\n/* m m_dH max */\n50 320 250\n")
    sections.append("\n# ML_params\n/* cu cu_dH cc cc_dH ci ci_dH */\n"
                    "10 0 880 3000 -80 -220\n")
    sections.append("\n# Misc\n/* DuplexInit DuplexInit_dH TerminalAU "
                    "TerminalAU_dH LXC */\n410 360 40 370 107.856\n")
    sections.append("\n# Tetraloops\nCGAAAG 250 -500\nGGGGAC 150 -1000\n")
    sections.append("\n# Triloops\nCAACG 680 690\n")
    sections.append("\n# Hexaloops\nACAGUACU 280 -1680\n")
    sections.append("\n# END\n")
    path.write_text("".join(sections))


def test_parser_mapping(tmp_path):
    par = tmp_path / "synthetic.par"
    write_synthetic_par(par)
    parsed = rp.parse_vienna_par(str(par))
    t, s = parsed["tables"], parsed["scalars"]

    # stack: direct (7,7), dcal -> kcal
    raw = _vals(49, 1).reshape(7, 7)
    np.testing.assert_allclose(t["stack"], raw / 100.0)
    # mismatch tables: (7,5,5) with the N slots sliced off both base dims
    raw = _vals(7 * 5 * 5, 2).reshape(7, 5, 5)
    np.testing.assert_allclose(t["mismatch_h"], raw[:, 1:, 1:] / 100.0)
    # dangles: (7,5) minus the N column
    raw = _vals(35, 8, lo=-80, hi=10).reshape(7, 5)
    np.testing.assert_allclose(t["dangle5"], raw[:, 1:] / 100.0)
    # int11: (7,7,5,5) minus N slots
    raw = _vals(7 * 7 * 5 * 5, 10).reshape(7, 7, 5, 5)
    np.testing.assert_allclose(t["int11"], raw[:, :, 1:, 1:] / 100.0)
    # int22 in the 6x6x4^4 (no NN, no N) layout, padded to 7x7 with INF
    raw = _vals(6 * 6 * 4 ** 4, 12).reshape(6, 6, 4, 4, 4, 4)
    np.testing.assert_allclose(t["int22"][:6, :6], raw / 100.0)
    assert (t["int22"][6] >= rp.INF / 2).all()
    # init vectors: INF tokens and values
    assert t["hairpin"][0] >= rp.INF / 2
    assert t["internal"][3] >= rp.INF / 2
    # specials are dense TOTAL lookups
    idx = 0
    for ch in "CGAAAG":
        idx = idx * 4 + {"A": 0, "C": 1, "G": 2, "U": 3}[ch]
    assert t["tetra"][idx] == pytest.approx(2.50)
    assert (t["tetra"] >= rp.INF / 2).sum() == 4096 - 2
    # scalars
    assert s["NINIO"] == pytest.approx(0.50)
    assert s["NINIO_MAX"] == pytest.approx(2.50)
    assert s["ML_BASE"] == pytest.approx(0.10)
    assert s["ML_CLOSE"] == pytest.approx(8.80)
    assert s["ML_INTERN"] == pytest.approx(-0.80)
    assert s["TERMINAL_AU"] == pytest.approx(0.40)
    assert s["LXC"] == pytest.approx(1.07856)


def test_override_engines_match_bruteforce(tmp_path):
    """Under a full parameter override the C++ fold, the JAX fold, and the
    enumeration oracle still agree — the dedicated loop paths now carry
    values that differ from the generic decomposition, so a convention
    mismatch in any one implementation would surface here."""
    par = tmp_path / "synthetic.par"
    write_synthetic_par(par)
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("GGCCAU"), 13)) for _ in range(8)]
    codes = np.stack([encode_rna(x) for x in seqs])
    try:
        rp.set_parameter_file(str(par))
        assert rp.active_parameter_file() == str(par)
        assert rp.NINIO == pytest.approx(0.50)
        s_nat, e_nat = native.fold_batch_native(codes)
        s_jax, e_jax = fold_sequences(seqs)
        np.testing.assert_allclose(np.asarray(e_jax), e_nat, atol=1e-6)
        for b, seq in enumerate(seqs):
            cand = _enumerate_structures(tuple(codes[b]))
            best = min(min(_structure_energy(codes[b], p) for p in cand), 0.0)
            assert e_nat[b] == pytest.approx(best, abs=1e-9), seq
            got = _dotbracket_pairs(s_nat[b])
            if got:
                assert _structure_energy(codes[b], got) == pytest.approx(
                    e_nat[b], abs=1e-9)
    finally:
        rp.set_parameter_file(None)
    # defaults restored
    assert rp.active_parameter_file() is None
    assert rp.NINIO == pytest.approx(0.60)
    _, e_default = native.fold_batch_native(codes)
    assert not np.allclose(e_default, e_nat)


def _has_multiloop(struct: str) -> bool:
    """True if any base pair directly encloses >= 2 top-level stems."""
    pairs = dict(_dotbracket_pairs(struct))
    for i, j in pairs.items():
        k, stems = i + 1, 0
        while k < j:
            if struct[k] == "(":
                stems += 1
                k = dict(_dotbracket_pairs(struct))[k] + 1
            else:
                k += 1
        if stems >= 2:
            return True
    return False


def test_multiloop_ml_base_engines_match(tmp_path):
    """Nonzero per-unpaired-base multiloop cost (ML_params cu) exercised on
    multiloop-forming sequences: the JAX DP's left-unpaired fML transition
    must carry ML_BASE (it is a rebased cumulative min, not a plain one),
    and the shape-cached jit must not reuse a trace from the previous
    parameter set (regression: the cache key lacked ML_BASE)."""
    # minimal override: default tables, but a nonzero per-unpaired-base
    # multiloop cost (cu=5 dcal; ML_CLOSE/ML_INTERN kept at the engine
    # defaults so multiloops stay energetically reachable). The
    # engineered sequences fold multiloops with unpaired bases directly
    # after the opening pair — the exact path the buggy transition made
    # free (a leading-dot ML segment enters fML via the i+1 scan).
    par = tmp_path / "ml.par"
    par.write_text(
        "## RNAfold parameter file v2.0\n\n# ML_params\n"
        "/* cu cu_dH cc cc_dH ci ci_dH */\n5 0 340 3000 40 -220\n\n# END\n")
    rng = np.random.default_rng(11)
    seqs = ["GGCAGGGCAAAGCCCGGGCAAAGCCCGCC",
            "GCGCAGGCGAAAGCCGGCGAAAGCCGCGC"]
    seqs += ["".join(rng.choice(list("GCAU"), 29)) for _ in range(6)]
    try:
        # populate the (B, n) jit cache under the DEFAULT model first, so
        # a stale-cache bug would reuse ML_BASE == 0 after the override
        e_before = np.asarray(fold_sequences(seqs)[1])
        rp.set_parameter_file(str(par))
        assert rp.ML_BASE == pytest.approx(0.05)
        codes = np.stack([encode_rna(x) for x in seqs])
        s_nat, e_nat = native.fold_batch_native(codes)
        s_jax, e_jax = fold_sequences(seqs)
        np.testing.assert_allclose(np.asarray(e_jax), e_nat, atol=1e-6)
        assert list(s_jax) == list(s_nat)
        assert any(_has_multiloop(s) for s in s_nat), s_nat
        assert not np.allclose(np.asarray(e_jax), e_before)
    finally:
        rp.set_parameter_file(None)
