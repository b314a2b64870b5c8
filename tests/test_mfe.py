"""MFE engine tests: brute-force oracle, C++/JAX cross-engine agreement,
and the RNAfold agreement harness (gated on the binary's presence).

The brute-force oracle enumerates every valid secondary structure of a
small sequence and scores it with an independent straight-line
implementation of the shared energy model (ops/rna_params.py), so it
checks the DP recurrences of both engines — not just that they agree
with each other.
"""

import shutil

import numpy as np
import pytest

from crackling_jax.ops import rna_params as rp
from crackling_jax.ops.mfe import encode_rna, fold_sequences

native = pytest.importorskip("crackling_jax.native")


def _rand_seqs(n, count, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), n)) for _ in range(count)]


# ---- brute force oracle --------------------------------------------------

def _enumerate_structures(codes):
    """All nested pair sets (hairpin >= 3, canonical pairs only)."""
    n = len(codes)
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def structs(i, j):
        # structures of region [i, j] as frozensets of pairs
        if j - i < 4:
            return [frozenset()]
        out = list(structs(i + 1, j))          # i unpaired
        for k in range(i + 4, j + 1):
            if rp.PAIR_CODE[codes[i], codes[k]] < 0:
                continue
            for inner in structs(i + 1, k - 1):
                for rest in structs(k + 1, j):
                    out.append(inner | rest | {(i, k)})
        return out

    return structs(0, n - 1)


def _structure_energy(codes, pairs):
    """Independent loop-decomposition energy of one structure."""
    t = rp.tables(512)
    n = len(codes)
    s = codes
    pairs = sorted(pairs)
    close_of = {}
    for (i, j) in pairs:
        close_of[i] = j

    def pair_code(i, j):
        p = rp.PAIR_CODE[s[i], s[j]]
        return 6 if p < 0 else int(p)

    def au(p):
        return rp.TERMINAL_AU if rp.PAIR_IS_AU[p] else 0.0

    def stem_weight(tbl, k, l, p):
        e = au(p)
        left, right = k > 0, l < n - 1
        if left and right:
            e += tbl[p, s[k - 1], s[l + 1]]
        elif left:
            e += t["dangle5"][p, s[k - 1]]
        elif right:
            e += t["dangle3"][p, s[l + 1]]
        return e

    def children(i, j):
        out = []
        k = i + 1
        while k < j:
            if k in close_of:
                out.append((k, close_of[k]))
                k = close_of[k] + 1
            else:
                k += 1
        return out

    def loop_energy(i, j):
        p1 = pair_code(i, j)
        ch = children(i, j)
        if not ch:
            # ViennaRNA E_Hairpin: a special tri/tetra/hexaloop entry is
            # the TOTAL loop energy replacing the generic formula
            ls = j - i - 1
            key = {3: "tri", 4: "tetra", 6: "hexa"}.get(ls)
            if key is not None:
                idx = 0
                for m in range(i, j + 1):
                    idx = idx * 4 + int(s[m])
                if t[key][idx] < rp.INF / 2:
                    return t[key][idx]
            e = t["hairpin"][min(ls, 512)]
            if ls == 3:
                e += au(p1)
            else:
                e += t["mismatch_h"][p1, s[i + 1], s[j - 1]]
            return e
        if len(ch) == 1:
            # ViennaRNA E_IntLoop: dedicated small-loop tables + 1xn/2x3
            # mismatch families + generic init/Ninio/mismatch
            (k, l) = ch[0]
            p2 = pair_code(k, l)
            q2 = rp.PAIR_REV[p2]
            inner = loop_energy(k, l)
            a, b = k - i - 1, j - l - 1
            size = a + b
            if size == 0:
                return t["stack"][p1, p2] + inner
            if a == 0 or b == 0:
                e = t["bulge"][min(size, 512)]
                if size == 1:
                    e += t["stack"][p1, p2]
                else:
                    e += au(p1) + au(p2)
                return e + inner
            si1, sj1 = s[i + 1], s[j - 1]
            sp1, sq1 = s[k - 1], s[l + 1]
            if (a, b) == (1, 1):
                return t["int11"][p1, q2, si1, sj1] + inner
            if (a, b) == (1, 2):
                return t["int21"][p1, q2, si1, sq1, sj1] + inner
            if (a, b) == (2, 1):
                return t["int21"][q2, p1, sq1, si1, sp1] + inner
            if (a, b) == (2, 2):
                return t["int22"][p1, q2, si1, sp1, sq1, sj1] + inner
            ninio = min(rp.NINIO_MAX, rp.NINIO * abs(a - b))
            if a == 1 or b == 1:
                return (t["internal"][min(size, 512)] + ninio
                        + t["mismatch_1n"][p1, si1, sj1]
                        + t["mismatch_1n"][q2, sq1, sp1] + inner)
            if size == 5:
                return (t["internal"][5] + ninio
                        + t["mismatch_23"][p1, si1, sj1]
                        + t["mismatch_23"][q2, sq1, sp1] + inner)
            return (t["internal"][min(size, 512)] + ninio
                    + t["mismatch_i"][p1, si1, sj1]
                    + t["mismatch_i"][q2, sq1, sp1] + inner)
        # multiloop
        e = (rp.ML_CLOSE + rp.ML_INTERN + au(p1)
             + t["mismatch_m"][rp.PAIR_REV[p1], s[j - 1], s[i + 1]])
        unpaired = j - i - 1
        for (k, l) in ch:
            e += (stem_weight(t["mismatch_m"], k, l, pair_code(k, l))
                  + rp.ML_INTERN + loop_energy(k, l))
            unpaired -= l - k + 1
        e += rp.ML_BASE * unpaired
        return e

    total = 0.0
    for (k, l) in children(-1, n):   # top-level stems; children scans i+1..j-1
        total += stem_weight(t["mismatch_e"], k, l, pair_code(k, l))
        total += loop_energy(k, l)
    return total


def _dotbracket_pairs(struct):
    stack, pairs = [], set()
    for i, ch in enumerate(struct):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            pairs.add((stack.pop(), i))
    return frozenset(pairs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_fold_matches_bruteforce(seed):
    rng = np.random.default_rng(seed)
    # biased toward pair-rich alphabets so structures actually form
    seqs = ["".join(rng.choice(list("GGCCAU"), 14)) for _ in range(6)]
    codes = np.stack([encode_rna(x) for x in seqs])
    structs, energies = native.fold_batch_native(codes)
    for b, seq in enumerate(seqs):
        cand = _enumerate_structures(tuple(codes[b]))
        best = min(min(_structure_energy(codes[b], p) for p in cand), 0.0)
        assert energies[b] == pytest.approx(best, abs=1e-9), seq
        # and the reported structure has exactly that energy
        got = _dotbracket_pairs(structs[b])
        if got:
            assert _structure_energy(codes[b], got) == pytest.approx(
                energies[b], abs=1e-9)


# ---- cross-engine agreement ----------------------------------------------

@pytest.mark.parametrize("n,count,seed", [(30, 32, 10), (60, 16, 11),
                                          (100, 16, 12)])
def test_jax_fold_matches_native(n, count, seed):
    seqs = _rand_seqs(n, count, seed)
    codes = np.stack([encode_rna(x) for x in seqs])
    s_nat, e_nat = native.fold_batch_native(codes)
    s_jax, e_jax = fold_sequences(seqs)
    np.testing.assert_allclose(np.asarray(e_jax), e_nat, atol=1e-6)
    mismatches = sum(1 for a, b in zip(s_nat, s_jax) if a != b)
    assert mismatches == 0, f"{mismatches}/{count} structures differ"


def test_structures_well_formed():
    seqs = _rand_seqs(80, 32, 20)
    codes = np.stack([encode_rna(x) for x in seqs])
    structs, energies = native.fold_batch_native(codes)
    for st, e in zip(structs, energies):
        bal = 0
        for ch in st:
            assert ch in "()."
            bal += (ch == "(") - (ch == ")")
            assert bal >= 0
        assert bal == 0
        assert e <= 0.0
        if e == 0.0:
            assert "(" not in st


def test_real_constructs_fold():
    """Guide+scaffold constructs (the pipeline's actual inputs) fold to
    plausibly scaffold-dominated energies with hairpin structure."""
    from crackling_jax.constants import SCAFFOLD_RNA

    rng = np.random.default_rng(5)
    spacers = ["".join(rng.choice(list("ACGU"), 19)) for _ in range(16)]
    seqs = [f"G{sp}{SCAFFOLD_RNA}" for sp in spacers]
    codes = np.stack([encode_rna(x) for x in seqs])
    structs, energies = native.fold_batch_native(codes)
    assert (energies < -10.0).all()          # the scaffold always folds
    assert all("(" in st for st in structs)


# ---- RNAfold agreement harness (runs wherever the binary exists) ---------

@pytest.mark.skipif(shutil.which("RNAfold") is None,
                    reason="RNAfold binary not on PATH")
def test_rnafold_verdict_agreement(tmp_path):
    """Folds a few hundred real constructs with RNAfold and the native
    engine and records the mm10db verdict agreement rate (>= 99% gate)."""
    from crackling_jax.constants import SCAFFOLD_RNA
    from crackling_jax.pipeline.secondary_structure import (
        SecondaryStructureGate)

    rng = np.random.default_rng(99)
    targets = []
    while len(targets) < 300:
        t23 = "".join(rng.choice(list("ACGT"), 23))
        if not t23.startswith("T"):
            targets.append(t23)

    g_vienna = SecondaryStructureGate(backend="vienna")
    g_native = SecondaryStructureGate(backend="native")
    rv = g_vienna.assess(targets)["verdict"]
    rn = g_native.assess(targets)["verdict"]
    agree = float(np.mean(rv == rn))
    print(f"RNAfold verdict agreement: {agree:.4f}")
    assert agree >= 0.99
