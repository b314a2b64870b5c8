"""Quantify how far RECONSTRUCTED Turner-table entries can move the
mm10db secondary-structure verdict.

The default energy model marks its dangle / first-mismatch / tetraloop
magnitudes RECONSTRUCTED (ops/rna_params.py module docstring): right
sign, ordering and scale, but not digit-exact vs ViennaRNA's
rna_turner2004.par, which this image does not carry. The reference gate
thresholds MFE at -30 / -18 kcal/mol (Crackling.py:481-497), so the open
fidelity question is: *how often can entry-level reconstruction error
flip a verdict?*

Method: fold a corpus of guide constructs with the default model, then
with K perturbed models where every reconstructed SOURCE entry (the
_DANGLE5/_DANGLE3 dangles, the _MM_BONUS first-mismatch bonuses, the
TETRALOOP_BONUS totals) gets an independent uniform(-delta, +delta)
offset — derived tables (terminal mismatches, int11/21/22 defaults)
rebuild from the perturbed sources, so the error propagates exactly the
way a reconstruction error would. Per draw we record the MFE shift
distribution and the verdict flip rate through the full
SecondaryStructureGate (structure regex + thresholds included), and
decompose the verdict pathway: the reference routes
a construct through the -30 threshold when the canonical-scaffold
structure regex matches and through the -18 threshold otherwise
(Crackling.py:481-497), so a perturbation can flip a verdict two ways —
by moving the energy across its threshold, or by changing the PREDICTED
STRUCTURE enough to change which regex path applies. Both rates are
recorded separately (``..._via_energy`` / ``..._via_regex``), along with
the raw structure-string change rate and the canonical-match flip rate.

Output: one JSON line; appended to scripts/rna_sensitivity_results.jsonl.
PARITY.md Tier 3 carries the headline numbers.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg):
    print(f"[rna-sens] {msg}", file=sys.stderr, flush=True)


def make_targets(n, seed=20260819):
    """Random 23-mer targets ending GG (candidate-guide shape)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    t = rng.integers(0, 4, size=(n, 23))
    rows = ["".join(bases[r[:21]]) + "GG" for r in t]
    return rows


def perturb_sources(rp, rng, delta):
    """Offset every reconstructed source entry by U(-delta, +delta)."""
    rp._DANGLE5 = {
        k: [float(x + rng.uniform(-delta, delta)) for x in v]
        for k, v in rp._DANGLE5.items()}
    rp._DANGLE3 = {
        k: [float(x + rng.uniform(-delta, delta)) for x in v]
        for k, v in rp._DANGLE3.items()}
    rp._MM_BONUS = {
        k: float(v + rng.uniform(-delta, delta))
        for k, v in rp._MM_BONUS.items()}
    rp.TETRALOOP_BONUS = {
        k: float(v + rng.uniform(-delta, delta))
        for k, v in rp.TETRALOOP_BONUS.items()}
    rp.tables.cache_clear()
    rp.param_blob.cache_clear()


def run_study(targets, deltas, draws, backend="native", seed=7):
    import re

    import crackling_jax.ops.rna_params as rp
    from crackling_jax.constants import PATTERN_RNA_STRUCTURE
    from crackling_jax.pipeline.secondary_structure import \
        SecondaryStructureGate

    pat = re.compile(PATTERN_RNA_STRUCTURE)
    saved = {k: copy.deepcopy(getattr(rp, k))
             for k in ("_DANGLE5", "_DANGLE3", "_MM_BONUS",
                       "TETRALOOP_BONUS")}

    def restore():
        for k, v in saved.items():
            setattr(rp, k, copy.deepcopy(v))
        rp.tables.cache_clear()
        rp.param_blob.cache_clear()

    def fold_all():
        gate = SecondaryStructureGate(backend=backend)
        out = gate.assess(targets)
        e = np.array([float(x) if x else np.nan for x in out["ssEnergy"]])
        s = out["ssStructure"].copy()
        # which regex path the verdict took: canonical-scaffold match
        # (-30 threshold) vs fallback (-18), Crackling.py:481-497
        canon = np.array([
            bool(pat.search(f"{st} ({et})")) if st else False
            for st, et in zip(s, out["ssEnergy"])])
        return out["verdict"].copy(), e, s, canon

    try:
        restore()
        v0, e0, s0, c0 = fold_all()
        log(f"baseline: {np.nanmin(e0):.1f}..{np.nanmax(e0):.1f} kcal, "
            f"{(v0 == '1').mean():.3f} accepted, "
            f"{c0.mean():.3f} canonical-structure")
        rng = np.random.default_rng(seed)
        results = []
        for delta in deltas:
            flips, de_p95s, de_maxs = [], [], []
            s_changes, c_flips, f_regex, f_energy = [], [], [], []
            for d in range(draws):
                restore()
                perturb_sources(rp, rng, delta)
                v, e, s, c = fold_all()
                de = np.abs(e - e0)
                flipped = v != v0
                flips.append(float(flipped.mean()))
                de_p95s.append(float(np.nanpercentile(de, 95)))
                de_maxs.append(float(np.nanmax(de)))
                s_changes.append(float((s != s0).mean()))
                c_flips.append(float((c != c0).mean()))
                f_regex.append(float((flipped & (c != c0)).mean()))
                f_energy.append(float((flipped & (c == c0)).mean()))
            # constructs whose baseline energy sits within the observed
            # max shift of a threshold — the at-risk band
            shift = max(de_maxs)
            at_risk = float(np.mean(
                (np.abs(e0 - (-30.0)) < shift)
                | (np.abs(e0 - (-18.0)) < shift)))
            rec = {
                "delta_kcal_per_entry": delta,
                "draws": draws,
                "n_constructs": len(targets),
                "mfe_shift_p95_kcal": round(float(np.mean(de_p95s)), 3),
                "mfe_shift_max_kcal": round(shift, 3),
                "verdict_flip_rate_mean": round(float(np.mean(flips)), 4),
                "verdict_flip_rate_max": round(float(np.max(flips)), 4),
                "structure_change_rate_mean": round(
                    float(np.mean(s_changes)), 4),
                "canonical_regex_flip_rate_mean": round(
                    float(np.mean(c_flips)), 4),
                "canonical_regex_flip_rate_max": round(
                    float(np.max(c_flips)), 4),
                "verdict_flips_via_regex_mean": round(
                    float(np.mean(f_regex)), 4),
                "verdict_flips_via_energy_mean": round(
                    float(np.mean(f_energy)), 4),
                "at_risk_fraction": round(at_risk, 4),
            }
            log(json.dumps(rec))
            results.append(rec)
        return results
    finally:
        restore()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--draws", type=int, default=10)
    ap.add_argument("--deltas", type=float, nargs="+",
                    default=[0.25, 0.5])
    ap.add_argument("--backend", default="native",
                    choices=("native", "jax", "vienna"))
    args = ap.parse_args()

    targets = make_targets(args.n)
    results = run_study(targets, args.deltas, args.draws,
                        backend=args.backend)
    out = {"results": results}
    with open(ROOT / "scripts" / "rna_sensitivity_results.jsonl", "a") as fp:
        fp.write(json.dumps(out) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
