"""Gate on the reconstructed-RNA-table sensitivity.

The default Turner-2004 tables carry RECONSTRUCTED entries
(ops/rna_params.py provenance notes); the measured exposure is that
per-entry errors of +-0.25 kcal flip ~1-2% of mm10db secondary-structure
verdicts (scripts/rna_sensitivity_results.jsonl). This test re-runs a
small draw of that study through the FULL gate — energy thresholds AND
the canonical-structure regex pathway (Crackling.py:481-497) — and
fails if a regression ever widens the exposure past 3x the measured
worst case.
"""

import pytest


def test_reconstruction_sensitivity_bounded():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from rna_sensitivity import make_targets, run_study

    from crackling_jax.pipeline.secondary_structure import _native_available

    backend = "native" if _native_available() else "jax"
    targets = make_targets(48)
    results = run_study(targets, deltas=[0.25], draws=3, backend=backend)
    rec = results[0]
    # measured round-3/4 exposure at +-0.25 kcal/entry: mean ~1.1%,
    # worst ~2.3% — gate at 3x the worst
    assert rec["verdict_flip_rate_max"] <= 0.07, rec
    # the structure-regex pathway must stay a minor contributor: flips
    # routed through a canonical-match change bounded like the rest
    assert rec["canonical_regex_flip_rate_max"] <= 0.10, rec
    assert (rec["verdict_flips_via_regex_mean"]
            + rec["verdict_flips_via_energy_mean"]
            == pytest.approx(rec["verdict_flip_rate_mean"], abs=1e-6)), rec
