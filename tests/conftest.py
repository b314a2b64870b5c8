"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu`` unless the environment names
another platform) with 8 virtual devices, so sharded/multi-device code
paths execute without a multi-GPU host, Pallas kernels run in interpret
mode (``interpret=True``), and x64 is enabled so the scoring engines can
be validated in f64 against the reference's double-precision arithmetic.
Tests marked ``gpu`` need a CUDA GPU and skip elsewhere; chip_smoke.py
runs them on the card with ``JAX_PLATFORMS=cuda``. These settings must be
in place before jax is imported anywhere.
"""

import os
import subprocess
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
REF_BIN_DIR = REPO / ".cache" / "refbin"


@pytest.fixture(scope="session")
def ref_bins():
    """Compile the reference ISSL binaries once (parity oracle)."""
    if not REFERENCE.exists():
        pytest.skip("reference repository not available")
    REF_BIN_DIR.mkdir(parents=True, exist_ok=True)
    bins = {}
    for name in ("isslCreateIndex", "isslScoreOfftargets"):
        out = REF_BIN_DIR / name
        if not out.exists():
            subprocess.run(
                [
                    "g++", "-O3", "-std=c++11", "-fopenmp", "-mpopcnt",
                    f"-I{REFERENCE}/src/ISSL/include",
                    "-o", str(out),
                    str(REFERENCE / "src" / "ISSL" / f"{name}.cpp"),
                ],
                check=True,
                capture_output=True,
            )
        bins[name] = str(out)
    return bins


@pytest.fixture()
def gpu():
    """Skip unless JAX's first device is a CUDA GPU (decided when the test
    runs, never at import, so every xdist worker collects the same
    tests). Runs the test with x64 off, as the served path does."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run through chip_smoke.py)")
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield jax.devices()[0]
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture()
def rng():
    return np.random.default_rng(20260816)


def random_genome(rng, n, n_frac=0.0, lower_frac=0.0):
    """Random ACGT string with optional N and lowercase contamination."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, size=n)]
    if n_frac:
        mask = rng.random(n) < n_frac
        seq[mask] = ord("N")
    if lower_frac:
        mask = rng.random(n) < lower_frac
        seq[mask] = np.frombuffer(
            bytes([seq[i] for i in np.flatnonzero(mask)]).lower(), dtype=np.uint8
        )
    return seq.tobytes().decode("ascii")


@pytest.fixture()
def make_genome(rng):
    return lambda n, **kw: random_genome(rng, n, **kw)
