"""Driver entry-point contract: ``entry()`` compiles, ``dryrun_multichip``
executes one sharded step on the 8-virtual-device CPU mesh.

These run out-of-process with ``--xla_force_host_platform_device_count=N``
as well; this test keeps them green in CI.
"""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    compiled = jax.jit(fn).lower(*args).compile()
    out = compiled(*args)
    leaves = jax.tree_util.tree_leaves(out)
    # (mit_sums, cfd_sums): one finite per-query vector each
    assert len(leaves) == 2
    assert all(x.ndim == 1 and x.shape[0] > 0 for x in leaves)


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)
