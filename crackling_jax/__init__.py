"""crackling_jax — an accelerator CRISPR guide-design engine in JAX.

A from-scratch re-design of the capabilities of bmds-lab/Crackling
(Bradford, Chappell & Perrin, The CRISPR Journal 2022) for accelerators:
candidate extraction, consensus efficiency scoring, and ISSL off-target
MIT/CFD scoring as JAX/XLA/Pallas programs over 2-bit-packed sequences.
"""

from .constants import *  # noqa: F401,F403
from .codec import rc, trans_to_dna, at_percentage  # noqa: F401

__version__ = "0.1.0"
