"""Where the hand-written kernels compile: the one capability check.

The compact engine's phase-1 finder is a Pallas kernel lowered through
Triton, which compiles for CUDA GPUs only. Every decision that depends on
the device — which engine ``engine = auto`` builds, whether a kernel runs
compiled — asks this module; nothing else compares platform strings.
Interpret mode (the Pallas interpreter on the CPU) is reached only by an
explicit ``interpret=True``.
"""

from __future__ import annotations

# platforms (jax ``Device.platform``) the Pallas-Triton kernels compile for
KERNEL_PLATFORMS = ("gpu",)


def default_platform() -> str:
    import jax

    return jax.devices()[0].platform


def kernels_compile(platform: str | None = None) -> bool:
    """True when the hand-written kernels compile for ``platform``
    (default: the platform of the first JAX device)."""
    return (platform or default_platform()) in KERNEL_PLATFORMS


def resolve_interpret(interpret: bool | None,
                      platform: str | None = None) -> bool:
    """``interpret`` as a kernel-building engine should use it: True only
    when asked for explicitly. On a platform the kernels cannot compile
    for, an engine that was not asked to interpret refuses to build."""
    if interpret:
        return True
    platform = platform or default_platform()
    if platform not in KERNEL_PLATFORMS:
        raise ValueError(
            f"the Pallas-Triton kernels compile for {KERNEL_PLATFORMS}, not "
            f"{platform!r}; pass interpret=True to run them in the Pallas "
            "interpreter")
    return False
