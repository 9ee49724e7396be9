"""The benchmark's own code: cell lookup, the chip check, the window's
arithmetic, the trace reduction, the yardstick and the output check.

Nothing here imports the program under test at module level, and nothing
imports ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``.
"""
