"""soc_tpu: Monte-Carlo continuum radiative transfer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of mjuvela/SOC
(Monte-Carlo dust radiative transfer + equilibrium/stochastic dust emission +
map rendering): vectorized masked-lane packet transport, counter-based RNG,
sharded multi-device execution via jax.sharding.
"""

__version__ = "0.1.0"
