"""Test configuration: an 8-device virtual CPU mesh and the example inputs.

The jax config is set here, before any backend is instantiated: the tests
run on the CPU with 8 virtual devices unless JAX_PLATFORMS names the
platforms (``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs
the tests marked ``gpu`` on the card).
"""

import os

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from soc_tpu.io.example import write_example
from soc_tpu.utils.cache import enable_compile_cache

enable_compile_cache()


@pytest.fixture(scope="session")
def socex(tmp_path_factory):
    """Directory holding the generated example: my.ini, tmp.cloud (64^3),
    tmp.dust, tmp.dsc, bg_intensity.bin and freq.dat."""
    d = tmp_path_factory.getbasetemp() / "socex"
    write_example(d)
    return d


@pytest.fixture
def rng():
    return np.random.default_rng(42)
