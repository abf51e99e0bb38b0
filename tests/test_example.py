"""The generated example inputs and the compile-cache location."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from soc_tpu.io import example
from soc_tpu.io.dust import read_simple_dust, read_scattering_function
from soc_tpu.io.fields import read_background_intensity

FILES = ("my.ini", "tmp.cloud", "tmp.dust", "tmp.dsc", "bg_intensity.bin",
         "freq.dat")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(d):
    return {f: (d / f).read_bytes() for f in FILES}


def test_example_is_deterministic(tmp_path):
    """Two generations give byte-identical files."""
    example.write_example(tmp_path / "a")
    example.write_example(tmp_path / "b")
    assert _bytes(tmp_path / "a") == _bytes(tmp_path / "b")
    assert not [f for f in os.listdir(tmp_path / "a") if f.startswith(".")]


def test_example_matches_reference_layout(socex):
    """44 channels with 500 and 250 um on channels 7 and 10, frequency
    increasing, a 64^3 cloud and the 999,999-packet ini."""
    opt = read_simple_dust(socex / "tmp.dust", 0.01)
    um = 2.99792458e14 / opt.freq
    assert opt.nfreq == 44 and np.all(np.diff(opt.freq) > 0)
    assert abs(um[10] - 250.0) < 1e-3 and abs(um[7] - 500.0) < 1e-3
    assert np.all(opt.abs_gl > 0) and np.all(opt.sca_gl > 0)
    assert np.all((opt.g >= 0) & (opt.g < 1))
    np.testing.assert_allclose(np.loadtxt(socex / "freq.dat"), opt.freq,
                               rtol=1e-7)
    dsc, csc = read_scattering_function(socex / "tmp.dsc", 44, 2500)
    assert np.all(np.diff(csc, axis=1) >= 0)
    ibg = read_background_intensity(socex / "bg_intensity.bin", 44)
    assert np.all(ibg > 0)
    hdr = np.fromfile(socex / "tmp.cloud", np.int32, 5)
    assert list(hdr) == [64, 64, 64, 1, 64 ** 3]
    ini = (socex / "my.ini").read_text()
    assert "bgpackets       999999" in ini


def test_large_cloud_is_seeded():
    """Same seed, same cloud; another seed, other densities; the octree
    layout is the at-scale one (16^3 refined root block, 512 refined
    children)."""
    lc, va = example.large_cloud_arrays(32, seed=1)
    _, vb = example.large_cloud_arrays(32, seed=1)
    _, vc = example.large_cloud_arrays(32, seed=2)
    assert lc == [32 ** 3, 8 * 16 ** 3, 8 * 512]
    for a, b in zip(va, vb):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(va[0], vc[0])
    # links are negated child indices; the first one is -0.0
    assert (va[0] <= 0).sum() == 16 ** 3 and (va[1] <= 0).sum() == 512
    assert 256 ** 3 + 8 * 16 ** 3 + 8 * 512 == 16_814_080


def test_concurrent_generation_is_atomic(tmp_path):
    """Many writers into one directory (as test workers do) leave complete
    files identical to a single writer's."""
    ref = tmp_path / "ref"
    example.write_dust_inputs(ref)
    shared = tmp_path / "shared"
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            try:
                for _ in range(3):
                    example.write_dust_inputs(shared)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin", "freq.dat"):
        assert (shared / f).read_bytes() == (ref / f).read_bytes()
    assert sorted(os.listdir(shared)) == sorted(os.listdir(ref))


CACHE_PROBE = """
import os, jax, jax.numpy as jnp
from soc_tpu.utils.cache import CACHE_DIR, enable_compile_cache
print(enable_compile_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
f = jax.jit(lambda x: jnp.sin(x) * {c!r} + jnp.cumsum(x))
f(jnp.arange(37.0)).block_until_ready()
"""


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, executables land there and not
    in the checkout's .jax_cache."""
    from soc_tpu.utils.cache import CACHE_DIR
    cdir = tmp_path / "cc"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cdir), PYTHONPATH=REPO)
    before = set(os.listdir(CACHE_DIR)) if os.path.isdir(CACHE_DIR) \
        else set()
    out = subprocess.run([sys.executable, "-c",
                          CACHE_PROBE.format(c=float(os.getpid()))],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[0] == str(cdir)
    written = set(os.listdir(cdir))
    assert written
    after = set(os.listdir(CACHE_DIR)) if os.path.isdir(CACHE_DIR) \
        else set()
    assert not (written & (after - before))


@pytest.mark.parametrize("n", [8, 16])
def test_example_temperatures_in_range(tmp_path, n):
    """The example's dust and ISRF put the externally heated cloud at
    10-20 K (density scaled with n to keep the 64^3 column)."""
    from soc_tpu.pipeline import driver
    ini = example.write_example(
        tmp_path, n=n, bgpackets=8 * 6 * n * n,
        density=example.EXAMPLE_DENSITY * example.EXAMPLE_N / n)
    res = driver.run(ini, lanes=1 << 12, write_files=False)
    assert 10.0 < res.temperature.min() < res.temperature.max() < 20.0
