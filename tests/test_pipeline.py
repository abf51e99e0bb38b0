"""End-to-end pipeline on a miniature soc_example-style model.

Uses the *real* soc_example dust/dsc/background inputs (full physics) on a
small 16^3 uniform cloud so the run finishes quickly on CPU. Checks output
file formats, energy conservation, and the physical plausibility of the
temperature field and surface-brightness maps.
"""

import shutil

import numpy as np
import pytest

from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.io.fields import read_map_file, read_cell_frequency_array
from soc_tpu.pipeline import driver
from soc_tpu.config import RunConfig


INI = """
gridlength      0.01
cloud           tmp.cloud
mapping         16 16 1.0
density         1.0e3
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc 2500
bgpackets       {bgpac}
background      bg_intensity.bin
iterations      1
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
noabsorbed
temperature     tmp.T
CLT
CLE
"""


@pytest.fixture(scope="module")
def minirun(tmp_path_factory, socex):
    wd = tmp_path_factory.mktemp("minisoc")
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin", "freq.dat"):
        shutil.copy(socex / f, wd)
    n = 16
    write_hierarchy(wd / "tmp.cloud", n, n, n, [n**3],
                    [np.ones(n**3, np.float32)])
    ini = wd / "my.ini"
    area = 6 * n * n
    ini.write_text(INI.format(bgpac=8 * area * 3))   # 3 packets/elem/side
    res = driver.run(str(ini), lanes=1 << 14)
    return res, wd


def test_total_energy_closure(minirun):
    """Integrated absorbed energy (CTABS) equals the trapezoid-weighted sum
    of per-frequency (injected - escaped)."""
    res, wd = minirun
    from soc_tpu.transport.medium import trapezoid_weights
    tw = trapezoid_weights(res.freq).astype(np.float64)
    absorbed_f = res.injected - res.escaped
    expect = float(np.sum(absorbed_f * tw))
    got = float(res.ctabs.sum())
    assert abs(got - expect) / expect < 0.01, (got, expect)


def test_temperature_field(minirun):
    res, wd = minirun
    t = res.temperature
    assert t.shape == (16**3,)
    assert np.all(t > 5.0) and np.all(t < 40.0)
    # outer cells warmer than the centre (attenuated ISRF); compare shell
    # and core MEANS -- single cells carry ~0.07 K Monte-Carlo noise, larger
    # than the thin-cloud centre-to-edge gradient
    t3 = t.reshape(16, 16, 16)
    shell = np.ones((16, 16, 16), bool)
    shell[1:-1, 1:-1, 1:-1] = False
    core = np.zeros((16, 16, 16), bool)
    core[6:10, 6:10, 6:10] = True
    assert t3[shell].mean() > t3[core].mean()
    # temperature file round-trips in the hierarchical format
    with open(wd / "tmp.T", "rb") as fp:
        hdr = np.fromfile(fp, np.int32, 6)
        tfile = np.fromfile(fp, np.float32)
    assert list(hdr) == [16, 16, 16, 1, 16**3, 16**3]
    np.testing.assert_allclose(tfile, t, rtol=1e-6)


def test_emitted_file(minirun):
    res, wd = minirun
    em = read_cell_frequency_array(wd / "emitted.data")
    assert em.shape == (16**3, 44)
    assert np.all(em >= 0)
    np.testing.assert_allclose(em, res.emitted, rtol=1e-6)


def test_map_output(minirun):
    res, wd = minirun
    m = read_map_file(wd / "map_dir_00.bin", 44)
    assert m.shape == (44, 16, 16)
    assert np.all(np.isfinite(m))
    # 250um surface brightness positive everywhere, roughly uniform cloud =>
    # centre-to-corner variation bounded
    ifreq = np.argmin(np.abs(res.freq - 2.9979e8 / 250.0e-6))
    s = m[ifreq]
    assert s.min() > 0
    assert s.max() / s.min() < 3.0


def test_map_matches_analytic_thin_los(minirun):
    """At long wavelengths (optically thin), the map equals the analytic LOS
    integral KK*freq*sum(emitted*dens*ds) for the uniform cloud."""
    res, wd = minirun
    from soc_tpu.render.mapping import map_scale_kk
    ifreq = 0   # lowest frequency: tau ~ 1e-8, fully thin
    kk = map_scale_kk(0.01)
    em = res.emitted[:, ifreq].reshape(16, 16, 16)
    dens = 1000.0
    # LOS along -Z through the cube (observer at theta=0: +Z axis)
    expect = kk * res.freq[ifreq] * em.sum(axis=0) * dens  # ds=1 per cell
    got = res.maps[0][ifreq]
    # ~0.1% per-step PEPS over-step inflates the marched path (the reference
    # ray stepper has the same bias); tolerance covers the geometric noise
    np.testing.assert_allclose(got, expect, rtol=1.5e-2)
