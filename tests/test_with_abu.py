"""WITH_ABU: spatially varying abundances in the transport itself.

Equivalence construction: dust B = 2x dust A (same phase function), so a
two-dust run with abundance field a(x) has per-cell cross sections
(a + 2(1-a)) * k_A = (2 - a) * k_A -- identical physics to a SINGLE-dust run
whose density field is scaled by (2 - a(x)). Same RNG streams => identical
trajectories => tallies must match to float tolerance, not just
statistically.
"""

import shutil

import numpy as np

from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.io.dust import read_simple_dust, write_simple_dust, DustOptics
from soc_tpu.pipeline import driver

N = 10

INI = """
gridlength      0.01
cloud           {cloud}
mapping         8 8 1.0
density         1.0
seed            1.0
directions      0.0 0.0
{dust_lines}
background      bg_intensity.bin
bgpackets       {bgpac}
iterations      1
temperature     tmp.T
emitted         emitted.data
noabsorbed
nomap
"""


def test_two_dust_varying_abundance_matches_density_scaled_single(tmp_path, socex):
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    cells = N ** 3
    rng = np.random.default_rng(11)
    rho = rng.uniform(1e4, 5e4, cells).astype(np.float32)
    a = rng.uniform(0.1, 0.9, cells).astype(np.float32)
    write_hierarchy(tmp_path / "two.cloud", N, N, N, [cells], [rho])
    write_hierarchy(tmp_path / "one.cloud", N, N, N, [cells],
                    [(rho * (2.0 - a)).astype(np.float32)])
    a.tofile(tmp_path / "abuA.bin")
    (1.0 - a).tofile(tmp_path / "abuB.bin")

    # dust B = 2x dust A
    optA = read_simple_dust(str(tmp_path / "tmp.dust"), 0.01)
    optB = DustOptics(freq=optA.freq, g=optA.g,
                      abs_gl=2.0 * optA.abs_gl, sca_gl=2.0 * optA.sca_gl,
                      grain_density=optA.grain_density,
                      grain_size=optA.grain_size)
    write_simple_dust(str(tmp_path / "dustB.dust"), optB, 0.01)

    bgpac = 8 * 6 * N * N
    two = tmp_path / "two.ini"
    two.write_text(INI.format(
        cloud="two.cloud", bgpac=bgpac,
        dust_lines="optical tmp.dust\noptical dustB.dust\n"
                   "dsc tmp.dsc 2500\ndsc tmp.dsc 2500\n"
                   "abundance abuA.bin\nabundance abuB.bin"))
    one = tmp_path / "one.ini"
    one.write_text(INI.format(
        cloud="one.cloud", bgpac=bgpac,
        dust_lines="optical tmp.dust\ndsc tmp.dsc 2500"))

    res2 = driver.run(str(two), lanes=1 << 10)
    res1 = driver.run(str(one), lanes=1 << 10)
    # identical RNG streams; per-step optical depths agree to float
    # roundoff ((a + 2(1-a))k vs (2-a)k), so almost all trajectories are
    # identical -- a rare packet flips a scatter decision at the rounding
    # boundary and perturbs a few cells
    total2, total1 = res2.ctabs.sum(), res1.ctabs.sum()
    assert abs(total2 - total1) / total1 < 1e-4
    good = np.isclose(res2.ctabs, res1.ctabs, rtol=1e-4)
    assert good.mean() > 0.98, good.mean()
    np.testing.assert_allclose(res2.escaped.sum(), res1.escaped.sum(),
                               rtol=1e-4)
    # temperatures differ (different density normalization) but must be
    # finite/physical in both
    assert np.isfinite(res2.temperature).all()
