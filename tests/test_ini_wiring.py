"""Every ini keyword must drive real behavior (no silent no-ops).

End-to-end runs through driver.run / run_pipeline on a small model with the
real soc_example dust, exercising: savetau/colden, mapum/wavelength,
loadtemp, cload/csave, diffuse+diffpack, roi/roisave/roiload, polstat,
MAP_HIER, pssavetau, libabs, simum, and the library pipeline modes.
"""

import os
import shutil

import numpy as np
import pytest

from soc_tpu.config import RunConfig
from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.pipeline import driver

N = 12          # root grid for all tests here
LANES = 1 << 10

BASE_INI = """
gridlength      0.01
cloud           tmp.cloud
mapping         8 8 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc 2500
background      bg_intensity.bin
bgpackets       {bgpac}
iterations      1
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
temperature     tmp.T
"""


@pytest.fixture()
def model_dir(tmp_path, socex):
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    write_hierarchy(tmp_path / "tmp.cloud", N, N, N, [N ** 3],
                    [np.ones(N ** 3, np.float32)])
    return tmp_path


def run_ini(model_dir, extra="", base=None, **fmt):
    fmt.setdefault("bgpac", 8 * 6 * N * N)
    ini = model_dir / "run.ini"
    ini.write_text((base or BASE_INI).format(**fmt) + extra)
    return driver.run(str(ini), lanes=LANES)


def test_savetau_and_colden(model_dir):
    res = run_ini(model_dir, "savetau  taumap  250.0 -1.0\n")
    # two outputs: tau map at 250um and a column-density map
    t0 = np.fromfile(model_dir / "taumap_0.0", np.float32)[2:].reshape(8, 8)
    c1 = np.fromfile(model_dir / "taumap_1.0", np.float32)[2:].reshape(8, 8)
    assert np.all(t0 > 0)
    # column density: N^3 uniform cells of 3e4 cm^-3 over N*GL pc
    from soc_tpu.constants import PARSEC
    expect = 3.0e4 * N * 0.01 * PARSEC
    np.testing.assert_allclose(c1, expect, rtol=1e-3)
    assert ("savetau", 0, 0) in res.maps


def test_mapum_selects_frequencies(model_dir):
    res = run_ini(model_dir, "mapum  250.0 500.0\n")
    assert res.maps[0].shape[0] == 2          # only two planes rendered
    full = np.fromfile(model_dir / "map_dir_00.bin", np.float32)
    assert full.size == 2 + 2 * 8 * 8         # [NX, NY] header + 2 planes


def test_wavelength_band(model_dir):
    res = run_ini(model_dir, "wavelength  1000.0 100.0\n")
    from soc_tpu.constants import um2f
    freq = res.freq
    nsel = int(np.sum((freq >= um2f(1000.0)) & (freq <= um2f(100.0))))
    assert 0 < nsel < len(freq)
    assert res.maps[0].shape[0] == nsel


def test_loadtemp_reproduces_emission(model_dir):
    res1 = run_ini(model_dir)
    emitted1 = res1.emitted.copy()
    res2 = run_ini(model_dir, "loadtemp\niterations 0\n")
    np.testing.assert_allclose(res2.emitted, emitted1, rtol=1e-5)
    assert res2.maps[0].shape == res1.maps[0].shape


def test_csave_cload(model_dir):
    res1 = run_ini(model_dir, "csave  ctabs.save\n")
    assert (model_dir / "ctabs.save").exists()
    # second run: no packets simulated at all, heating loaded from the file
    res2 = run_ini(model_dir, "cload  ctabs.save\n", bgpac=0)
    np.testing.assert_allclose(res2.temperature, res1.temperature,
                               rtol=1e-6)


def test_diffuse_source_matches_cell_emission(model_dir):
    """A diffuse emission field must heat the cloud like an equivalent
    cell-emission run (SimRAM_CL SOURCE==2 vs dust re-emission: same
    generator physics, different normalization conventions)."""
    import jax.numpy as jnp
    from soc_tpu.constants import PARSEC
    from soc_tpu.io.cloud import read_cloud
    from soc_tpu.io.dust import read_simple_dust, read_scattering_function
    from soc_tpu.transport.medium import medium_from_optics

    cells = N ** 3
    rng = np.random.default_rng(5)
    nf = 44
    field = np.zeros((cells, nf), np.float32)
    field[:, 20] = rng.uniform(0.5, 1.5, cells).astype(np.float32)
    with open(model_dir / "diffuse.bin", "wb") as fp:
        np.asarray([cells, nf], np.int32).tofile(fp)
        field.tofile(fp)

    res = run_ini(model_dir,
                  "diffuse  diffuse.bin\ndiffpack %d\nnosolve\n" % (4 * cells),
                  bgpac=0)
    assert res.injected[20] > 0
    assert res.injected.sum() == pytest.approx(res.injected[20])
    assert res.ctabs.sum() > 0

    # equivalent run through simulate_cell_emission with the same photon
    # loads: EMIT = field * GL*PARSEC (level 0)
    grid = read_cloud(str(model_dir / "tmp.cloud"), 3.0e4, 999)
    optics = [read_simple_dust(str(model_dir / "tmp.dust"), 0.01)]
    dsc, csc = read_scattering_function(str(model_dir / "tmp.dsc"), nf, 2500)
    medium = medium_from_optics(optics, dsc, csc, optics[0].freq)
    cfg = RunConfig(text="cloud tmp.cloud\noptical tmp.dust\ngridlength 0.01"
                         "\ncellpackets %d" % (4 * cells))
    cfg.freq = optics[0].freq
    emitted = field * np.float32(0.01 * PARSEC)
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = jnp.zeros((1, 1), jnp.float32)
    tabs, _, esc, _ = driver.simulate_cell_emission(
        grid, medium, cfg, emitted, tabs, intf,
        np.uint32(1.0 * 2 ** 31) + np.uint32(12345), lanes=LANES)
    # same photon budget, same generator -> tallies equal to MC noise
    np.testing.assert_allclose(res.ctabs.sum(), float(np.asarray(tabs).sum()),
                               rtol=2e-2)


def test_roi_save_then_load(model_dir):
    res = run_ini(
        model_dir,
        "roi  3 8 3 8 3 8\nroisave  roi.photons 1\nroinside  4\nnosolve\n")
    path = model_dir / "roi.photons"
    assert path.exists()
    from soc_tpu.transport.roi import read_roi_file
    rnx, rny, rnz, nside, data = read_roi_file(str(path))
    assert (rnx, rny, rnz, nside) == (6, 6, 6, 4)
    assert data.shape[0] == 44 and data.sum() > 0

    # re-inject into a sub-model spanning the ROI box
    sub = model_dir / "sub"
    sub.mkdir()
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(model_dir / f, sub)
    write_hierarchy(sub / "tmp.cloud", 6, 6, 6, [6 ** 3],
                    [np.ones(6 ** 3, np.float32)])
    shutil.copy(path, sub / "roi.photons")
    ini = sub / "run.ini"
    ini.write_text(BASE_INI.format(bgpac=0)
                   + "roiload  roi.photons 1.0\nroipackets 20000\nnosolve\n")
    res2 = driver.run(str(ini), lanes=LANES)
    assert res2.ctabs.sum() > 0
    assert res2.injected.sum() > 0
    # boundary source cannot inject more photons than were recorded
    assert res2.injected.sum() <= data.sum() * 1.0001


def test_polstat_maps(model_dir):
    cells = N ** 3
    # uniform field along +Z
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    res = run_ini(model_dir,
                  "polmap 1\npolstat 1\nBfiles Bx.bin By.bin Bz.bin\n")
    stack = np.fromfile(model_dir / "polstat_dir_00.bin", np.float32)
    stack = stack[2:].reshape(7, 8, 8)
    rT, rI, B, BLOS, BPOS = stack[0], stack[1], stack[2], stack[3], stack[4]
    # observer at theta=0 looks along +Z -> B parallel to LOS:
    # position angle is degenerate (float noise), dispersion stays tiny;
    # inclination from the plane of sky gamma = 90 deg -> cos^2 gamma ~ 0
    # -> rI = arccos(sqrt(<cos^2 gamma>)) ~ pi/2
    np.testing.assert_allclose(rT, 0.0, atol=5e-3)
    np.testing.assert_allclose(rI, np.pi / 2, atol=0.05)
    np.testing.assert_allclose(B, 1.0, rtol=1e-5)
    np.testing.assert_allclose(BLOS, 1.0, rtol=1e-4)
    np.testing.assert_allclose(BPOS, 0.0, atol=1e-3)
    assert ("polstat", 0) in res.maps


def test_polrhoweight_density_weighted_iqu(model_dir):
    cells = N ** 3
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    extra = "polmap 1\nBfiles Bx.bin By.bin Bz.bin\n"
    res_em = run_ini(model_dir, extra)
    res_rho = run_ini(model_dir, extra + "polrhoweight\n")
    i_em = res_em.maps[("pol", 0)][0]
    i_rho = res_rho.maps[("pol", 0)][0]
    # rho weighting drops emission and attenuation from the integrand
    # (kernel_ASOC_map.c:1092): on a uniform unit-density cloud the Stokes I
    # map reduces to geometry only -- identical across frequencies and NOT
    # equal to the emission-weighted map
    np.testing.assert_allclose(i_rho[0], i_rho[-1], rtol=1e-5)
    assert not np.allclose(i_em[0], i_em[-1], rtol=1e-3)
    assert i_rho.sum() > 0


def test_maphier_levels_sum_to_plain_map(model_dir):
    res_h = run_ini(model_dir, base=BASE_INI.replace(
        "mapping         8 8 1.0", "mapping         8 8 1.0 999"))
    res_p = run_ini(model_dir)
    hier = res_h.maps[("hier", 0)]              # [NF, LEVELS, NY, NX]
    assert hier.shape[1] == 1
    np.testing.assert_allclose(hier[:, 0], res_p.maps[0], rtol=1e-5)
    raw = np.fromfile(model_dir / "map_dir_00_H.bin", np.float32)
    nx, ny, nf, lev = raw[:4].view(np.int32)[[0, 1, 2, 3]]
    assert (nx, ny, lev) == (8, 8, 1)


def test_pssavetau(model_dir):
    lum = np.full(44, 1e36, np.float32)
    lum.tofile(model_dir / "ps.bin")
    run_ini(model_dir,
            "pointsource  6.0 6.0 6.0  ps.bin\npspackets 8192\n"
            "pssavetau  pstau 250.0\n")
    rows = np.loadtxt(model_dir / "pstau_0.dat")
    rows = np.atleast_2d(rows)
    assert rows.shape[1] == 3
    assert rows[0, 1] > 0 and rows[0, 2] > 0   # colden, tau both positive


def test_libabs_reduced_absorbed(model_dir):
    res = run_ini(model_dir, "libabs  0.55 2.2 25.0\nnomap\n")
    from soc_tpu.io.fields import read_cell_frequency_array
    with open(model_dir / "absorbed.data", "rb") as fp:
        cells, ncols = np.fromfile(fp, np.int32, 2)
    assert (cells, ncols) == (N ** 3, 3)
    assert res.emitted is None                 # solve skipped entirely
    assert not (model_dir / "map_dir_00.bin").exists()


def test_simum_band_limits_simulation(model_dir):
    res = run_ini(model_dir, "simum  100.0 1000.0\nnosolve\n")
    from soc_tpu.constants import um2f
    freq = res.freq
    inband = (freq >= um2f(1000.0)) & (freq <= um2f(100.0))
    assert 0 < inband.sum() < len(freq)
    col = res.absorbed.max(axis=0)
    assert np.all(col[inband] > 0)
    assert np.all(col[~inband] <= 0)           # nothing simulated there
    assert res.injected[~inband].sum() == 0


def test_remit_band_reduces_emitted_file(model_dir):
    run_ini(model_dir, "remit  100.0 2000.0\n")
    from soc_tpu.constants import um2f
    with open(model_dir / "emitted.data", "rb") as fp:
        cells, ncols = np.fromfile(fp, np.int32, 2)
    assert cells == N ** 3 and 0 < ncols < 44


def test_saveint_four_component(model_dir):
    """SAVE_INTENSITY==2: ISRF.DAT holds (I, Ix, Iy, Iz) with the direction
    moments normalized by the total intensity."""
    res = run_ini(model_dir, "saveint 2\nnosolve\nnomap\n")
    with open(model_dir / "ISRF.DAT", "rb") as fp:
        cells, nf, k = np.fromfile(fp, np.int32, 3)
        data = np.fromfile(fp, np.float32).reshape(cells, nf, k)
    assert (cells, nf, k) == (N ** 3, 44, 4)
    assert np.all(data[:, :, 0] >= 0)
    # isotropic external illumination: net direction moments ~ 0 in the
    # cloud interior, and always within [-1, 1] after normalization
    assert np.all(np.abs(data[:, :, 1:]) <= 1.0 + 1e-5)
    mid = data[:, 10, 1:]      # a well-populated frequency channel
    assert np.abs(mid.mean(axis=0)).max() < 0.15


def test_saveint_scalar(model_dir):
    res = run_ini(model_dir, "saveint 1 isrf.bin\nnosolve\nnomap\n")
    with open(model_dir / "isrf.bin", "rb") as fp:
        cells, nf = np.fromfile(fp, np.int32, 2)
    assert (cells, nf) == (N ** 3, 44)


def test_yshear_periodic_continuation(model_dir):
    """yshear: rays exiting through the X faces re-enter with a sheared y
    coordinate until maxlos; column density grows accordingly. Observer
    along +X so the LOS crosses the sheared faces."""
    from soc_tpu.constants import PARSEC
    base = BASE_INI.replace("directions      0.0 0.0",
                            "directions      90.0 0.0")
    res1 = run_ini(model_dir, base=base)
    res3 = run_ini(model_dir, "yshear  2.0\n", base=base)
    cfg = RunConfig(str(model_dir / "run.ini"))
    assert cfg.y_shear == 2.0
    c1 = res1.maps[("colden", 0)]
    c3 = res3.maps[("colden", 0)]
    # with shear the ray wraps until maxlos (default huge, so bounded by
    # max_steps); the column must grow several-fold over the plain LOS
    assert c3.mean() > 2.5 * c1.mean()


def test_map_interpolation_uniform_invariant(model_dir):
    """MAP_INTERPOLATION on a uniform cloud must reproduce the plain map
    (the triangle weights sum to one)."""
    res0 = run_ini(model_dir)
    res1 = run_ini(model_dir, "mapint 2\n")
    np.testing.assert_allclose(res1.maps[0], res0.maps[0], rtol=5e-3)


def test_stepweight_and_direweight_unbiased(model_dir):
    """STEP_WEIGHT free-path stretching and DIR_WEIGHT HG importance
    sampling both reweight packets: temperatures must match the plain run
    within MC noise."""
    res0 = run_ini(model_dir)
    res_sw = run_ini(model_dir, "stepweight 1 1.4\n")
    res_dw = run_ini(model_dir, "direweight 1 0.5\n")
    res_s2 = run_ini(model_dir, "stepweight 2 1.3 0.4\n")
    np.testing.assert_allclose(res_sw.temperature, res0.temperature,
                               rtol=0.05)
    np.testing.assert_allclose(res_dw.temperature, res0.temperature,
                               rtol=0.05)
    np.testing.assert_allclose(res_s2.temperature, res0.temperature,
                               rtol=0.05)


def test_stepweight2_importance_identity():
    """STEP_WEIGHT==2 sampling (kernel_ASOC.c:529-541): for the
    two-exponential proposal the weighted moments must reproduce the
    unit-exponential's (E[w] = 1, E[w t] = 1, E[w t^2] = 2)."""
    import jax.numpy as jnp
    from soc_tpu.grid import uniform_grid
    from soc_tpu.transport.propagate import make_step_fns

    grid = uniform_grid(2, 2, 2)
    physics = dict(kabs=jnp.float32(1.0), ksca=jnp.float32(1.0),
                   csc=jnp.zeros(8, jnp.float32), tw=jnp.float32(1.0),
                   sw_a=jnp.float32(1.3), sw_b=jnp.float32(0.4))
    kit = make_step_fns(grid, physics, jnp.uint32(1))
    u = jnp.asarray((np.arange(1 << 20) + 0.5) / (1 << 20), jnp.float32)
    fp, w = kit.draw_fp_weighted(u)
    fp = np.asarray(fp, np.float64)
    w = np.asarray(w, np.float64)
    assert abs(w.mean() - 1.0) < 1e-3
    assert abs((w * fp).mean() - 1.0) < 1e-3
    assert abs((w * fp * fp).mean() - 2.0) < 5e-3


def test_optishalf_runs_close(model_dir):
    """bfloat16 OPT storage: same physics to half precision."""
    cells = N ** 3
    np.full(cells, 0.5, np.float32).tofile(model_dir / "abu.bin")
    np.full(cells, 0.5, np.float32).tofile(model_dir / "abu2.bin")
    extra = ("optical tmp.dust\ndsc tmp.dsc 2500\n"
             "abundance abu.bin\nabundance abu2.bin\n")
    res_f = run_ini(model_dir, extra)
    res_h = run_ini(model_dir, extra + "optishalf\n")
    np.testing.assert_allclose(res_h.temperature, res_f.temperature,
                               rtol=0.02)


def test_mapview_keyword(model_dir):
    """mapview theta phi NX NY dx Xc Yc Zc replaces direction/mapping/
    mapcentre in one line (ASOC_aux.py:498-511)."""
    res = run_ini(model_dir, "mapview 90.0 0.0 6 6 0.5 6.0 6.0 6.0\n")
    cfg = RunConfig(str(model_dir / "run.ini"))
    assert cfg.npix == (6, 6) and cfg.map_dx == 0.5
    assert cfg.mapcentre == (6.0, 6.0, 6.0)
    np.testing.assert_allclose(cfg.obs_theta, [np.pi / 2])
    assert len(cfg.obs_phi) == 1
    assert res.maps[0].shape[1:] == (6, 6)
    assert np.isfinite(res.maps[0]).all() and res.maps[0].max() > 0


def test_mabu_ofreq_output_selection(model_dir, monkeypatch):
    """The mabu CLI's optional ofreq.dat argument (A2E_MABU.py:32,66-68)
    and the mapum-driven NOFREQ limiting (A2E_MABU.py:316-323) select the
    emitted-file output columns."""
    from soc_tpu.cli import main
    from soc_tpu.io.dust import read_simple_dust
    from soc_tpu.io.fields import read_cell_frequency_array
    run_ini(model_dir)      # produces absorbed.data on the full grid
    freq = read_simple_dust(str(model_dir / "tmp.dust"), 0.01).freq
    monkeypatch.chdir(model_dir)
    # full output
    assert main(["mabu", "run.ini", "absorbed.data", "emitted_f.data"]) == 0
    full = read_cell_frequency_array("emitted_f.data")
    assert full.shape[1] == len(freq)
    # ofreq file with two frequencies
    np.savetxt("ofreq.dat", freq[[10, 20]])
    assert main(["mabu", "run.ini", "absorbed.data", "emitted_o.data",
                 "ofreq.dat"]) == 0
    sub = read_cell_frequency_array("emitted_o.data")
    assert sub.shape[1] == 2
    np.testing.assert_allclose(sub, full[:, [10, 20]], rtol=1e-6)
    # mapum keyword limits the emitted columns the same way
    (model_dir / "run2.ini").write_text(
        (model_dir / "run.ini").read_text() + "mapum 250.0 500.0\n")
    assert main(["mabu", "run2.ini", "absorbed.data",
                 "emitted_m.data"]) == 0
    assert read_cell_frequency_array("emitted_m.data").shape[1] == 2


def test_split_keyword_through_driver(model_dir):
    """`split` on an octree cloud: transport_run appends a clones count to
    its return value -- the driver must unpack it (regression: the ini
    path crashed with 'too many values to unpack')."""
    from soc_tpu.grid import encode_link_np
    rng = np.random.default_rng(0)
    root = rng.uniform(0.5, 1.0, N ** 3).astype(np.float32)
    centre = (N // 2) + N * (N // 2) + N * N * (N // 2)
    root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
    l1 = rng.uniform(2.0, 4.0, 8).astype(np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3, 8],
                    [root, l1])
    res = run_ini(model_dir, "split\n")
    assert np.isfinite(res.temperature).all()
    assert res.temperature[res.temperature > 0].min() > 3.0


def test_mirror_applies_to_point_sources(model_dir):
    """`mirror xXyYzZ` must confine photons for EVERY source type, not
    just the isotropic background (regression: silently dropped)."""
    lum = np.full(44, 1e36, np.float32)
    lum.tofile(model_dir / "ps.bin")
    # dense cloud + one simulated frequency: keeps the mirrored random
    # walks short (with all six faces mirrored a thin-band packet walks to
    # the 20-scattering cap over thousands of cell crossings, and doing
    # that for all 44 channels made this test minutes long)
    extra = ("pointsource  6.0 6.0 6.0  ps.bin\npspackets 2048\n"
             "density 3.0e6\nsimum 200.0 300.0\n")
    r_plain = run_ini(model_dir, extra, bgpac=0)
    r_mirror = run_ini(model_dir, extra + "mirror xXyYzZ\n", bgpac=0)
    # with every face mirrored nothing escapes: absorbed energy must rise
    assert (r_mirror.ctabs.astype(np.float64).sum()
            > 1.5 * r_plain.ctabs.astype(np.float64).sum())


def test_savetau_outside_band_adds_no_map_planes(model_dir):
    """A savetau frequency outside the mapum band is rendered for the tau
    output but must NOT add planes to map_dir_XX.bin / res.maps."""
    res = run_ini(model_dir, "mapum 250.0\nsavetau  taumap  500.0\n")
    assert res.maps[0].shape[0] == 1
    raw = np.fromfile(model_dir / "map_dir_00.bin", np.float32)
    assert len(raw) - 2 == 1 * 8 * 8
    assert (model_dir / "taumap.0").exists()


def test_loadtemp_applies_remit(model_dir):
    """loadtemp + remit: the recomputed emission must honor the remit band
    (regression: _apply_remit_band return value was dropped)."""
    run_ini(model_dir)                       # writes tmp.T
    res = run_ini(model_dir,
                  "loadtemp\niterations 0\nremit 200.0 2000.0\n")
    freq = np.asarray(res.freq)
    um = 2.9979246e14 / freq
    inside = (um >= 200.0) & (um <= 2000.0)
    assert res.emitted[:, ~inside].max() == 0.0
    assert res.emitted[:, inside].max() > 0.0


def test_sampleini_roundtrip(tmp_path, monkeypatch):
    """`sampleini` emits a documented ini that parses back with the
    documented defaults (WriteSampleIni, ASOC_aux.py:1670-1721)."""
    from soc_tpu.cli import main
    monkeypatch.chdir(tmp_path)
    assert main(["sampleini", "s.ini"]) == 0
    cfg = RunConfig(str(tmp_path / "s.ini"))
    assert cfg.gl == 0.01 and cfg.bgpac == 999999
    assert cfg.npix == (64, 64) and cfg.iterations == 1
    assert cfg.file_cloud == "tmp.cloud" and len(cfg.file_optical) == 1


def test_nnnlimit_masks_low_density_cells(model_dir):
    """`nnnlimit X`: cells with density <= X are marked -1e20 in the
    absorbed payload, exactly like parent cells (ASOC.py:2808-2825)."""
    # gradient cloud so part of the cells fall under the limit
    dens = np.linspace(0.5, 2.0, N ** 3).astype(np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3], [dens])
    # the limit applies to the kdensity-scaled densities (DENS in ASOC.py)
    res = run_ini(model_dir, "nnnlimit 3.0e4\n")
    masked = res.absorbed[:, 0] < -1e19
    expect = np.asarray(res.grid.dens) <= 3.0e4
    assert masked.sum() > 0 and masked.sum() < N ** 3
    np.testing.assert_array_equal(masked, expect)


def test_dustem_keyword_saves_intensity(model_dir):
    """`dustem`: skip the absorbed file, write the intensity file instead
    (ASOC_aux.py:279-281)."""
    res = run_ini(model_dir, "dustem /nonexistent/path\nnomap 1\n")
    assert res.absorbed is None
    assert (model_dir / "ISRF.DAT").exists()
    from soc_tpu.io.fields import read_cell_frequency_array
    isrf = read_cell_frequency_array(str(model_dir / "ISRF.DAT"))
    assert isrf.shape[0] == N ** 3 and isrf.sum() > 0


def test_interpolation_healpix_map(model_dir):
    """`interpolation N`: LOS density smoothing in the all-sky healpix map
    (kernel_ASOC_map_H.c:654-733). On a uniform cloud every mode must
    reproduce the unsmoothed map exactly; on a gradient cloud the smoothed
    map differs but conserves the total within a few percent."""
    base = BASE_INI.replace("mapping         8 8 1.0",
                            "mapping         4 0 1.0")
    extra = "perspective 6.0 6.0 6.0\n"
    res0 = run_ini(model_dir, extra, base=base)
    for mode in (1, 2, 3):
        res = run_ini(model_dir, extra + "interpolation %d\n" % mode,
                      base=base)
        np.testing.assert_allclose(res.maps[0], res0.maps[0], rtol=1e-4)
    # gradient cloud: interpolation changes the map but not its scale
    dens = np.linspace(0.5, 2.0, N ** 3).astype(np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3], [dens])
    g0 = run_ini(model_dir, extra, base=base)
    for mode in (1, 2, 3):
        g = run_ini(model_dir, extra + "interpolation %d\n" % mode,
                    base=base)
        assert not np.allclose(g.maps[0], g0.maps[0])
        assert abs(g.maps[0].sum() / g0.maps[0].sum() - 1.0) < 0.05, mode


def test_interpolation_on_octree_ignores_links(model_dir):
    """`interpolation 1/2` on a refined cloud: refined root cells hold
    bit-cast child links in the density array; the LOS smoothing must not
    blend those into the map (regression: negative/garbage intensities)."""
    from soc_tpu.io.cloud import write_hierarchy as _wh
    from soc_tpu.grid import encode_link_np
    root = np.ones(N ** 3, np.float32)
    refined = [0, 5, N ** 3 // 2, N ** 3 - 1]
    for j, r in enumerate(refined):
        root[r] = encode_link_np(np.asarray([8 * j], np.int32))[0]
    child = np.ones(8 * len(refined), np.float32)
    _wh(model_dir / "tmp.cloud", N, N, N,
        [N ** 3, len(child)], [root, child])
    base = BASE_INI.replace("mapping         8 8 1.0",
                            "mapping         4 0 1.0")
    extra = "perspective 6.0 6.0 6.0\n"
    res0 = run_ini(model_dir, extra, base=base)
    for mode in (1, 2, 3):
        res = run_ini(model_dir, extra + "interpolation %d\n" % mode,
                      base=base)
        m = res.maps[0]
        assert np.isfinite(m).all() and (m >= 0).all(), mode
        # uniform physical density everywhere -> smoothing is a no-op up
        # to float noise; link contamination would blow this up
        np.testing.assert_allclose(m, res0.maps[0], rtol=1e-3)


def test_alibeta_refinement_is_active(model_dir, monkeypatch):
    """`alibeta` must feed the PREVIOUS iteration's temperature into
    refine_beta (regression: it was called without t_old, making the
    correction identically 1 -- a silent no-op)."""
    from soc_tpu.solve import ali
    calls = []
    real = ali.refine_beta

    def spy(beta0, t_new, freq, kabs, dens, t_old=None, table=None):
        calls.append((np.asarray(t_new).copy(),
                      None if t_old is None else np.asarray(t_old).copy()))
        return real(beta0, t_new, freq, kabs, dens, t_old=t_old,
                    table=table)

    monkeypatch.setattr(ali, "refine_beta", spy)
    dens = np.linspace(0.5, 4.0, N ** 3).astype(np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3], [dens])
    extra = "cellpackets %d\niterations 3\nali 1\nalibeta\n" % (4 * N ** 3)
    res = run_ini(model_dir, extra)
    # iteration 0 has no previous T -> skipped; iterations 1,2 refine
    assert len(calls) == 2
    for t_new, t_old in calls:
        assert t_old is not None
        assert t_old.shape == t_new.shape
    # the second call's t_old is the previous iteration's (refined) T
    assert np.isfinite(res.temperature).all()
    # sanity on the correction itself: distinct temperatures move beta
    from soc_tpu.solve.ali import beta_table, refine_beta as rb
    freq = res.freq
    kabs = 0.2 * (freq / freq[-1]) ** 1.5
    beta0 = np.full(N ** 3, 0.5, np.float32)
    hot = np.full(N ** 3, 40.0)
    cold = np.full(N ** 3, 10.0)
    out = rb(beta0, hot, freq, kabs, np.full(N ** 3, 100.0), t_old=cold)
    # hotter dust weights more opaque channels -> lower escape probability
    # (the effect is small by construction: the reference's tau grid tops
    # out at ~100 and FIR channels stay thin)
    assert np.all(out <= beta0) and np.max(beta0 - out) > 1e-4


def test_threshold_excludes_low_levels_from_maps(model_dir):
    """`threshold L` (LEVEL_THRESHOLD, kernel_ASOC_map.c:825-839): map
    emission must exclude hierarchy levels < L while extinction still
    accumulates. With threshold above the deepest level the map is zero;
    with threshold 1 only the refined octet radiates."""
    from soc_tpu.grid import encode_link_np
    root = np.full(N ** 3, 0.5, np.float32)
    centre = (N // 2) + N * (N // 2) + N * N * (N // 2)
    root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
    l1 = np.full(8, 4.0, np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3, 8],
                    [root, l1])
    r_plain = run_ini(model_dir, "mapum 250.0\n")
    r_thr1 = run_ini(model_dir, "mapum 250.0\nthreshold 1\n")
    r_thr2 = run_ini(model_dir, "mapum 250.0\nthreshold 2\n")
    full = r_plain.maps[0].astype(np.float64).sum()
    lvl1 = r_thr1.maps[0].astype(np.float64).sum()
    assert 0.0 < lvl1 < 0.5 * full      # only the octet's emission remains
    assert r_thr2.maps[0].max() == 0.0  # no level >= 2 exists
    # tau output is extinction-only: unchanged by the threshold
    np.testing.assert_allclose(np.asarray(r_thr1.tau_maps[0]),
                               np.asarray(r_plain.tau_maps[0]), rtol=1e-6)


def test_polmap_fits_products(model_dir):
    """polmap must emit the reference's FITS products (ASOC.py:3798-3800):
    one 'polmap_%.1f_%02d.fits' per map-band frequency holding the
    [4, NY, NX] (I, Q, U, N) cube, consistent with the binary container."""
    from soc_tpu.constants import f2um
    from soc_tpu.io.fits import read_fits_image
    cells = N ** 3
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    res = run_ini(model_dir, "polmap 1\nBfiles Bx.bin By.bin Bz.bin\n"
                  "mapum 250.0\n")
    ifq = int(np.argmin(np.abs(res.freq
                               - 2.99792458e14 / 250.0 * 1e4 / 1e4)))
    # pick the in-band channel the driver actually wrote
    import glob
    files = sorted(glob.glob(str(model_dir / "polmap_*_00.fits")))
    assert len(files) == 1              # mapum selected a single channel
    cube, hdr = read_fits_image(files[0])
    assert cube.shape == (4, 8, 8)
    sel = int(np.argmin(np.abs(np.asarray([f2um(f) for f in res.freq])
                               - float(files[0].split("_")[-2]))))
    s_i = res.maps[("pol", 0)][0]
    np.testing.assert_allclose(cube[0], s_i[sel], rtol=1e-6)
    assert cube[3].min() > 0            # column density plane


def test_pol_healpix_fits_products(model_dir):
    """Internal-observer polarization must emit healpy-convention FITS
    binary tables 'pol_healpix.fits.%d' (ASOC.py:3948-3958) with
    I/Q/U/N columns, RING ordering and the NSIDE keyword."""
    from soc_tpu.io.fits import read_healpix_map
    cells = N ** 3
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    nside = 4
    base = BASE_INI.replace("mapping         8 8 1.0",
                            "mapping         %d 0 1.0" % nside)
    run_ini(model_dir, "polmap 1\nBfiles Bx.bin By.bin Bz.bin\n"
            "mapum 250.0\n", base=base)
    import glob
    files = sorted(glob.glob(str(model_dir / "pol_healpix.fits.*")))
    assert len(files) == 1
    maps, hdr = read_healpix_map(files[0])
    assert maps.shape == (4, 12 * nside * nside)
    assert hdr["ORDERING"] == "RING"
    assert int(hdr["NSIDE"]) == nside
    assert hdr["TTYPE1"] == "I_STOKES"
    assert maps[0].sum() > 0


def test_mmapabs_out_of_core_tally(model_dir, monkeypatch):
    """`mmapabs` (and the SOC_TPU_TALLY_BYTES auto-trigger): the
    [CELLS, NFREQ] per-frequency tally lives in a host memmap with only
    one [CELLS] column on the device at a time; results must be identical
    to the device-resident run (same streams, same deposits)."""
    r_dev = run_ini(model_dir, "cellpackets 2048\niterations 2\n")
    r_mm = run_ini(model_dir, "cellpackets 2048\niterations 2\nmmapabs\n")
    np.testing.assert_allclose(r_mm.ctabs, r_dev.ctabs, rtol=1e-6)
    # in-place scaling runs in float32 (vs the float64 copy path): a few
    # cells differ at the last float32 bit
    np.testing.assert_allclose(np.asarray(r_mm.absorbed),
                               np.asarray(r_dev.absorbed), rtol=5e-6,
                               atol=1e-30)
    np.testing.assert_allclose(r_mm.temperature, r_dev.temperature,
                               rtol=1e-6)
    # the chunked writer produced a well-formed absorbed.data payload
    a_mm = np.fromfile(model_dir / "absorbed.data", np.float32)
    assert a_mm[:2].view(np.int32).tolist() == [12 ** 3, 44]
    np.testing.assert_allclose(a_mm[2:].reshape(-1, 44),
                               np.asarray(r_mm.absorbed), rtol=1e-7)
    # auto-trigger: a tiny device budget forces the host tally
    monkeypatch.setenv("SOC_TPU_TALLY_BYTES", "1024")
    r_auto = run_ini(model_dir, "cellpackets 2048\niterations 2\n")
    np.testing.assert_allclose(np.asarray(r_auto.absorbed),
                               np.asarray(r_dev.absorbed), rtol=5e-6,
                               atol=1e-30)


def test_mmapabs_with_ali_and_emweight(model_dir):
    """The out-of-core tally must cover the per-frequency ALI and
    emission-weighted re-emission loops too."""
    extra = "cellpackets 2048\niterations 2\nALI\nemweight 1 0 100\n"
    r_dev = run_ini(model_dir, extra)
    r_mm = run_ini(model_dir, extra + "mmapabs\n")
    np.testing.assert_allclose(np.asarray(r_mm.absorbed),
                               np.asarray(r_dev.absorbed), rtol=5e-6,
                               atol=1e-30)
    np.testing.assert_allclose(r_mm.temperature, r_dev.temperature,
                               rtol=1e-6)


def test_maphier_healpix_allsky(model_dir):
    # `mapping NSIDE -1 dx 999`: MAP_HIER + healpix = per-level all-sky
    # maps (ASOC.py:3332 -> kernel_ASOC_map_H.c:507). Summing the level
    # planes must reproduce the plain all-sky map of the same model.
    base_h = BASE_INI.replace("mapping         8 8 1.0",
                              "mapping         4 -1 1.0 999")
    res_h = run_ini(model_dir, base=base_h)
    hier = res_h.maps[("hier_hp", 0)]           # [NF, LEVELS, NPIX]
    assert hier.shape[1:] == (1, 12 * 16)
    base_p = BASE_INI.replace("mapping         8 8 1.0",
                              "mapping         4 -1 1.0")
    res_p = run_ini(model_dir, base=base_p)
    np.testing.assert_allclose(hier[:, 0], res_p.maps[0], rtol=1e-5)
    raw = np.fromfile(model_dir / "map_dir_00_H.bin", np.float32)
    nside, ny, nf, lev = raw[:4].view(np.int32)
    assert (nside, ny, lev) == (4, -1, 1)
    assert nf == hier.shape[0]


def test_polstat1_writes_all_four_planes(model_dir):
    cells = N ** 3
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    res = run_ini(model_dir,
                  "polmap 1\npolstat 1\nBfiles Bx.bin By.bin Bz.bin\n")
    four = res.maps[("polstat4", 0)]            # [4, NF, NY, NX]
    assert four.shape[0] == 4 and four.shape[2:] == (8, 8)
    rT, rI, jT, jI = four
    # B parallel to the LOS (observer at theta=0 looks along +Z):
    # both weighting families see gamma = 90 deg and zero dispersion
    np.testing.assert_allclose(rT, 0.0, atol=5e-3)
    np.testing.assert_allclose(jT, 0.0, atol=5e-3)
    np.testing.assert_allclose(rI, np.pi / 2, atol=0.05)
    np.testing.assert_allclose(jI, np.pi / 2, atol=0.05)
    # the reference product: one polmap FITS per map-band frequency
    import glob
    assert glob.glob(str(model_dir / "polmap_*_00.fits"))


def test_polstat1_families_differ_with_structure(model_dir):
    # emission weighting must actually differ from density weighting
    # when the field is tangled: j weights concentrate on the warm
    # (attenuation-weighted) part of each LOS
    cells = N ** 3
    rng = np.random.default_rng(7)
    for name in ("Bx", "By", "Bz"):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [rng.normal(size=cells).astype(np.float32)])
    res = run_ini(model_dir,
                  "polmap 1\npolstat 1\nBfiles Bx.bin By.bin Bz.bin\n")
    rT, rI, jT, jI = res.maps[("polstat4", 0)]
    assert float(rT.mean()) > 0.3               # tangled -> dispersed
    assert float(jT.mean()) > 0.3
    # families are not copies of one another
    assert not np.allclose(rT[0], jT[0], rtol=1e-3)


def test_polstat_healpix_stats_maps(model_dir):
    cells = N ** 3
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(model_dir / (name + ".bin"), N, N, N, [cells],
                        [np.full(cells, val, np.float32)])
    base = BASE_INI.replace("mapping         8 8 1.0",
                            "mapping         4 -1 1.0")
    res = run_ini(model_dir, base=base,
                  extra="polmap 1\npolstat 1\n"
                        "Bfiles Bx.bin By.bin Bz.bin\n")
    stack = res.maps[("polstat_hp", 0)]         # [4, NF, NPIX]
    npix = 12 * 16
    assert stack.shape[0] == 4 and stack.shape[2] == npix
    rI = stack[1, 0]
    # uniform B along +Z: polar pixels look along B (gamma = 90 deg ->
    # rhoGamma ~ pi/2), equatorial pixels look across it (rhoGamma ~ 0)
    assert rI[0] > 1.3                          # RING pixel 0 ~ north pole
    eq = rI[npix // 2 - 8: npix // 2 + 8]       # equatorial ring
    assert eq.max() < 0.3
    raw = np.fromfile(model_dir / "pol_healpix.bin", np.float32)
    nside, nf = raw[:2].view(np.int32)
    assert nside == 4 and nf == stack.shape[1]
    import glob
    assert glob.glob(str(model_dir / "pol_healpix.fits.*"))


def test_roimap_restricts_map_emission(model_dir):
    # roimap: maps include only emission from inside the ROI box
    # (extinction unchanged) -- kernel_ASOC_map.c InRoi gate
    res_all = run_ini(model_dir)
    res_roi = run_ini(model_dir, "roi 0 5 0 11 0 11\nroimap\n")
    m_all, m_roi = res_all.maps[0], res_roi.maps[0]
    assert 0 < m_roi.sum() < 0.75 * m_all.sum()
    # a ROI covering the whole cloud must change nothing
    res_full = run_ini(model_dir,
                       "roi 0 %d 0 %d 0 %d\nroimap\n" % (N - 1, N - 1,
                                                         N - 1))
    np.testing.assert_allclose(res_full.maps[0], m_all, rtol=1e-6)
    # tau maps identical: ROI masks emission only
    np.testing.assert_allclose(res_roi.tau_maps[0], res_all.tau_maps[0],
                               rtol=1e-6)


def test_emweight_mode2_e2e(model_dir):
    """emwei 2: deterministic per-cell packet quotas (USE_EMWEIGHT==2,
    ASOC.py:1773-1789). The re-emission phase must stay unbiased --
    temperatures match the unweighted run within MC noise."""
    res0 = run_ini(model_dir, "cellpackets 8192\niterations 2\n")
    res2 = run_ini(model_dir,
                   "cellpackets 8192\niterations 2\nemweight 2 0 100\n")
    np.testing.assert_allclose(res2.temperature, res0.temperature,
                               rtol=0.05)


def test_diffuse_with_emweight_unbiased(model_dir):
    """The reference weights phase-1 diffuse packets by the diffuse
    emission field when emwei > 0 (ASOC.py:1277-1292). The weighted run
    must deposit the same heating within MC noise."""
    cells = N ** 3
    rng = np.random.default_rng(7)
    nf = 44
    field = np.zeros((cells, nf), np.float32)
    field[:, 20] = rng.uniform(0.1, 2.0, cells).astype(np.float32)
    with open(model_dir / "diffuse.bin", "wb") as fp:
        np.asarray([cells, nf], np.int32).tofile(fp)
        field.tofile(fp)
    # cellpackets > 0: the reference ties EMWEI to the CLPAC budget
    # (ASOC.py:238 disables USE_EMWEIGHT when CLPAC < 1)
    extra = ("diffuse  diffuse.bin\ndiffpack %d\ncellpackets 1024\n"
             "iterations 0\nnosolve\n" % (4 * cells))
    res0 = run_ini(model_dir, extra, bgpac=0)
    # skip=1: the field is a single-frequency delta, so the default
    # EMWEIGHT_SKIP=3 would (exactly like the reference) reuse a stale
    # all-zero allocation from a neighboring frequency and simulate
    # nothing at the populated channel
    resw = run_ini(model_dir, extra + "emweight 1 0 100 0 1\n", bgpac=0)
    assert resw.ctabs.sum() > 0
    np.testing.assert_allclose(resw.ctabs.sum(), res0.ctabs.sum(),
                               rtol=0.05)
    # default skip=3 reuses the stale zero allocation -- reference parity
    # of the staleness semantics (ASOC.py:1027,1277-1292)
    res_stale = run_ini(model_dir, extra + "emweight 1 0 100\n", bgpac=0)
    assert res_stale.ctabs.sum() == 0.0
    # clpac==0 disables the weighting entirely (ASOC.py:238): identical
    # to the unweighted run, packets and all
    res_gate = run_ini(model_dir,
                       "diffuse  diffuse.bin\ndiffpack %d\nnosolve\n"
                       "emweight 1 0 100 0 1\n" % (4 * cells), bgpac=0)
    assert res_gate.ctabs.sum() > 0


def test_fits_reference_naming(model_dir):
    """FITS mode writes one file per frequency named
    '<prefix>_<um>.fits' (single direction) with the (FITS_RA, FITS_DE)
    WCS centre and GL*MAP_DX/distance pixel scale (ASOC.py:3142-3147,
    ASOC_aux.py:299-305,1723-1748)."""
    import glob
    from soc_tpu.io.fits import read_fits_image

    res = run_ini(model_dir,
                  "mapum 250.0 500.0\ndistance 100.0\n"
                  "FITS 83.5 -5.4 orion\n")
    files = sorted(glob.glob(str(model_dir / "orion_*.fits")))
    assert len(files) == 2, files
    names = {os.path.basename(f) for f in files}
    assert names == {"orion_250.fits", "orion_500.fits"}
    data, hdr = read_fits_image(files[0])
    np.testing.assert_allclose(float(hdr["CRVAL1"]), 83.5)
    np.testing.assert_allclose(float(hdr["CRVAL2"]), -5.4)
    expect_pix = np.degrees(0.01 * 1.0 / 100.0)
    np.testing.assert_allclose(float(hdr["CDELT2"]), expect_pix,
                               rtol=1e-6)
    # plane content matches the binary map (planes follow ascending
    # frequency, i.e. descending wavelength: plane 0 = 500 um)
    want = {"orion_500.fits": 0, "orion_250.fits": 1}
    for f in files:
        d, _ = read_fits_image(f)
        np.testing.assert_allclose(
            np.asarray(d).squeeze(), res.maps[0][want[os.path.basename(f)]],
            rtol=1e-6)


def test_savetau_fits_companions(model_dir):
    """FITS mode adds the reference-named savetau companions:
    '<savetau>_tau_<um>.fits' and '<savetau>_colden.fits'
    (ASOC.py:3157-3170), alongside the binary files."""
    from soc_tpu.io.fits import read_fits_image
    res = run_ini(model_dir,
                  "savetau  taumap  250.0 -1.0\nFITS 10.0 -30.0\n")
    t, ht = read_fits_image(str(model_dir / "taumap_tau_250.fits"))
    c, hc = read_fits_image(str(model_dir / "taumap_colden.fits"))
    np.testing.assert_allclose(np.asarray(t).squeeze(),
                               res.maps[("savetau", 0, 0)], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(c).squeeze(),
                               res.maps[("savetau", 0, 1)], rtol=1e-6)
    assert float(ht["CRVAL1"]) == 10.0 and float(hc["CRVAL2"]) == -30.0
