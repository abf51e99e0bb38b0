"""ASOCS-equivalent scattering pipeline: all source blocks + outputs.

Covers the reference source set (bg, point source, cell emission from the
emitted file, diffuse field) and both output modes (orthographic maps,
internal-observer healpix) through the ini-driven `scattering.run`.
"""

import shutil

import numpy as np
import pytest

from soc_tpu.pipeline import driver, scattering

N = 10

INI = """
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
emitted         emitted.data
simum           0.2 1.0
{extra}
"""


@pytest.fixture()
def model_dir(tmp_path, socex):
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    from soc_tpu.io.cloud import write_hierarchy
    write_hierarchy(tmp_path / "tmp.cloud", N, N, N, [N ** 3],
                    [np.ones(N ** 3, np.float32)])
    return tmp_path


def write_ini(model_dir, extra="", bgpac=None):
    ini = model_dir / "sca.ini"
    ini.write_text(INI.format(bgpac=8 * 6 * N * N if bgpac is None
                              else bgpac, extra=extra))
    return str(ini)


def test_bg_scattering_scaled_container(model_dir):
    ini = write_ini(model_dir)
    out = scattering.run(ini, nlanes=1 << 11)
    assert out.shape == (44, 1, 8, 8)
    with open(model_dir / "outcoming.socs", "rb") as fp:
        ny, nx, nf = np.fromfile(fp, np.int32, 3)
        ffreq = np.fromfile(fp, np.float32, nf)
        data = np.fromfile(fp, np.float32).reshape(nf, 1, ny, nx)
    assert (ny, nx, nf) == (8, 8, 44)
    assert np.all(np.diff(ffreq) > 0)      # frequency header, increasing
    # only the simum band (0.2-1 um) is simulated
    from soc_tpu.constants import um2f
    band = (ffreq >= um2f(1.0)) & (ffreq <= um2f(0.2))
    assert data[band].sum() > 0
    assert data[~band].sum() == 0
    # surface-brightness scaling applied (k ~ freq*1e23*h -> O(1e4) values)
    assert data.max() > 1.0


def test_cell_emission_scattering(model_dir):
    """SimRAM_CL source block: scattering of in-cloud emission read from
    the emitted file. Uses a synthetic emitted.data with power in one
    optical channel (where k_sca is significant; real dust emission peaks
    in the FIR where nothing scatters)."""
    from soc_tpu.constants import um2f
    from soc_tpu.io.dust import read_simple_dust
    from soc_tpu.io.fields import write_cell_frequency_array
    freq = read_simple_dust(str(model_dir / "tmp.dust"), 0.01).freq
    ich = int(np.argmin(np.abs(freq - um2f(0.55))))
    cells = N ** 3
    emitted = np.zeros((cells, 44), np.float32)
    emitted[:, ich] = 1.0e10
    write_cell_frequency_array(model_dir / "emitted.data", emitted)

    ini = write_ini(model_dir, extra="cellpackets %d\n" % (2 * cells),
                    bgpac=0)
    out = scattering.run(ini, nlanes=1 << 11)
    assert out[ich].sum() > 0
    assert out.sum() == pytest.approx(out[ich].sum())


def test_diffuse_scattering(model_dir):
    cells = N ** 3
    field = np.zeros((cells, 44), np.float32)
    field[:, 40] = 1.0                   # one high-frequency channel
    with open(model_dir / "diffuse.bin", "wb") as fp:
        np.asarray([cells, 44], np.int32).tofile(fp)
        field.tofile(fp)
    ini = write_ini(model_dir,
                    extra="diffuse  diffuse.bin\ndiffpack %d\n" % (2 * cells),
                    bgpac=0)
    ini2 = model_dir / "sca3.ini"
    ini2.write_text(open(ini).read().replace("simum           0.2 1.0", ""))
    out = scattering.run(str(ini2), nlanes=1 << 11)
    assert out[40].sum() > 0
    assert out.sum() == pytest.approx(out[40].sum())


def test_internal_observer_healpix(model_dir):
    ini = write_ini(model_dir,
                    extra="perspective  5.0 5.0 5.0\noutnside  8\n")
    out = scattering.run(ini, nlanes=1 << 11)
    assert out.shape == (44, 12 * 8 * 8)
    assert out.sum() > 0
    with open(model_dir / "outcoming.socs", "rb") as fp:
        nside, nf = np.fromfile(fp, np.int32, 2)
    assert (nside, nf) == (8, 44)


def test_roi_load_scattering(model_dir):
    """ROI boundary source in a scattering run (ASOCS II==3)."""
    # make a roi photon file with everything in one optical channel
    from soc_tpu.transport.roi import write_roi_file, roi_nelem
    rnx = rny = rnz = N
    nside = 2
    nelem = roi_nelem(rnx, rny, rnz)
    data = np.zeros((44, nelem * 12 * nside * nside), np.float32)
    data[40] = 1.0
    write_roi_file(model_dir / "roi.photons", rnx, rny, rnz, nside, data)
    ini = write_ini(model_dir,
                    extra="roiload roi.photons 1.0\nroipackets 30000\n",
                    bgpac=0)
    ini2 = model_dir / "sca4.ini"
    ini2.write_text(open(ini).read().replace("simum           0.2 1.0", ""))
    out = scattering.run(str(ini2), nlanes=1 << 11)
    assert out[40].sum() > 0
    assert out.sum() == pytest.approx(out[40].sum())


def test_fits_scattering_output(model_dir):
    """`fits 1` + one direction: the scattered-light image is written as
    '<file_scattering>.fits' instead of the binary container
    (ASOCS.py:387-392, 892; `scatter` keyword = output name stem)."""
    from soc_tpu.io.fits import read_fits_image
    ini = write_ini(model_dir, extra="fits 1\nscattering scat\n"
                                     "distance 100.0\n")
    out = scattering.run(ini, nlanes=1 << 11)
    assert not (model_dir / "outcoming.socs").exists()
    data, hdr = read_fits_image(str(model_dir / "scat.fits"))
    np.testing.assert_allclose(data, out[:, 0], rtol=1e-6)


def test_hpbg_projected_area_weighting():
    """Scattered-light healpix sky: per-pixel weights carry the cloud's
    projected area toward that pixel (the reference launches packets at a
    bounding sphere so per-direction flux ~ A_proj; the face-entry
    sampler must fold A_proj/(AREA/4) into the weight)."""
    from soc_tpu.grid import uniform_grid
    from soc_tpu.pipeline.scattering import _hpbg_projected_area
    g = uniform_grid(16, 4, 4)
    w = _hpbg_projected_area(g, 12 * 16 * 16)
    # isotropic mean == 1 (healpix pixels are equal-area)
    np.testing.assert_allclose(w.mean(), 1.0, rtol=1e-3)
    # a pixel looking along +-X sees the small 4x4 face; one along +-Z
    # sees the long 16x4 face: ratio 4 (up to the diagonal contributions)
    assert w.max() / w.min() > 2.0
    # cubic cloud: anisotropy only from the diagonal terms
    wc = _hpbg_projected_area(uniform_grid(8, 8, 8), 12 * 16 * 16)
    np.testing.assert_allclose(wc.mean(), 1.0, rtol=1e-3)
    assert wc.max() / wc.min() < np.sqrt(3) + 0.01


def test_cell_emission_ffs_thin_channel(model_dir):
    """SimRAM_CL honors the FFS flag (kernel_ASOC_sca.c:1229): on an
    optically thin channel forced first scattering keeps every emission
    packet, without it nearly all escape unscattered."""
    from soc_tpu.constants import um2f
    from soc_tpu.io.fields import write_cell_frequency_array
    cells = N ** 3
    emitted = np.zeros((cells, 44), np.float32)
    # put power in a NEAR-IR channel where k_sca is tiny but nonzero
    emitted[:, 30] = 1e4
    write_cell_frequency_array(str(model_dir / "emitted.data"), emitted)
    ini = write_ini(model_dir, bgpac=0,
                    extra="cellpackets %d\nffs 1\nsimum 0.5 5.0\n" % cells)
    out_ffs = scattering.run(ini, nlanes=1 << 11)
    ini2 = write_ini(model_dir, bgpac=0,
                     extra="cellpackets %d\nffs 0\nsimum 0.5 5.0\n" % cells)
    out_noffs = scattering.run(ini2, nlanes=1 << 11)
    assert out_ffs[30].sum() > 0
    # FFS produces a vastly better-sampled (here: strictly larger-count)
    # signal; without it the thin channel catches almost nothing
    assert (out_noffs[30].sum() == 0
            or out_ffs[30].sum() > out_noffs[30].sum())


def test_devices_sharded_scattering_matches(model_dir):
    """`devices 8` in the scattering ini runs each channel's transport +
    peel-off sharded over the dp mesh (budget split by global id range)
    and reproduces the single-device maps allclose."""
    ini = write_ini(model_dir)
    out1 = scattering.run(ini, nlanes=1 << 11)
    ini8 = model_dir / "sca8.ini"
    ini8.write_text(open(ini).read() + "devices 8\n")
    out8 = scattering.run(str(ini8), nlanes=1 << 11)
    assert out1.sum() > 0
    np.testing.assert_allclose(out8, out1, rtol=2e-4,
                               atol=1e-6 * abs(out1).max())


def test_devices_sharded_scattering_healpix(model_dir):
    """Sharded internal-observer (healpix) scattered light."""
    extra = "perspective 5.0 5.0 5.0\noutnside 8\n"
    ini = write_ini(model_dir, extra)
    out1 = scattering.run(ini, nlanes=1 << 11)
    ini8 = model_dir / "sca8.ini"
    ini8.write_text(open(ini).read() + "devices 8\n")
    out8 = scattering.run(str(ini8), nlanes=1 << 11)
    assert out1.sum() > 0
    np.testing.assert_allclose(out8, out1, rtol=2e-4,
                               atol=1e-6 * abs(out1).max())
