"""I/O codec round-trips + parity with the reference's on-disk formats."""

import numpy as np

from soc_tpu.grid import encode_link_np, decode_link_np, uniform_grid
from soc_tpu.io.cloud import (read_cloud, read_hierarchy, write_hierarchy,
                              write_cell_field)
from soc_tpu.io.dust import (read_simple_dust, write_simple_dust,
                             hg_scattering_function,
                             read_scattering_function,
                             write_scattering_function)
from soc_tpu.io.fields import (read_cell_frequency_array,
                               write_cell_frequency_array,
                               read_map_file, write_map_file)


def test_link_codec_roundtrip():
    idx = np.asarray([0, 8, 16, 123456, 2**30], np.int32)
    assert np.array_equal(decode_link_np(encode_link_np(idx)), idx)
    # links must read as <= 0 densities
    assert np.all(encode_link_np(idx[1:]) < 0)


def test_cloud_roundtrip_regular(tmp_path):
    path = tmp_path / "tmp.cloud"
    n = 8
    vals = np.arange(1, n**3 + 1, dtype=np.float32)
    write_hierarchy(path, n, n, n, [n**3], [vals])
    grid = read_cloud(path)
    assert (grid.nx, grid.ny, grid.nz) == (n, n, n)
    assert grid.levels == 1 and grid.cells == n**3
    np.testing.assert_array_equal(np.asarray(grid.dens), vals)


def test_cloud_roundtrip_octree(tmp_path):
    # 2x2x2 root where cell 0 is refined into one octet
    path = tmp_path / "oct.cloud"
    root = np.ones(8, np.float32)
    root[0] = encode_link_np([0])[0]          # link to first child octet
    children = np.full(8, 2.0, np.float32)
    write_hierarchy(path, 2, 2, 2, [8, 8], [root, children])
    grid = read_cloud(path, kdensity=3.0)
    assert grid.levels == 2 and grid.cells == 16
    dens = np.asarray(grid.dens)
    # link preserved, not scaled: child index 0 encodes as -0.0 (non-leaf)
    assert not (dens[0] > 0) and np.signbit(dens[0])
    np.testing.assert_allclose(dens[1:8], 3.0)
    np.testing.assert_allclose(dens[8:], 6.0)
    par = np.asarray(grid.par)
    np.testing.assert_array_equal(par[8:], np.zeros(8, np.int32))
    np.testing.assert_array_equal(par[:8], -np.ones(8, np.int32))


def test_cell_field_write_matches_reference_layout(tmp_path):
    grid = uniform_grid(4, 4, 4)
    temps = np.linspace(10, 20, 64).astype(np.float32)
    path = tmp_path / "tmp.T"
    write_cell_field(path, grid, temps)
    with open(path, "rb") as fp:
        hdr = np.fromfile(fp, np.int32, 6)
        data = np.fromfile(fp, np.float32)
    np.testing.assert_array_equal(hdr, [4, 4, 4, 1, 64, 64])
    np.testing.assert_array_equal(data, temps)


def test_simple_dust_roundtrip(tmp_path):
    freq = np.logspace(11, 15, 10)
    g = np.linspace(0, 0.6, 10).astype(np.float32)
    from soc_tpu.io.dust import DustOptics
    from soc_tpu.constants import PARSEC
    coeff = 3.0 * np.pi * 1e-5**2 * 0.01 * PARSEC
    opt = DustOptics(freq=freq, g=g,
                     abs_gl=(1e-3 * np.ones(10) * coeff).astype(np.float32),
                     sca_gl=(2e-3 * np.ones(10) * coeff).astype(np.float32),
                     grain_density=3.0, grain_size=1e-5)
    path = tmp_path / "t.dust"
    write_simple_dust(path, opt, gl_pc=0.01)
    opt2 = read_simple_dust(path, gl_pc=0.01)
    np.testing.assert_allclose(opt2.abs_gl, opt.abs_gl, rtol=1e-4)
    np.testing.assert_allclose(opt2.sca_gl, opt.sca_gl, rtol=1e-4)
    np.testing.assert_allclose(opt2.g, g, atol=1e-5)


def test_dsc_roundtrip(tmp_path):
    dsc, csc = hg_scattering_function([0.0, 0.3, 0.65], bins=100)
    path = tmp_path / "t.dsc"
    write_scattering_function(path, dsc, csc)
    dsc2, csc2 = read_scattering_function(path, 3, 100)
    np.testing.assert_array_equal(dsc2, dsc)
    np.testing.assert_array_equal(csc2, csc)
    # CSC must be an increasing cos-theta lookup in [-1, 1]
    assert np.all(np.diff(csc, axis=1) >= -1e-6)
    assert csc.min() >= -1.0 and csc.max() <= 1.0


def test_hg_inverse_cdf_statistics():
    g = 0.5
    _, csc = hg_scattering_function([g], bins=10000)
    # mean of cos theta sampled from HG equals g
    assert abs(csc.mean() - g) < 1e-3


def test_cell_frequency_array_roundtrip(tmp_path):
    data = np.random.default_rng(0).random((100, 7)).astype(np.float32)
    path = tmp_path / "absorbed.data"
    write_cell_frequency_array(path, data)
    out = read_cell_frequency_array(path)
    np.testing.assert_array_equal(out, data)


def test_map_file_roundtrip(tmp_path):
    maps = np.random.default_rng(0).random((5, 16, 12)).astype(np.float32)
    path = tmp_path / "map_dir_00.bin"
    write_map_file(path, maps)
    out = read_map_file(path, 5)
    np.testing.assert_array_equal(out, maps)


def test_reference_example_files_parse(socex):
    """Parse the generated example inputs in the reference formats."""
    opt = read_simple_dust(socex / "tmp.dust", gl_pc=0.01)
    assert opt.nfreq == 44
    dsc, csc = read_scattering_function(socex / "tmp.dsc", 44, 2500)
    assert dsc.shape == (44, 2500)
    from soc_tpu.io.fields import read_background_intensity
    ibg = read_background_intensity(socex / "bg_intensity.bin", 44)
    assert np.all(ibg > 0)
