"""Spatial domain decomposition: slab split + live ppermute halo exchange."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest

from soc_tpu.grid import uniform_grid, grid_from_arrays, decode_link_np, \
    encode_link_np
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.parallel.domain import split_grid_slabs, domain_background_run
from soc_tpu.parallel.mesh import make_mesh
from soc_tpu.transport.propagate import transport_run
from soc_tpu.transport.sources import stream_hi_base


def octree_grid(nx, ny, nz, refine_roots, seed=0):
    """Two-level test grid: listed root cells refined into octets."""
    rng = np.random.default_rng(seed)
    root = rng.uniform(0.5, 1.5, nx * ny * nz).astype(np.float32)
    child = []
    for j, r in enumerate(refine_roots):
        root[r] = encode_link_np(np.asarray([8 * j], np.int32))[0]
        child.extend(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    return grid_from_arrays(nx, ny, nz, [nx * ny * nz, len(child)],
                            [root, np.asarray(child, np.float32)])


def test_split_grid_slabs_partitions_cells():
    grid = octree_grid(4, 4, 8, refine_roots=[5, 40, 100])
    slabs = split_grid_slabs(grid, 4)
    assert slabs.n_slabs == 4 and slabs.nz_local == 2
    # every global cell appears exactly once across slabs
    gidx = slabs.gidx[slabs.gidx >= 0]
    assert len(gidx) == grid.cells
    assert len(np.unique(gidx)) == grid.cells
    # densities survive the renumbering: leaf values at mapped positions
    dens_g = np.asarray(grid.dens)
    for s in range(slabs.n_slabs):
        m = slabs.gidx[s] >= 0
        a = slabs.dens[s][m]
        b = dens_g[slabs.gidx[s][m]]
        leaf = b > 0
        np.testing.assert_array_equal(a[leaf], b[leaf])


@pytest.mark.parametrize("grid_kind", ["uniform", "octree"])
def test_domain_matches_single_device(grid_kind):
    """Slab-decomposed transport with halo exchange reproduces the
    single-grid tallies: same ids, same RNG streams, same physics; only
    boundary-epsilon geometry differs."""
    if grid_kind == "uniform":
        grid = uniform_grid(6, 6, 8, density=1.0)
    else:
        grid = octree_grid(6, 6, 8, refine_roots=[50, 130, 200])
    dsc, csc = hg_scattering_function([0.5], 128)
    physics = dict(kabs=jnp.float32(0.12), ksca=jnp.float32(0.22),
                   csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    n = 8 * (2 * (36 + 48 + 48))
    mesh = make_mesh(jax.devices(), freq_axis=1)      # dp = 8
    slabs = split_grid_slabs(grid, 8)
    tabs_d, esc_d, lost, _aux = domain_background_run(
        slabs, physics, jnp.float32(1.0), n, 7, mesh, nlanes=512)
    assert lost == 0.0            # pending queue never overflowed

    params = dict(photons=jnp.float32(1.0), ifreq=jnp.int32(0),
                  per_freq=jnp.int32(n),
                  hi_base=jnp.uint32(stream_hi_base("bg")))
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = jnp.zeros((1, 1), jnp.float32)
    tabs, _, esc, _ = transport_run(grid, physics, params, jnp.int32(n),
                                    tabs, intf, 7, source_kind="bg",
                                    nlanes=512)
    tabs = np.asarray(tabs)
    # totals agree tightly; per-cell a small set of packets may take an
    # epsilon-different path at slab boundaries
    assert abs(tabs_d.sum() - tabs.sum()) / tabs.sum() < 1e-3
    assert abs(esc_d - float(esc[0])) / float(esc[0]) < 1e-3
    good = np.isclose(tabs_d, tabs, rtol=1e-3, atol=1e-6)
    assert good.mean() > 0.98, f"only {good.mean():.3f} cells match"


@pytest.mark.parametrize("grid_kind", ["uniform", "octree"])
def test_domain_cell_emission_matches_single_device(grid_kind):
    """The iteration hot path (SimRAM_CL) under domain decomposition:
    per-slab cell ownership + halo exchange reproduces the single-grid
    cell-emission tallies packet for packet."""
    from soc_tpu.parallel.domain import domain_cell_emission_run
    if grid_kind == "uniform":
        grid = uniform_grid(6, 6, 8, density=1.0)
    else:
        grid = octree_grid(6, 6, 8, refine_roots=[50, 130, 200])
    dsc, csc = hg_scattering_function([0.5], 128)
    physics = dict(kabs=jnp.float32(0.12), ksca=jnp.float32(0.22),
                   csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    rng = np.random.default_rng(4)
    emit = rng.uniform(0.5, 1.5, grid.cells).astype(np.float32)
    emit[np.asarray(grid.dens) <= 0] = 0.0       # parent link cells
    per_cell = 4
    n = per_cell * grid.cells

    mesh = make_mesh(jax.devices(), freq_axis=1)      # dp = 8
    slabs = split_grid_slabs(grid, 8)
    tabs_d, esc_d, lost, _aux = domain_cell_emission_run(
        slabs, physics, emit, per_cell, 7, mesh, nlanes=512)
    assert lost == 0.0

    params = dict(emit=jnp.asarray(emit), per_cell=jnp.int32(per_cell),
                  ifreq=jnp.int32(0), per_freq=jnp.int32(n),
                  hi_base=jnp.uint32(stream_hi_base("cell")))
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = jnp.zeros((1, 1), jnp.float32)
    tabs, _, esc, _ = transport_run(grid, physics, params, jnp.int32(n),
                                    tabs, intf, 7, source_kind="cell",
                                    nlanes=512)
    tabs = np.asarray(tabs)
    assert abs(tabs_d.sum() - tabs.sum()) / tabs.sum() < 1e-3
    assert abs(esc_d - float(esc[0])) / float(esc[0]) < 1e-3
    good = np.isclose(tabs_d, tabs, rtol=1e-3, atol=1e-6)
    assert good.mean() > 0.98, f"only {good.mean():.3f} cells match"


def test_domains_keyword_end_to_end(tmp_path, socex):
    """`domains 8` in the ini runs the whole rt pipeline with Z-slab
    decomposition on the 8-device mesh and reproduces the single-device
    results (same packet ids and RNG streams)."""
    import shutil
    from soc_tpu.io.cloud import write_hierarchy
    from soc_tpu.pipeline import driver

    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    n = 8
    write_hierarchy(tmp_path / "tmp.cloud", n, n, n, [n ** 3],
                    [np.ones(n ** 3, np.float32)])
    base = """
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
cellpackets     {clpac}
iterations      1
noabsorbed
temperature     tmp.T
"""
    bgpac, clpac = 8 * 6 * n * n, 2 * n ** 3
    # a diffuse volume field exercises the third domain-decomposed source
    rng = np.random.default_rng(2)
    field = np.zeros((n ** 3, 44), np.float32)
    field[:, 20] = (1e-12 * rng.uniform(0.5, 1.5, n ** 3)).astype(np.float32)   # ~physical cgs scale: avoids f32 inf
    with open(tmp_path / "diffuse.bin", "wb") as fp:
        np.asarray([n ** 3, 44], np.int32).tofile(fp)
        field.tofile(fp)
    extra = "diffuse  diffuse.bin\ndiffpack %d\n" % (2 * n ** 3)
    # point source + healpix sky exercise the generic generator runner
    lps = (1e20 * np.ones(44, np.float32))
    lps.tofile(tmp_path / "ps.bin")
    extra += "pointsource 4.0 4.0 4.0 ps.bin\npspackets 4096\n"
    sky = np.tile(np.fromfile(tmp_path / "bg_intensity.bin",
                              np.float32)[:, None], (1, 12 * 64 * 64))
    sky.tofile(tmp_path / "sky.bin")
    extra += "hpbg sky.bin\n"
    (tmp_path / "plain.ini").write_text(base.format(bgpac=bgpac,
                                                    clpac=clpac) + extra)
    (tmp_path / "dom.ini").write_text(
        base.format(bgpac=bgpac, clpac=clpac) + extra + "domains 8\n")
    res_s = driver.run(str(tmp_path / "plain.ini"), lanes=1 << 10)
    res_d = driver.run(str(tmp_path / "dom.ini"), lanes=1 << 10)
    rel = abs(res_d.ctabs.sum() - res_s.ctabs.sum()) / res_s.ctabs.sum()
    assert rel < 1e-3
    good = np.isclose(res_d.temperature, res_s.temperature, rtol=2e-3)
    assert good.mean() > 0.98
    np.testing.assert_allclose(res_d.escaped.sum(), res_s.escaped.sum(),
                               rtol=1e-3)


@pytest.mark.parametrize("kind", ["ps", "hpbg"])
def test_domain_generator_sources_match_single_device(kind):
    """The generic Z-slab generator runner (point sources / healpix sky)
    reproduces the single-device tallies with the same RNG streams."""
    from soc_tpu.parallel.domain import domain_generator_run
    grid = octree_grid(6, 6, 8, refine_roots=[50, 130, 200])
    dsc, csc = hg_scattering_function([0.5], 128)
    physics = dict(kabs=jnp.float32(0.12), ksca=jnp.float32(0.22),
                   csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    if kind == "ps":
        # one internal + one external source (PS_METHOD 0 surface hits)
        params = dict(ps_pos=jnp.asarray([[3.0, 3.0, 2.0],
                                          [-4.0, 3.0, 4.0]], jnp.float32),
                      photons=jnp.asarray([1.0, 2.0], jnp.float32))
        n = 4096
    else:
        rng_np = np.random.default_rng(8)
        sky = rng_np.uniform(0.5, 1.5, 12 * 8 * 8).astype(np.float32)
        params = dict(hpbg=jnp.asarray(sky), cdf=None)
        n = 4096
    mesh = make_mesh(jax.devices(), freq_axis=1)
    slabs = split_grid_slabs(grid, 8)
    hi0 = stream_hi_base(kind)
    tabs_d, esc_d, lost, _aux = domain_generator_run(
        slabs, physics, kind, params, n, 7, mesh, nlanes=512, hi_base=hi0)
    assert lost == 0.0

    sparams = dict(params)
    sparams.update(ifreq=jnp.int32(0), per_freq=jnp.int32(n),
                   hi_base=jnp.uint32(hi0))
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = jnp.zeros((1, 1), jnp.float32)
    tabs, _, esc, _ = transport_run(grid, physics, sparams, jnp.int32(n),
                                    tabs, intf, 7, source_kind=kind,
                                    nlanes=512)
    tabs = np.asarray(tabs)
    assert tabs.sum() > 0
    assert abs(tabs_d.sum() - tabs.sum()) / tabs.sum() < 1e-3
    assert abs(esc_d - float(esc[0])) / max(float(esc[0]), 1e-9) < 1e-3
    # per-cell agreement: identical streams => the L1 deviation is pure
    # float32 summation-order noise (a point source piles thousands of
    # deposits into the near cells, so elementwise rtol is the wrong test)
    assert np.abs(tabs_d - tabs).sum() / tabs.sum() < 1e-3
    match = np.isclose(tabs_d, tabs, rtol=1e-3, atol=1e-6 * tabs.max())
    assert match.mean() > 0.95


def _write_base_model(tmp_path, socex, n=8, octree=False):
    import shutil
    from soc_tpu.io.cloud import write_hierarchy
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    if octree:
        rng = np.random.default_rng(0)
        root = rng.uniform(0.5, 1.0, n ** 3).astype(np.float32)
        centre = (n // 2) + n * (n // 2) + n * n * (n // 2)
        root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
        l1 = rng.uniform(2.0, 4.0, 8).astype(np.float32)
        write_hierarchy(tmp_path / "tmp.cloud", n, n, n, [n ** 3, 8],
                        [root, l1])
    else:
        write_hierarchy(tmp_path / "tmp.cloud", n, n, n, [n ** 3],
                        [np.ones(n ** 3, np.float32)])
    return """
gridlength      0.01
cloud           tmp.cloud
mapping         8 8 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc 2500
background      bg_intensity.bin
bgpackets       %d
cellpackets     %d
iterations      2
absorbed        absorbed.data
temperature     tmp.T
""" % (8 * 6 * n * n, 2 * n ** 3)


def _compare_domain_run(tmp_path, base, extra):
    from soc_tpu.pipeline import driver
    (tmp_path / "plain.ini").write_text(base + extra)
    (tmp_path / "dom.ini").write_text(base + extra + "domains 8\n")
    res_s = driver.run(str(tmp_path / "plain.ini"), lanes=1 << 10)
    res_d = driver.run(str(tmp_path / "dom.ini"), lanes=1 << 10)
    rel = abs(res_d.ctabs.sum() - res_s.ctabs.sum()) / res_s.ctabs.sum()
    assert rel < 2e-3
    good = np.isclose(res_d.temperature, res_s.temperature, rtol=3e-3)
    assert good.mean() > 0.97
    # per-frequency absorbed: the lifted `noabsorbed` restriction -- the
    # domain runner now carries the per-channel tally columns
    assert res_s.absorbed is not None and res_d.absorbed is not None
    s_col = res_s.absorbed.sum(axis=0)
    d_col = res_d.absorbed.sum(axis=0)
    m = s_col > 1e-3 * s_col.max()
    np.testing.assert_allclose(d_col[m], s_col[m], rtol=2e-2)
    return res_s, res_d


def test_domains_lifted_absorbed_ali_emweight_mirror(tmp_path, socex):
    """The round-2 `domains` exclusion list is gone: per-frequency
    absorption tallies, ALI self-absorption accounting, emission-weighted
    packet allocation and mirror boundaries all run Z-slab decomposed
    (the step physics is transport_run's own StepKit)."""
    base = _write_base_model(tmp_path, socex, octree=False)
    _compare_domain_run(tmp_path, base,
                        "ALI\nemweight 1 0 100\nmirror xX\n")


def test_domains_lifted_split_octree(tmp_path, socex):
    """Packet splitting at refinement boundaries under Z-slab domains."""
    base = _write_base_model(tmp_path, socex, octree=True)
    _compare_domain_run(tmp_path, base, "split\n")


def test_domains_diffuse_with_emweight(tmp_path, socex):
    """Phase-1 diffuse EMWEI under `domains N` (the Z-slab decomposition):
    the weighted cell_of_id source rides the same src_kw machinery as the
    phase-2 EMWEI and must match the single-device run."""
    import shutil
    from soc_tpu.io.cloud import write_hierarchy
    from soc_tpu.pipeline import driver
    n = 8
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    write_hierarchy(tmp_path / "tmp.cloud", n, n, n, [n ** 3],
                    [np.ones(n ** 3, np.float32)])
    cells = n ** 3
    rng = np.random.default_rng(3)
    field = np.zeros((cells, 44), np.float32)
    field[:, 20] = (1e-12 * rng.uniform(0.3, 1.8, cells)).astype(np.float32)
    with open(tmp_path / "diffuse.bin", "wb") as fp:
        np.asarray([cells, 44], np.int32).tofile(fp)
        field.tofile(fp)
    base = """
gridlength      0.01
cloud           tmp.cloud
nomap
density         3.0e4
seed            1.0
optical         tmp.dust
dsc             tmp.dsc 2500
background      bg_intensity.bin
bgpackets       0
cellpackets     1024
iterations      0
nosolve
diffuse         diffuse.bin
diffpack        {dfp}
emweight        1 0 100 0 1
"""
    (tmp_path / "plain.ini").write_text(base.format(dfp=4 * cells))
    (tmp_path / "dom.ini").write_text(base.format(dfp=4 * cells)
                                      + "domains 8\n")
    r1 = driver.run(str(tmp_path / "plain.ini"), lanes=1 << 10)
    rd = driver.run(str(tmp_path / "dom.ini"), lanes=1 << 10)
    assert r1.ctabs.sum() > 0
    np.testing.assert_allclose(rd.ctabs, r1.ctabs, rtol=1e-4,
                               atol=1e-3 * r1.ctabs.max())
    np.testing.assert_allclose(rd.escaped, r1.escaped, rtol=2e-4)
