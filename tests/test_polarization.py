"""Polarization maps: Stokes geometry invariants."""

import numpy as np
import jax.numpy as jnp
import pytest

from soc_tpu.grid import uniform_grid
from soc_tpu.render.polarization import render_pol
from soc_tpu.render.mapping import observer_basis


def make_setup(nx=8, b_vector=(0.0, 1.0, 0.0)):
    grid = uniform_grid(nx, nx, nx, density=1.0)
    emit = jnp.ones((grid.cells, 1), jnp.float32)
    ext = jnp.asarray([1e-4], jnp.float32)
    b = jnp.broadcast_to(jnp.asarray(b_vector, jnp.float32),
                         (grid.cells, 3))
    odir, ra, de = observer_basis(0.0, 0.0)   # observer at +Z, LOS = -Z
    centre = (nx / 2, nx / 2, nx / 2)
    return grid, emit, ext, b, (jnp.asarray(odir), jnp.asarray(ra),
                                jnp.asarray(de)), centre


def run(bvec, p0=0.2, nx=8):
    grid, emit, ext, b, (odir, ra, de), centre = make_setup(nx, bvec)
    i, q, u, colden = render_pol(grid, emit, ext, b, p0, odir, ra, de,
                                 centre, 1.0, (nx, nx))
    c = nx // 2
    return (float(i[0, c, c]), float(q[0, c, c]), float(u[0, c, c]),
            np.asarray(colden))


def test_colden():
    _, _, _, colden = run((0.0, 1.0, 0.0))
    np.testing.assert_allclose(colden, 8.0, rtol=1e-3)


def test_b_along_los_unpolarized():
    """B parallel to the LOS (+Z): cos^2 gamma ~ 0 -> Q = U ~ 0 and
    I enhanced by p0*2/3."""
    i, q, u, _ = run((0.0, 0.0, 1.0))
    assert abs(q) < 2e-5 * i and abs(u) < 2e-5 * i
    i0, q0, u0, _ = run((0.0, 0.0, 1.0), p0=0.0)
    np.testing.assert_allclose(i / i0, 1.0 + 0.2 * (2.0 / 3.0), rtol=1e-3)


def test_b_in_plane_max_polarization():
    """B in the plane of the sky: cos^2 gamma ~ 1, polarized fraction and
    angle follow the projected field orientation."""
    # observer at +Z: DE = +Y(ish)? use the basis directly
    grid, emit, ext, b, (odir, ra, de), centre = make_setup(8, (0, 1, 0))
    # b along the DE axis: Psi = pi/2 => Q = -p*sz, U = 0
    bvec = np.asarray(de)
    i, q, u, _ = run(tuple(bvec))
    p_frac = np.hypot(q, u) / i
    assert p_frac > 0.15                       # p0=0.2 reduced by I-term
    assert abs(u) < 2e-4 * abs(q)
    assert q < 0                               # Psi=pi/2: cos(2Psi) = -1

    # b along the RA axis: Psi = pi => Q = +p*sz
    bvec = np.asarray(ra)
    i2, q2, u2, _ = run(tuple(bvec))
    assert q2 > 0
    assert abs(u2) < 2e-4 * abs(q2)


def test_rotating_b_rotates_stokes_vector():
    """Rotating B in the sky plane by angle a rotates (Q,U) by 2a."""
    grid, emit, ext, b, (odir, ra, de), centre = make_setup(8, (0, 1, 0))
    ra_np, de_np = np.asarray(ra), np.asarray(de)
    angles = [0.0, np.pi / 6, np.pi / 4, np.pi / 3]
    chis = []
    for a in angles:
        bvec = np.cos(a) * de_np + np.sin(a) * ra_np
        i, q, u, _ = run(tuple(bvec))
        chis.append(0.5 * np.arctan2(u, q))
    dchi = np.diff(np.unwrap(np.asarray(chis) * 2.0)) / 2.0
    np.testing.assert_allclose(np.abs(dchi), np.diff(angles), atol=0.01)


def test_polstat_uniform_field():
    """Uniform B: zero angle dispersion; <|B|> equals the field strength;
    B_LOS/B_POS split follows the geometry."""
    from soc_tpu.render.polarization import render_polstat
    import jax.numpy as jnp
    nx = 8
    grid, emit, ext, b, (odir, ra, de), centre = make_setup(nx, (0, 3.0, 4.0))
    out = render_polstat(grid, emit, ext, b, odir, ra, de, centre, 1.0,
                         (nx, nx))
    c = nx // 2
    assert abs(float(out["rT"][c, c])) < 1e-3
    np.testing.assert_allclose(float(out["B"][c, c]), 5.0, rtol=1e-4)
    # observer at +Z: B=(0,3,4): LOS component 4, plane-of-sky 3
    np.testing.assert_allclose(float(out["B_LOS"][c, c]), 4.0, rtol=1e-3)
    np.testing.assert_allclose(float(out["B_POS"][c, c]), 3.0, rtol=1e-3)
    np.testing.assert_allclose(float(out["colden"][c, c]), nx, rtol=1e-3)


def test_polstat_tangled_field_disperses():
    from soc_tpu.render.polarization import render_polstat
    import jax.numpy as jnp
    nx = 8
    grid, emit, ext, _, (odir, ra, de), centre = make_setup(nx)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=(grid.cells, 3)).astype(np.float32))
    out = render_polstat(grid, emit, ext, b, odir, ra, de, centre, 1.0,
                         (nx, nx))
    assert float(np.asarray(out["rT"]).mean()) > 0.3


def test_pol_healpix_internal_observer():
    """All-sky Stokes maps around an internal observer: uniform B along +Z
    gives Q/U patterns bounded by p0*I; total I positive."""
    import jax.numpy as jnp
    from soc_tpu.grid import uniform_grid
    from soc_tpu.render.polarization import render_pol_healpix
    n = 8
    grid = uniform_grid(n, n, n, density=1.0)
    nf = 2
    emit = jnp.ones((grid.cells, nf), jnp.float32)
    ext = jnp.full(nf, 0.01, jnp.float32)
    bfield = jnp.asarray(
        np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (grid.cells, 1)))
    s_i, s_q, s_u, colden = render_pol_healpix(
        grid, emit, ext, bfield, 0.2, (n / 2, n / 2, n / 2), 4)
    s_i, s_q, s_u = np.asarray(s_i), np.asarray(s_q), np.asarray(s_u)
    assert s_i.shape == (nf, 12 * 16)
    assert np.all(s_i > 0)
    # polarized fraction bounded by p0 (geometry factors <= 1)
    pfrac = np.sqrt(s_q**2 + s_u**2) / s_i
    assert pfrac.max() <= 0.25
    # looking along +/-Z (B parallel to LOS): no polarized signal
    north = np.asarray(colden)[:4]          # first RING pixels ~ +Z
    assert np.abs(s_q[:, :4]).max() < 2e-2 * s_i.max()


def test_polstat2_replication(tmp_path, socex):
    """POLSTAT 2 through the driver: periodic replication grows I with
    maxlos while plain POLSTAT 0 does not."""
    import shutil
    from soc_tpu.io.cloud import write_hierarchy
    from soc_tpu.pipeline import driver
    n = 8
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    cells = n ** 3
    write_hierarchy(tmp_path / "tmp.cloud", n, n, n, [cells],
                    [np.ones(cells, np.float32)])
    for name, val in (("Bx", 0.0), ("By", 0.0), ("Bz", 1.0)):
        write_hierarchy(tmp_path / (name + ".bin"), n, n, n, [cells],
                        [np.full(cells, val, np.float32)])
    base = """
gridlength 0.01
cloud tmp.cloud
mapping 8 8 1.0
density 3.0e4
seed 1.0
directions 90.0 0.0
optical tmp.dust
dsc tmp.dsc 2500
background bg_intensity.bin
bgpackets {bg}
iterations 1
noabsorbed
polmap Bx.bin By.bin Bz.bin 0 {maxlos}
polstat {ps}
"""
    (tmp_path / "a.ini").write_text(base.format(bg=8 * 6 * n * n,
                                                maxlos=3.0 * n, ps=0))
    (tmp_path / "b.ini").write_text(base.format(bg=8 * 6 * n * n,
                                                maxlos=3.0 * n, ps=2))
    ra = driver.run(str(tmp_path / "a.ini"), lanes=1 << 10)
    rb = driver.run(str(tmp_path / "b.ini"), lanes=1 << 10)
    ia = ra.maps[("pol", 0)][0]
    ib = rb.maps[("pol", 0)][0]
    # replicated LOS is ~3x longer -> substantially more integrated I
    assert ib.sum() > 2.0 * ia.sum()


def test_minlos_maxlos_window():
    """`polmap .. minlos maxlos` limits the registered LOS interval: on a
    uniform optically-thin cube, I is proportional to the window length and
    colden starts at minlos (kernel_ASOC_map_H.c:776,743)."""
    nx = 8
    grid, emit, ext, b, (odir, ra, de), centre = make_setup(nx)
    full = render_pol(grid, emit, ext, b, 0.2, odir, ra, de, centre, 1.0,
                      (nx, nx))
    half = render_pol(grid, emit, ext, b, 0.2, odir, ra, de, centre, 1.0,
                      (nx, nx), minlos=2.0, maxlos=6.0)
    c = nx // 2
    # optically thin: I scales with the registered path length (4 of 8)
    ratio = float(half[0][0, c, c]) / float(full[0][0, c, c])
    np.testing.assert_allclose(ratio, 0.5, rtol=0.02)
    # colden counts from minlos to the (terminated) ray end
    np.testing.assert_allclose(np.asarray(half[3])[c, c], 4.0, rtol=0.02)
    # window outside the cube registers nothing
    none = render_pol(grid, emit, ext, b, 0.2, odir, ra, de, centre, 1.0,
                      (nx, nx), minlos=100.0)
    assert float(none[0].max()) == 0.0


def test_pol_healpix_interpolation():
    """`interpolation` smoothing in the all-sky polarization map: exact on
    a uniform cloud, different-but-conserving on a gradient."""
    import jax.numpy as jnp
    from soc_tpu.render.polarization import render_pol_healpix
    n = 8
    emit = jnp.ones((n ** 3, 2), jnp.float32)
    ext = jnp.asarray([0.05, 0.1], jnp.float32)
    b = jnp.tile(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n ** 3, 1))
    obs = jnp.asarray([4.0, 4.0, 4.0], jnp.float32)
    from soc_tpu.grid import grid_from_arrays
    g_uni = uniform_grid(n, n, n)
    i0, q0, u0, c0 = render_pol_healpix(g_uni, emit, ext, b, 0.2, obs, 2)
    for mode in (1, 2, 3):
        i1, q1, u1, c1 = render_pol_healpix(g_uni, emit, ext, b, 0.2, obs,
                                            2, interpolate=mode)
        np.testing.assert_allclose(np.asarray(i1), np.asarray(i0),
                                   rtol=1e-4)
    grad = np.linspace(0.5, 2.0, n ** 3).astype(np.float32)
    g_grad = grid_from_arrays(n, n, n, [n ** 3], [grad])
    gi0, _, _, _ = render_pol_healpix(g_grad, emit, ext, b, 0.2, obs, 2)
    gi1, _, _, _ = render_pol_healpix(g_grad, emit, ext, b, 0.2, obs, 2,
                                      interpolate=2)
    assert not np.allclose(np.asarray(gi1), np.asarray(gi0))
    assert abs(np.asarray(gi1).sum() / np.asarray(gi0).sum() - 1.0) < 0.05


def test_pol_healpix_angle_matches_projection():
    """The Q/U position angle at every pixel must equal the angle of B
    projected on the plane PERPENDICULAR to that pixel's line of sight
    (the round-2 basis took DE from the un-negated spherical direction,
    so DE.LOS = sin 2theta and mid-latitude angles were wrong)."""
    import jax.numpy as jnp
    from soc_tpu.grid import uniform_grid
    from soc_tpu.render import healpix as hp
    from soc_tpu.render.polarization import render_pol_healpix
    n = 8
    nside = 4
    grid = uniform_grid(n, n, n, density=1.0)
    emit = jnp.ones((grid.cells, 1), jnp.float32)
    ext = jnp.full(1, 0.01, jnp.float32)
    bvec = np.asarray([0.8, -0.5, 0.6], np.float32)
    bfield = jnp.asarray(np.tile(bvec / np.linalg.norm(bvec),
                                 (grid.cells, 1)))
    s_i, s_q, s_u, _ = render_pol_healpix(
        grid, emit, ext, bfield, 0.2, (n / 2, n / 2, n / 2), nside)
    s_q = np.asarray(s_q)[0]
    s_u = np.asarray(s_u)[0]
    npix = 12 * nside * nside
    theta, phi = (np.asarray(a) for a in
                  hp.pix2ang_ring(nside, jnp.arange(npix)))
    los = np.stack([-np.sin(theta) * np.cos(phi),
                    -np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    # orthonormal sky basis per pixel: north / east for this LOS
    north = np.stack([np.cos(theta) * np.cos(phi),
                      np.cos(theta) * np.sin(phi), np.sin(theta)], -1)
    east = np.stack([np.sin(phi), -np.cos(phi), np.zeros_like(phi)], -1)
    b = bvec / np.linalg.norm(bvec)
    # uniform B, uniform cloud: expected psi identical along the whole LOS
    psi = 0.5 * np.pi + np.arctan2(-(east @ b), north @ b)
    q_exp = np.cos(2 * psi)
    u_exp = np.sin(2 * psi)
    # compare angles where the polarized signal is significant
    amp = np.hypot(s_q, s_u)
    m = amp > 0.2 * amp.max()
    ang_map = 0.5 * np.arctan2(s_u[m], s_q[m])
    ang_exp = 0.5 * np.arctan2(u_exp[m], q_exp[m])
    d = np.angle(np.exp(2j * (ang_map - ang_exp))) / 2   # mod pi distance
    assert np.abs(d).max() < 1e-3, np.abs(d).max()
    # basis sanity on the renderer's own output: B || z must give U = 0
    bz = jnp.asarray(np.tile(np.asarray([0, 0, 1], np.float32),
                             (grid.cells, 1)))
    _, qz, uz, _ = render_pol_healpix(
        grid, emit, ext, bz, 0.2, (n / 2, n / 2, n / 2), nside)
    assert np.abs(np.asarray(uz)).max() < 1e-5 * np.abs(qz).max()
