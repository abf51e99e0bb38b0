"""Float64-oracle parity on the example workload (soc_tpu.io.example).

The reference's example is a 64^3 cloud with 44 frequencies. The
reference itself cannot run here (no OpenCL), so the MWC64X-emulated-
stream twin harness of test_rng_parity runs the full frequency grid of
the example at reduced packet count (mult=1: one cosine-law packet per
surface element per channel, full-surface coverage), once as the float64
oracle and once through the framework's float32 production geometry ops,
and the whole downstream chain is compared:

    per-channel absorption -> trapezoid-integrated TABS
    -> equilibrium temperature field (the driver's exact table + lookup)
    -> the 250 um orthographic map plane.

Quantile bounds follow the small-cloud parity tests; at 64^3 a handful
of float32 boundary-corner flips reroute individual packets (the
documented divergence tail), which the channel-summed TABS averages
down.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from soc_tpu.constants import PARSEC
from soc_tpu.io.cloud import read_cloud
from soc_tpu.io.dust import read_simple_dust, read_scattering_function
from soc_tpu.io.fields import read_background_intensity
from soc_tpu.solve import equilibrium
from soc_tpu.transport.medium import medium_from_optics

from test_rng_parity import _simulate


@pytest.fixture(scope="module")
def workload(socex):
    orig = os.getcwd()
    os.chdir(socex)
    try:
        from soc_tpu.config import RunConfig
        cfg = RunConfig("my.ini")
        grid = read_cloud(cfg.file_cloud, cfg.kdensity, cfg.max_levels)
        optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
        freq = optics[0].freq
        nfreq = len(freq)
        dsc, csc = read_scattering_function(cfg.file_scafunc[0], nfreq,
                                            2500)
        medium = medium_from_optics(optics, dsc, csc, freq)
        ibg = read_background_intensity(cfg.file_background, nfreq)
    finally:
        os.chdir(orig)

    abs_gl = np.asarray(medium.abs_gl, np.float64)
    sca_gl = np.asarray(medium.sca_gl, np.float64)
    cscn = np.asarray(medium.csc)
    tw = np.asarray(medium.tw, np.float64)
    # per-packet photon weight: the driver's bg normalization with the
    # twin's packets-per-surface-element factor (mult*batch = 1) in place
    # of the reference's 8*batch (driver.simulate_background,
    # ASOC.py:1060-1063) -- total injected energy matches the real run,
    # so TABS and the solved T land at the physical values
    from soc_tpu.constants import PLANCK
    w_pkt = (np.asarray(ibg, np.float64) * np.pi
             / (PLANCK * np.asarray(freq, np.float64)))

    cells = grid.cells
    tabs = {}
    esc = {}
    for use_ops in (False, True):
        acc = np.zeros(cells, np.float64)
        e_tot = 0.0
        for f in range(nfreq):
            t_f, e_f, _ = _simulate(
                grid, float(abs_gl[f]), float(sca_gl[f]), cscn[f],
                seed=1.0 + f, batch=1, use_ops=use_ops, mult=1)
            acc += (w_pkt[f] * tw[f]) * t_f
            e_tot += w_pkt[f] * tw[f] * e_f
        tabs[use_ops] = acc
        esc[use_ops] = e_tot

    return dict(cfg=cfg, grid=grid, medium=medium, optics=optics,
                freq=freq, tabs=tabs, esc=esc)


def test_socx_tabs_parity(workload):
    """Integrated TABS on the real workload: float32 production geometry
    vs the float64 oracle under identical reference RNG streams."""
    t_ref, t_ops = workload["tabs"][False], workload["tabs"][True]
    assert t_ref.sum() > 0
    np.testing.assert_allclose(t_ops.sum(), t_ref.sum(), rtol=1e-5)
    np.testing.assert_allclose(workload["esc"][True],
                               workload["esc"][False], rtol=1e-5)
    rel = np.abs(t_ops - t_ref) / np.maximum(t_ref, 1e-3 * t_ref.max())
    q99, mx = np.quantile(rel, 0.99), rel.max()
    # measured r5: q99 ~ 9e-5, max ~ 2e-2 (a handful of 44-channel cells
    # where one packet's corner flip rerouted it; the small-cloud bound
    # was 1e-4 / 5e-3 on single channels)
    assert q99 < 3e-4, q99
    assert mx < 5e-2, mx


def test_socx_temperature_parity(workload):
    """The solved equilibrium T field (the driver's exact table/lookup
    chain) agrees between the two TABS fields -- and lands at the
    physical 10-20 K of the externally heated example cloud."""
    cfg, grid = workload["cfg"], workload["grid"]
    freq, optics = workload["freq"], workload["optics"]
    table = equilibrium.build_temperature_table(freq, optics[0].abs_gl,
                                                cfg.gl)
    gl_cm = cfg.gl * PARSEC
    tt = {}
    for k in (False, True):
        tt[k] = np.asarray(equilibrium.solve_temperature(
            grid, table, jnp.asarray(workload["tabs"][k].astype(np.float32)),
            gl_cm))
    assert 8.0 < tt[False].min() < tt[False].max() < 25.0, \
        (tt[False].min(), tt[False].max())
    rel = np.abs(tt[True] - tt[False]) / tt[False]
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 5e-3, rel.max()
    workload["tt"] = tt


def test_socx_map_parity(workload):
    """One 250 um orthographic map plane rendered from each twin's
    emission field: per-pixel agreement closes the TABS -> T -> map
    chain on the real workload."""
    from soc_tpu.render.mapping import observer_basis, render_ortho
    cfg, grid = workload["cfg"], workload["grid"]
    freq, optics = workload["freq"], workload["optics"]
    medium = workload["medium"]
    gl_cm = cfg.gl * PARSEC
    if "tt" not in workload:       # independent of test ordering
        table = equilibrium.build_temperature_table(freq, optics[0].abs_gl,
                                                    cfg.gl)
        workload["tt"] = {
            k: np.asarray(equilibrium.solve_temperature(
                grid, table,
                jnp.asarray(workload["tabs"][k].astype(np.float32)), gl_cm))
            for k in (False, True)}
    f250 = int(np.argmin(np.abs(2.997924580e14 / freq - 250.0)))
    assert abs(2.997924580e14 / freq[f250] - 250.0) < 2.0
    ext = np.asarray([float(medium.abs_gl[f250]
                            + medium.sca_gl[f250])], np.float32)
    odir, ra, de = observer_basis(float(cfg.obs_theta[0]),
                                  float(cfg.obs_phi[0]))
    centre = (grid.nx / 2.0, grid.ny / 2.0, grid.nz / 2.0)
    planes = {}
    for k in (False, True):
        emit = np.asarray(equilibrium.emission(
            freq, optics[0].abs_gl,
            jnp.asarray(workload["tt"][k]), gl_cm))[:, f250:f250 + 1]
        phot, _, _ = render_ortho(
            grid, jnp.asarray(emit), jnp.asarray(ext), jnp.asarray(odir),
            jnp.asarray(ra), jnp.asarray(de),
            jnp.asarray(centre, jnp.float32), 1.0, (64, 64))
        planes[k] = np.asarray(phot)[0]
    assert planes[False].max() > 0
    rel = np.abs(planes[True] - planes[False]) \
        / np.maximum(planes[False], 1e-3 * planes[False].max())
    assert np.quantile(rel, 0.99) < 1e-3, np.quantile(rel, 0.99)
    assert rel.max() < 5e-3, rel.max()
