"""Multi-dust orchestration: splitting + emission summation invariants."""

import numpy as np
import pytest

from soc_tpu.constants import PLANCK
from soc_tpu.pipeline import mabu
from soc_tpu.io.example import gset_dust, isrf_absorptions
from soc_tpu.solve import solver_prep


def test_split_conserves_total():
    """Sum over dusts of ABU_d * ABS_d == total ABS (constant abundance)."""
    rng = np.random.default_rng(0)
    cells, nfreq, nd = 50, 12, 3
    absorbed = rng.random((cells, nfreq)).astype(np.float32)
    rabs = rng.random((nfreq, nd)) + 0.01
    rabs /= rabs.sum(1)[:, None]
    abu = rng.random((cells, nd)).astype(np.float32) + 0.1
    total = np.zeros_like(absorbed)
    for d in range(nd):
        total += mabu.split_absorbed(absorbed, rabs, abu, d) * abu[:, d:d+1]
    np.testing.assert_allclose(total, absorbed, rtol=1e-5)


def test_eqdust_energy_balance():
    """Equilibrium eqdust solve: emitted energy == absorbed energy."""
    freq = np.logspace(11.5, 15, 30)
    kabs = 1e-21 * (freq / 1e12) ** 1.7
    rng = np.random.default_rng(1)
    absorbed = (1e3 * rng.random((20, 30)) * (freq / freq.max()) ** -1
                ).astype(np.float32)
    emit, t = mabu.solve_equilibrium_eqdust(kabs, freq, absorbed)
    assert np.all(t > 1.0) and np.all(t < 1600.0)
    for c in range(0, 20, 5):
        e_in = np.trapezoid(absorbed[c] * PLANCK * freq, freq)
        e_out = np.trapezoid(emit[c] * PLANCK * freq, freq)
        assert abs(e_out - e_in) / e_in < 0.03, (c, e_out, e_in)


def test_multi_dust_total_energy():
    """gset + eqdust mixture conserves total energy through the split."""
    dust = gset_dust()
    freq = np.logspace(11.3, 15.2, 40)
    sol = solver_prep.build_solver(dust, freq, ne=64)
    comps = [
        mabu.DustComponent(name="gs", kind="gset", kabs=sol.k_abs,
                           solver=sol),
        mabu.DustComponent(name="eq", kind="eqdust",
                           kabs=2.0 * sol.k_abs, freq=freq),
    ]
    absorbed = np.tile(isrf_absorptions(dust, freq), (6, 1))
    emitted = mabu.solve_emission_multi(comps, absorbed)
    e_in = np.trapezoid(absorbed[0] * PLANCK * freq, freq)
    e_out = np.trapezoid(emitted[0] * PLANCK * freq, freq)
    assert abs(e_out - e_in) / e_in < 0.1, (e_out, e_in)
    # abundance-weighted variant: zero abundance of one dust routes all
    # energy through the other
    abu = np.zeros((6, 2), np.float32)
    abu[:, 0] = 1.0
    emitted_g = mabu.solve_emission_multi(comps, absorbed, abu)
    e_out_g = np.trapezoid(emitted_g[0] * PLANCK * freq, freq)
    assert abs(e_out_g - e_in) / e_in < 0.1


def test_cr_heating_modes():
    """CR_HEATING 1/2/3: the extra heating raises equilibrium temperatures
    in cold cells; mode 2 heats more than mode 1; mode 3 scales with
    density."""
    from soc_tpu.pipeline.mabu import (DustComponent, cr_heating_channel,
                                       solve_emission_multi)
    rng = np.random.default_rng(4)
    freq = np.logspace(10.5, 15.5, 24)
    kabs = (freq / freq[-1]) ** 1.6 * 1e-21
    cells = 64
    dens = np.logspace(2, 7, cells).astype(np.float32)
    absorbed = rng.uniform(0.0, 1e-8, (cells, 24)).astype(np.float32)
    absorbed[:, -1] = 0.0     # the CR channel replaces this slot
    comp = [DustComponent(name="d", kind="eqdust", kabs=kabs, freq=freq)]
    e0 = solve_emission_multi(comp, absorbed)
    e1 = solve_emission_multi(comp, absorbed, cr_mode=1)
    e2 = solve_emission_multi(comp, absorbed, cr_mode=2)
    e3 = solve_emission_multi(comp, absorbed, cr_mode=3, dens=dens)
    # total emitted energy balances total heating: CR modes add energy
    assert e1.sum() > e0.sum()
    assert e2.sum() > e1.sum()
    assert e3.sum() > 0
    # mode 3 coupling grows with density (rate/H ~ n(H)) up to the point
    # where the ad hoc Tgas-Tdust difference vanishes (n >= 1e7)
    r = cr_heating_channel(3, dens, cells)
    assert r.max() > r[0] * 100
    assert r[-1] == 0.0
    # modes 1/2 are density-independent constants
    assert np.allclose(cr_heating_channel(1, None, cells),
                       1e-27 * 1e20)


def test_polarised_emission_gset():
    """`polarisation` keyword path for a stochastic dust: PEMITTED from
    aligned sizes a >= aalg -- full alignment reproduces EMITTED, an
    unreachable aalg gives zero (A2E_MABU.py:971-983 / A2E.py aalg)."""
    dust = gset_dust()
    freq = np.logspace(11.3, 15.2, 40)
    sol = solver_prep.build_solver(dust, freq, ne=64)
    comps = [mabu.DustComponent(name="gs", kind="gset", kabs=sol.k_abs,
                                solver=sol)]
    absorbed = np.tile(isrf_absorptions(dust, freq), (5, 1))
    cells = absorbed.shape[0]
    tiny = np.full(cells, 0.5 * sol.size_a.min(), np.float32)
    huge = np.full(cells, 10.0 * sol.size_a.max(), np.float32)
    e_all, p_all = mabu.solve_emission_multi(
        comps, absorbed, pol={0: ("aalg", tiny)})
    np.testing.assert_allclose(p_all, e_all, rtol=1e-5)
    e_none, p_none = mabu.solve_emission_multi(
        comps, absorbed, pol={0: ("aalg", huge)})
    np.testing.assert_allclose(e_none, e_all, rtol=1e-5)
    assert np.all(p_none == 0.0)
    # intermediate cutoff: strictly between the extremes
    mid = np.full(cells, np.exp(0.5 * (np.log(sol.size_a.min())
                                       + np.log(sol.size_a.max()))),
                  np.float32)
    _, p_mid = mabu.solve_emission_multi(comps, absorbed,
                                         pol={0: ("aalg", mid)})
    assert 0.0 < p_mid.sum() < p_all.sum()


def test_polarised_emission_eqdust_rfactor(tmp_path, monkeypatch):
    """eqdust `polarisation` path: PEMITTED = EMITTED * R(aalg, freq) with
    R interpolated from the .rpol table (A2E_MABU.py:615-637)."""
    from soc_tpu.config import RunConfig
    from soc_tpu.pipeline import full

    freq = np.logspace(11.5, 15, 30)
    kabs = 1e-21 * (freq / 1e12) ** 1.7
    comps = [mabu.DustComponent(name="eq", kind="eqdust", kabs=kabs,
                                freq=freq)]
    rng = np.random.default_rng(3)
    cells = 16
    absorbed = (1e3 * rng.random((cells, 30)) * (freq / freq.max()) ** -1
                ).astype(np.float32)
    # synthetic .rpol: R constant 0.25 over a size x frequency grid
    sizes = np.logspace(-7, -4, 8)
    tab = np.zeros((9, 5))
    tab[0, 1:] = np.logspace(11.0, 15.5, 4)
    tab[1:, 0] = sizes
    tab[1:, 1:] = 0.25
    monkeypatch.chdir(tmp_path)
    np.savetxt("eq.rpol", tab)
    aalg = np.full(cells, sizes[3], np.float32)
    (tmp_path / "eq.aalg").write_bytes(
        np.asarray([cells], np.float32).tobytes() + aalg.tobytes())
    cfg = RunConfig(text="polarisation eq.dust eq.aalg\n")
    pol = full.pol_specs(cfg, comps, freq, cells)
    assert pol is not None and pol[0][0] == "rfactor"
    emitted, pemitted = mabu.solve_emission_multi(comps, absorbed, pol=pol)
    np.testing.assert_allclose(pemitted, 0.25 * emitted, rtol=1e-5)
    # aalg below the table -> interp hits the table edge (still 0.25);
    # aalg above the size grid -> zero fill
    aalg_hi = np.full(cells, 1.0, np.float32)
    r_hi = full._rpol_factor("eq", freq, aalg_hi)
    assert np.all(r_hi == 0.0)


def test_eqsolve_cli(tmp_path, socex):
    """The eqsolve CLI mirrors EQ_solver.py (dust absorbed emitted [GPU],
    EQ_solver.py:10-17): equilibrium emission file + the raw-float32
    '<dust>.T' companion, consistent with solve_equilibrium_eqdust."""
    import shutil
    from soc_tpu.cli import main
    from soc_tpu.io.dust import read_simple_dust
    from soc_tpu.io.fields import (read_cell_frequency_array,
                                   write_cell_frequency_array)
    from soc_tpu.constants import PARSEC

    shutil.copy(socex / "tmp.dust", tmp_path / "tmp.dust")
    opt = read_simple_dust(str(tmp_path / "tmp.dust"), 1.0)
    nf = len(opt.freq)
    rng = np.random.default_rng(2)
    cells = 64
    absorbed = (1e-6 * rng.random((cells, nf))).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    rc = main(["eqsolve", str(tmp_path / "tmp.dust"),
               str(tmp_path / "abs.bin"), str(tmp_path / "emit.bin"),
               "1"])
    assert rc == 0
    out = read_cell_frequency_array(tmp_path / "emit.bin")
    kabs = np.asarray(opt.abs_gl, np.float64) / PARSEC
    ref, t_ref = mabu.solve_equilibrium_eqdust(kabs, opt.freq, absorbed)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    t = np.fromfile(tmp_path / "tmp.dust.T", np.float32)
    assert t.shape == (cells,)
    np.testing.assert_allclose(t, t_ref, rtol=1e-6)
    assert np.all((t > 1.0) & (t < 1600.0))
