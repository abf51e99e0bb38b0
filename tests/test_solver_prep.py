"""A2E_pre solver generation: physics validation on a synthetic grain model.

Validation strategy (no runnable reference here): the thermal-continuous
stochastic solution of a LARGE grain in a steady radiation field must
converge to the equilibrium-temperature solution -- total emitted energy
equals total absorbed energy, and the spectrum peaks at the equilibrium T.
"""

import numpy as np
import pytest

from soc_tpu.constants import PLANCK
from soc_tpu.io.example import gset_dust, isrf_absorptions
from soc_tpu.solve import solver_prep, stochastic
from soc_tpu.solve.solver_file import write_solver, read_solver


@pytest.fixture(scope="module")
def solver():
    dust = gset_dust()
    freq = np.logspace(11.3, 15.2, 40)
    return dust, freq, solver_prep.build_solver(dust, freq, ne=128)


def test_tdown_positive_increasing(solver):
    dust, freq, sol = solver
    for sd in sol.sizes:
        assert sd.tdown[0] == 0.0
        assert np.all(sd.tdown[1:] > 0)
        # cooling rates rise with energy (the growth factor depends on the
        # enthalpy-grid spacing; only monotone trend is universal)
        assert sd.tdown[-1] > 2.0 * sd.tdown[1]


def test_weights_structure(solver):
    dust, freq, sol = solver
    for sd in sol.sizes:
        assert np.all(sd.iw >= 0)
        valid = sd.l1 >= 0
        assert valid.sum() > 0
        # stream length matches the L1/L2 ranges
        lens = np.where(valid, sd.l2 - sd.l1 + 1, 0)
        assert lens.sum() == len(sd.iw)


def test_solver_file_roundtrip_through_disk(tmp_path, solver):
    dust, freq, sol = solver
    path = tmp_path / "synth.solver"
    write_solver(path, sol)
    sol2 = read_solver(path)
    np.testing.assert_allclose(sol2.sk_abs, sol.sk_abs, rtol=1e-6)
    np.testing.assert_array_equal(sol2.sizes[0].iw, sol.sizes[0].iw)


def test_energy_balance_stochastic(solver):
    """Steady state: emitted energy == absorbed energy, per size."""
    dust, freq, sol = solver
    absorbed = isrf_absorptions(dust, freq)[None, :].repeat(4, axis=0)
    emitted = stochastic.solve_emission(sol, absorbed, clip_last=False)
    # energy in = integral ABS_tot * AF... per H: sum over sizes is total
    e_in = np.trapezoid(absorbed[0] * PLANCK * freq, freq)
    e_out = np.trapezoid(emitted[0] * PLANCK * freq, freq)
    assert abs(e_out - e_in) / e_in < 0.08, (e_out, e_in)


def test_large_grain_matches_equilibrium(solver):
    """In a strong field (absorption rate >> cooling cascade rate) the big
    grain's stochastic solution must converge to the equilibrium-temperature
    spectrum (thermal-continuous limit)."""
    dust, freq, sol = solver
    absorbed = isrf_absorptions(dust, freq, scale=1e6)[None, :]
    w_flat, tdown, ea = stochastic.prepare_size_arrays(sol, 1)
    import jax.numpy as jnp
    stoch = np.asarray(stochastic.solve_batch(
        w_flat, tdown, ea, jnp.asarray(absorbed), sol.ne))[0]
    equil = stochastic.solve_equilibrium_size(sol, 1, absorbed)[0]
    # compare where emission is significant (>1e-4 of peak); the Wien tail
    # legitimately exceeds equilibrium from temperature fluctuations
    m = equil > 1e-4 * equil.max()
    ratio = stoch[m] / equil[m]
    np.testing.assert_allclose(np.median(ratio), 1.0, atol=0.05)
    assert ratio.min() > 0.9 and ratio.max() < 1.5
