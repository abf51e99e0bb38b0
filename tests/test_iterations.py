"""Self-heating iterations: CLPAC re-emission, WITH_REFERENCE, EMWEI paths."""

import shutil

import numpy as np
import pytest

from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.pipeline import driver

INI = """
gridlength      0.01
cloud           tmp.cloud
mapping         8 8 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc 2500
bgpackets       {bgpac}
cellpackets     {clpac}
background      bg_intensity.bin
iterations      {iters}
noabsorbed
temperature     tmp.T
emitted         emitted.data
nomap
{extra}
"""


def make_run(tmp_path, socex, name, clpac, iters, extra=""):
    wd = tmp_path / name
    wd.mkdir()
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, wd)
    n = 8
    write_hierarchy(wd / "tmp.cloud", n, n, n, [n**3],
                    [np.ones(n**3, np.float32)])
    area = 6 * n * n
    (wd / "my.ini").write_text(INI.format(
        bgpac=8 * area * 2, clpac=clpac, iters=iters, extra=extra))
    return driver.run(str(wd / "my.ini"), lanes=1 << 13)


def test_self_heating_iterations(tmp_path, socex):
    res = make_run(tmp_path, socex, "plain", clpac=2 * 8**3, iters=3)
    assert np.all(np.isfinite(res.temperature))
    assert np.all(res.temperature > 3.0)
    assert np.all(np.isfinite(res.emitted))
    assert res.emitted.max() > 0


def test_with_reference_matches_plain(tmp_path, socex):
    """The reference-field control variate must converge to the same
    temperatures as the plain iteration."""
    res_a = make_run(tmp_path, socex, "a", clpac=2 * 8**3, iters=3)
    res_b = make_run(tmp_path, socex, "b", clpac=2 * 8**3, iters=3,
                     extra="reference 1")
    np.testing.assert_allclose(res_b.temperature, res_a.temperature,
                               rtol=0.02)


def test_emweight_iteration(tmp_path, socex):
    res = make_run(tmp_path, socex, "w", clpac=2 * 8**3, iters=2,
                   extra="emweight 1")
    assert np.all(np.isfinite(res.temperature))
    assert np.all(res.temperature > 3.0)


def test_ali_iteration(tmp_path, socex):
    res = make_run(tmp_path, socex, "ali", clpac=2 * 8**3, iters=2,
                   extra="ali 1")
    assert np.all(np.isfinite(res.temperature))
    assert np.all(res.temperature > 3.0)


def test_subiterations(tmp_path, socex):
    """SUBITERATIONS hot/cold schedule converges to the plain result."""
    res_p = make_run(tmp_path, socex, "sub_p", clpac=4 * 8**3, iters=5)
    res_s = make_run(tmp_path, socex, "sub_s", clpac=4 * 8**3, iters=5,
                     extra="reference 1\nemweight 1\nSUBITERATIONS 1")
    np.testing.assert_allclose(res_s.temperature, res_p.temperature,
                               rtol=0.03)


def test_with_reference_continuation_aabb(tmp_path, socex):
    """AABB encoding: a run continued from .save files (reference >1 with
    BB = first iteration of this run) reproduces a single longer run's
    temperatures and persists OEMITTED.save / OTABS.save."""
    # single 4-iteration run with ramp k = (it+0)/4
    res_full = make_run(tmp_path, socex, "full", clpac=2 * 8**3, iters=4,
                        extra="reference 402")
    wd = tmp_path / "full"
    assert (wd / "OEMITTED.save").exists()
    assert (wd / "OTABS.save").exists()
    # two chained runs: iterations 0-1 (BB=0), then 2-3 (BB=2) restoring
    # the saved reference field
    wd2 = tmp_path / "chain"
    res_a = make_run(tmp_path, socex, "chain", clpac=2 * 8**3, iters=2,
                     extra="reference 400")
    (wd2 / "my2.ini").write_text(
        (wd2 / "my.ini").read_text().replace("reference 400",
                                             "reference 402"))
    res_b = driver.run(str(wd2 / "my2.ini"), lanes=1 << 13)
    np.testing.assert_allclose(res_b.temperature, res_full.temperature,
                               rtol=0.02)


def test_reference_field_reduces_variance(tmp_path, socex):
    """The control variate's purpose: iteration-to-iteration emission noise
    shrinks. Compare two seeds with and without the reference field."""
    t = {}
    for tag, extra in (("p", ""), ("r", "reference 1")):
        for s, seedval in (("1", "1.0"), ("2", "0.5")):
            res = make_run(tmp_path, socex, tag + s, clpac=2 * 8**3, iters=4,
                           extra=extra + "\nseed " + seedval)
            t[tag + s] = res.temperature
    dp = np.abs(t["p1"] - t["p2"]).mean()
    dr = np.abs(t["r1"] - t["r2"]).mean()
    # the reference field must not increase the seed-to-seed scatter
    assert dr < 1.5 * dp


def test_ali_beta_spline():
    """beta(T, tau) table: monotonic in tau, ~1 at tau->0, and the
    refinement moves beta in the right direction."""
    from soc_tpu.solve.ali import beta_table, beta_lookup, refine_beta
    freq = np.logspace(11, 13.5, 32)
    kabs = (freq / freq[-1]) ** 1.8          # opacity rising with frequency
    table = beta_table(freq, kabs)
    t = np.asarray([10.0, 20.0, 40.0])
    assert np.all(beta_lookup(table, t, np.zeros(3)) > 0.97)
    b_lo = beta_lookup(table, t, np.full(3, 0.1))
    b_hi = beta_lookup(table, t, np.full(3, 50.0))
    assert np.all(b_hi < b_lo)
    # hotter cells emit at higher frequency where tau is larger -> beta
    # decreases with T at fixed reference tau
    bt = beta_lookup(table, np.asarray([10.0, 100.0]), np.full(2, 10.0))
    assert bt[1] < bt[0]
    out = refine_beta(np.full(4, 0.9, np.float32),
                      np.asarray([15.0, 15.0, 30.0, 30.0]),
                      freq, kabs, np.full(4, 5.0),
                      t_old=np.asarray([15.0, 30.0, 15.0, 30.0]))
    assert out[0] == pytest.approx(0.9, abs=1e-5)      # T unchanged
    assert out[2] < 0.9 < out[1]                        # hotter => lower beta
