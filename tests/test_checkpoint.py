"""Preemption checkpointing: a killed run resumes bit-identically.

Counter-based RNG means a checkpoint is only (tallies + completed units);
the resumed run must reproduce the uninterrupted result exactly.
"""

import os
import shutil

import numpy as np
import pytest

from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.pipeline import driver

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
temperature     tmp.T
emitted         emitted.data
noabsorbed
nomap
checkpoint      run.ckpt
"""


def make_model(tmp_path, socex):
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    write_hierarchy(tmp_path / "tmp.cloud", N, N, N, [N ** 3],
                    [np.ones(N ** 3, np.float32)])
    ini = tmp_path / "run.ini"
    ini.write_text(INI.format(bgpac=8 * 6 * N * N))
    return str(ini)


class Preempt(Exception):
    pass


def test_preempted_run_resumes_bit_identically(tmp_path, monkeypatch, socex):
    ini = make_model(tmp_path, socex)

    # uninterrupted reference
    res_full = driver.run(ini, lanes=1 << 10)
    full_ckpt = np.load(tmp_path / "run.ckpt")
    n_units = len(full_ckpt["done"])
    assert n_units == 44
    os.remove(tmp_path / "run.ckpt")

    # preempt after 17 transport units
    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        if calls["n"] >= 17:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(ini, lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)

    ck = np.load(tmp_path / "run.ckpt")
    assert 0 < len(ck["done"]) < n_units     # genuinely partial

    # resume: remaining units only, result identical to the full run
    res2 = driver.run(ini, lanes=1 << 10)
    np.testing.assert_array_equal(res2.ctabs, res_full.ctabs)
    np.testing.assert_array_equal(res2.escaped, res_full.escaped)
    np.testing.assert_array_equal(res2.temperature, res_full.temperature)


def test_preempted_roi_save_resumes_identically(tmp_path, monkeypatch, socex):
    """The checkpoint must carry the ROI-save crossing histograms too:
    completed units' contributions live only in roi['tally'] (regression:
    they were silently zero after a resume)."""
    make_model(tmp_path, socex)
    ini = tmp_path / "run.ini"
    ini.write_text(INI.format(bgpac=8 * 6 * N * N)
                   + "roi  2 7 2 7 2 7\nroisave  roi.photons 1\n"
                   + "roinside 2\nnosolve\n")
    ini = str(ini)

    res_full = driver.run(ini, lanes=1 << 10)
    from soc_tpu.transport.roi import read_roi_file
    _, _, _, _, data_full = read_roi_file(str(tmp_path / "roi.photons"))
    assert data_full.sum() > 0
    os.remove(tmp_path / "run.ckpt")
    os.remove(tmp_path / "roi.photons")

    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        if calls["n"] >= 13:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(ini, lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)

    driver.run(ini, lanes=1 << 10)
    _, _, _, _, data2 = read_roi_file(str(tmp_path / "roi.photons"))
    np.testing.assert_array_equal(data2, data_full)


def test_stale_checkpoint_is_ignored(tmp_path, socex):
    """A checkpoint written under a different configuration (other seed)
    must not be resumed: the re-run starts fresh and matches a clean run
    of the NEW configuration."""
    ini = make_model(tmp_path, socex)
    driver.run(ini, lanes=1 << 10)                 # leaves run.ckpt behind
    assert (tmp_path / "run.ckpt").exists()

    new_text = INI.format(bgpac=8 * 6 * N * N).replace(
        "seed            1.0", "seed            0.25")
    (tmp_path / "run.ini").write_text(new_text)
    res_stale = driver.run(str(tmp_path / "run.ini"), lanes=1 << 10)

    os.remove(tmp_path / "run.ckpt")
    res_clean = driver.run(str(tmp_path / "run.ini"), lanes=1 << 10)
    np.testing.assert_array_equal(res_stale.ctabs, res_clean.ctabs)


def test_hpbg_resume_reports_full_injected(tmp_path, monkeypatch, socex):
    """`injected` bookkeeping must cover checkpoint-skipped channels
    (it was a make_params side effect that resume never executed)."""
    from soc_tpu.io.cloud import write_hierarchy as _wh
    for f in ("tmp.dust", "tmp.dsc", "bg_intensity.bin"):
        shutil.copy(socex / f, tmp_path)
    _wh(tmp_path / "tmp.cloud", N, N, N, [N ** 3],
        [np.ones(N ** 3, np.float32)])
    sky = np.tile(np.fromfile(tmp_path / "bg_intensity.bin",
                              np.float32)[:, None], (1, 12 * 64 * 64))
    sky.tofile(tmp_path / "sky.bin")
    ini = tmp_path / "run.ini"
    ini.write_text(INI.format(bgpac=2048).replace(
        "background      bg_intensity.bin", "hpbg            sky.bin"))
    res_full = driver.run(str(ini), lanes=1 << 10)
    os.remove(tmp_path / "run.ckpt")

    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        if calls["n"] >= 11:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(str(ini), lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)
    res2 = driver.run(str(ini), lanes=1 << 10)
    np.testing.assert_allclose(res2.injected, res_full.injected, rtol=1e-12)
    np.testing.assert_array_equal(res2.ctabs, res_full.ctabs)


def _phase2_ini(tmp_path, socex, extra=""):
    make_model(tmp_path, socex)
    ini = tmp_path / "run.ini"
    ini.write_text(INI.format(bgpac=8 * 6 * N * N)
                   .replace("iterations      1", "iterations      3")
                   .replace("noabsorbed", "absorbed absorbed.data")
                   + "cellpackets %d\n" % (2 * N ** 3) + extra)
    return str(ini)


def test_phase2_mid_sweep_resume_bit_identical(tmp_path, monkeypatch, socex):
    """Kill the run in the MIDDLE of iteration 1's re-emission sweep: the
    resumed run restores the partial per-channel tally (p2_tabs) and the
    iteration-0 state snapshot, reruns only the remaining channels, and
    reproduces the uninterrupted result bit for bit (SURVEY 5.4 --
    phase-2 preemption coverage)."""
    ini = _phase2_ini(tmp_path, socex)
    res_full = driver.run(ini, lanes=1 << 10)
    full_ckpt = np.load(tmp_path / "run.ckpt")
    done_full = [str(k) for k in full_ckpt["done"]]
    # phase-1 channels + 3 iterations x (44 sweep units + 1 snapshot);
    # iteration 0 has no sweep (no emitted field yet)
    assert "iter0" in done_full and "it1/f3" in done_full
    os.remove(tmp_path / "run.ckpt")
    os.remove(tmp_path / "absorbed.data")

    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        # 44 phase-1 bg units + iteration-1 sweep channels, then die
        if calls["n"] >= 44 + 13:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(ini, lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)

    ck = np.load(tmp_path / "run.ckpt")
    done = [str(k) for k in ck["done"]]
    assert "iter0" in done                      # crossed a phase-2 boundary
    assert any(d.startswith("it1/") for d in done)   # mid-sweep
    assert not ("iter1" in done)

    res2 = driver.run(ini, lanes=1 << 10)
    np.testing.assert_array_equal(res2.ctabs, res_full.ctabs)
    np.testing.assert_array_equal(res2.temperature, res_full.temperature)
    np.testing.assert_array_equal(res2.emitted, res_full.emitted)
    np.testing.assert_array_equal(res2.absorbed, res_full.absorbed)


def test_phase2_resume_with_reference_and_ali(tmp_path, monkeypatch, socex):
    """Iteration-boundary resume with the WITH_REFERENCE control variate
    and ALI carries: the oemitted/otabs/oxab state travels in the
    snapshot, so the continuation is bit-identical."""
    ini = _phase2_ini(tmp_path, socex, "reference 1\nALI\n")
    res_full = driver.run(ini, lanes=1 << 10)
    os.remove(tmp_path / "run.ckpt")
    os.remove(tmp_path / "absorbed.data")

    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        # die inside iteration 2's sweep (ALI path: iteration units only)
        if calls["n"] >= 44 + 44 + 13:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(ini, lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)
    ck = np.load(tmp_path / "run.ckpt")
    done = [str(k) for k in ck["done"]]
    assert "iter1" in done and "iter2" not in done

    res2 = driver.run(ini, lanes=1 << 10)
    np.testing.assert_array_equal(res2.ctabs, res_full.ctabs)
    np.testing.assert_array_equal(res2.temperature, res_full.temperature)
    np.testing.assert_array_equal(res2.emitted, res_full.emitted)


def test_phase2_resume_with_emweight(tmp_path, monkeypatch, socex):
    """EMWEI re-emission checkpoints at ITERATION granularity (the
    weighted per-frequency loop carries no mid-sweep units): killing the
    run inside iteration 1's weighted sweep resumes from the iteration-0
    snapshot, re-derives the identical allocations (Philox keyed by
    (seed, iteration) + the restored emitted field) and reproduces the
    uninterrupted run bit for bit."""
    ini = _phase2_ini(tmp_path, socex, extra="emweight 1 0 100\n")
    res_full = driver.run(ini, lanes=1 << 10)
    os.remove(tmp_path / "run.ckpt")
    os.remove(tmp_path / "absorbed.data")

    real = driver.transport_run
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        # 44 phase-1 bg units, then die partway into iteration 1's sweep
        if calls["n"] >= 44 + 9:
            raise Preempt()
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(driver, "transport_run", flaky)
    with pytest.raises(Preempt):
        driver.run(ini, lanes=1 << 10)
    monkeypatch.setattr(driver, "transport_run", real)

    ck = np.load(tmp_path / "run.ckpt")
    done = [str(k) for k in ck["done"]]
    assert "iter0" in done
    assert not any(d.startswith("it1/") for d in done)   # no sweep units

    res2 = driver.run(ini, lanes=1 << 10)
    np.testing.assert_array_equal(res2.ctabs, res_full.ctabs)
    np.testing.assert_array_equal(res2.temperature, res_full.temperature)
    np.testing.assert_array_equal(res2.emitted, res_full.emitted)
    np.testing.assert_array_equal(res2.absorbed, res_full.absorbed)
