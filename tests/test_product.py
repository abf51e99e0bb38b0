"""`devices N` -- the ini-driven multi-chip product path.

The same ini must run sharded over the 8-device virtual mesh and match the
single-device run allclose (packet RNG streams are identity-keyed, so only
tally summation order differs) with NO feature exclusions: per-frequency
absorbed tallies, ALI, emission weighting, splitting, mirror boundaries,
per-cell abundances, ROI save and checkpoints.
"""

import os
import shutil

import numpy as np
import pytest

from soc_tpu.io.cloud import write_hierarchy
from soc_tpu.pipeline import driver

N = 12
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
iterations      {iters}
cellpackets     {clpac}
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


def run_ini(model_dir, extra="", **fmt):
    fmt.setdefault("bgpac", 8 * 6 * N * N)
    fmt.setdefault("iters", 1)
    fmt.setdefault("clpac", 0)
    ini = model_dir / "run.ini"
    ini.write_text(BASE_INI.format(**fmt) + extra)
    return driver.run(str(ini), lanes=LANES)


def assert_match(r1, r8, rtol=2e-5, atol=0.0, abs_floor=1e-5):
    np.testing.assert_allclose(r8.ctabs, r1.ctabs, rtol=rtol, atol=atol)
    # escaped is a sum over ALL packet weights: pure summation-order noise
    np.testing.assert_allclose(r8.escaped, r1.escaped,
                               rtol=max(rtol, 2e-4))
    if r1.absorbed is not None:
        # near-zero cells of the per-frequency tally sit at float32
        # deposit noise: floor the comparison at abs_floor of the peak
        # (discrete roulette allocations amplify last-bit noise, so
        # emweight tests pass a coarser floor)
        a1, a8 = r1.absorbed, r8.absorbed
        np.testing.assert_allclose(a8, a1, rtol=rtol,
                                   atol=abs_floor * abs(a1).max())
    if r1.temperature is not None:
        np.testing.assert_allclose(r8.temperature, r1.temperature,
                                   rtol=1e-4)
    for k in r1.maps:
        np.testing.assert_allclose(r8.maps[k], r1.maps[k], rtol=2e-4,
                                   atol=1e-6 * abs(np.asarray(
                                       r1.maps[k])).max())


def test_devices_matches_single_device_bg(model_dir):
    r1 = run_ini(model_dir)
    r8 = run_ini(model_dir, "devices 8\n")
    assert_match(r1, r8)


def test_devices_iterations_and_absorbed(model_dir):
    """Cell re-emission iterations + per-frequency absorbed under devices:
    the frequency-sharded dp-partial tally must reduce to the
    single-device absorbed.data."""
    r1 = run_ini(model_dir, iters=2, clpac=4096)
    a1 = np.fromfile(model_dir / "absorbed.data", np.float32)
    r8 = run_ini(model_dir, "devices 8\n", iters=2, clpac=4096)
    a8 = np.fromfile(model_dir / "absorbed.data", np.float32)
    assert_match(r1, r8)
    np.testing.assert_allclose(a8, a1, rtol=2e-4, atol=1e-30)


def test_devices_no_exclusions_ali_emweight_mirror(model_dir):
    """The round-2 `domains` exclusion list must NOT apply to `devices`:
    ALI + emission weighting + mirror run sharded and match."""
    extra = "emweight 1 0 100\nmirror xX\nALI\n"
    r1 = run_ini(model_dir, extra, iters=2, clpac=4096)
    r8 = run_ini(model_dir, extra + "devices 8\n", iters=2, clpac=4096)
    assert_match(r1, r8, rtol=1e-4, abs_floor=1e-3)


def test_devices_split_on_octree(model_dir):
    from soc_tpu.grid import encode_link_np
    rng = np.random.default_rng(0)
    root = rng.uniform(0.5, 1.0, N ** 3).astype(np.float32)
    centre = (N // 2) + N * (N // 2) + N * N * (N // 2)
    root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
    l1 = rng.uniform(2.0, 4.0, 8).astype(np.float32)
    write_hierarchy(model_dir / "tmp.cloud", N, N, N, [N ** 3, 8],
                    [root, l1])
    r1 = run_ini(model_dir, "split\n")
    r8 = run_ini(model_dir, "split\ndevices 8\n")
    assert_match(r1, r8, rtol=1e-4)


def test_devices_point_source_and_simum(model_dir):
    lum = np.full(44, 1e36, np.float32)
    lum.tofile(model_dir / "ps.bin")
    extra = ("pointsource  6.0 6.0 6.0  ps.bin\npspackets 2048\n"
             "simum 150.0 400.0\n")
    r1 = run_ini(model_dir, extra, bgpac=0)
    r8 = run_ini(model_dir, extra + "devices 8\n", bgpac=0)
    assert_match(r1, r8, rtol=1e-4)


def test_devices_abundances_msf(model_dir):
    """Two dust species with per-cell abundances (WITH_ABU per-cell OPT +
    MSF per-species scattering) under devices."""
    cells = N ** 3
    rng = np.random.default_rng(3)
    abu = rng.uniform(0.2, 0.8, cells).astype(np.float32)
    abu.tofile(model_dir / "abu1.bin")
    (1.0 - abu).tofile(model_dir / "abu2.bin")
    extra = ("optical tmp.dust\ndsc tmp.dsc 2500\n"
             "abundance abu1.bin abu2.bin\n")
    r1 = run_ini(model_dir, extra)
    r8 = run_ini(model_dir, extra + "devices 8\n")
    assert_match(r1, r8, rtol=1e-4)


class Preempt(Exception):
    pass


def test_devices_checkpoint_resume(model_dir, monkeypatch):
    """Mid-run preemption under devices: a run killed between frequency
    groups resumes from the checkpoint and reproduces the uninterrupted
    sharded run exactly. Groups are recorded atomically (record_many), so
    no kill point can persist a snapshot whose deposits are ahead of its
    done-list (the old per-key loop double-counted a group on resume)."""
    from soc_tpu.utils.checkpoint import RunCheckpoint
    extra = "devices 8\ncheckpoint run.ckpt 1\n"
    r_full = run_ini(model_dir, extra)
    ck = np.load(model_dir / "run.ckpt")
    assert len(ck["done"]) == 44           # every channel recorded
    os.remove(model_dir / "run.ckpt")

    # kill the run just before the 4th group is recorded: deposits for
    # that group are already in the device tallies, but the checkpoint
    # must only hold the 3 complete groups
    real = RunCheckpoint.record_many
    calls = {"n": 0}

    def flaky(self, keys, *a, **kw):
        if calls["n"] >= 3:
            raise Preempt()
        calls["n"] += 1
        return real(self, keys, *a, **kw)

    monkeypatch.setattr(RunCheckpoint, "record_many", flaky)
    with pytest.raises(Preempt):
        run_ini(model_dir, extra)
    monkeypatch.setattr(RunCheckpoint, "record_many", real)

    ck_part = np.load(model_dir / "run.ckpt")
    assert len(ck_part["done"]) == 12      # 3 groups x 4 channels, whole

    r_resume = run_ini(model_dir, extra)
    np.testing.assert_array_equal(np.asarray(r_resume.ctabs),
                                  np.asarray(r_full.ctabs))
    np.testing.assert_array_equal(r_resume.escaped, r_full.escaped)
    np.testing.assert_array_equal(np.asarray(r_resume.absorbed),
                                  np.asarray(r_full.absorbed))


def test_devices_roi_save(model_dir):
    extra = ("roi 4 7 4 7 4 7\nroisave roi.dat\nroinside 2\n")
    r1 = run_ini(model_dir, extra)
    d1 = np.fromfile(model_dir / "roi.dat", np.float32)
    r8 = run_ini(model_dir, extra + "devices 8\n")
    d8 = np.fromfile(model_dir / "roi.dat", np.float32)
    assert_match(r1, r8, rtol=1e-4)
    assert d1[5:].sum() > 0
    np.testing.assert_allclose(d8[5:].sum(), d1[5:].sum(), rtol=1e-4)
    np.testing.assert_allclose(d8, d1, rtol=1e-3, atol=1e-8 * d1.max())


def test_devices_diffuse_with_emweight(model_dir):
    """Phase-1 diffuse EMWEI (ASOC.py:1277-1292) sharded under devices:
    the weighted allocation is identical across paths (shared
    _emweight_allocs), so the run matches single-device allclose."""
    cells = N ** 3
    rng = np.random.default_rng(6)
    field = np.zeros((cells, 44), np.float32)
    field[:, 18] = (1e-12 * rng.uniform(0.2, 2.0, cells)).astype(np.float32)
    field[:, 24] = (5e-13 * rng.uniform(0.2, 2.0, cells)).astype(np.float32)
    with open(model_dir / "diffuse.bin", "wb") as fp:
        np.asarray([cells, 44], np.int32).tofile(fp)
        field.tofile(fp)
    extra = ("diffuse  diffuse.bin\ndiffpack %d\nnosolve\n"
             "emweight 1 0 100 0 1\n" % (4 * cells))
    r1 = run_ini(model_dir, extra, bgpac=0, clpac=1024)
    r8 = run_ini(model_dir, extra + "devices 8\n", bgpac=0, clpac=1024)
    assert r1.ctabs.sum() > 0
    assert_match(r1, r8, rtol=1e-4, abs_floor=1e-3)


def test_devices_emweight_mode2(model_dir):
    """USE_EMWEIGHT==2 deterministic quotas under devices: same EMPAC
    multiset on every path."""
    extra = "emweight 2 0 100\n"
    r1 = run_ini(model_dir, extra, iters=2, clpac=20000)
    r8 = run_ini(model_dir, extra + "devices 8\n", iters=2, clpac=20000)
    assert_match(r1, r8, rtol=1e-4, abs_floor=1e-3)
