"""ASOC_driver pipeline modes: makelib / uselib and nnmake / nnsolve.

The library and NN emission surrogates must be reachable from the
ini-driven pipeline (reference: ASOC_driver.py uselib/makelib CLI args and
the nnmake/nnsolve ini keywords) and reproduce the full solve.
"""

import os
import shutil

import numpy as np
import pytest

from soc_tpu.pipeline.full import run_pipeline

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
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
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


def write_ini(model_dir, extra=""):
    ini = model_dir / "run.ini"
    ini.write_text(INI.format(bgpac=8 * 6 * N * N, extra=extra))
    return str(ini)


def test_makelib_then_uselib(model_dir):
    ini = write_ini(model_dir)
    _, emitted_full, _ = run_pipeline(ini, lanes=1 << 10, mode="makelib")
    lib_path = model_dir / "tmp.lib"
    assert lib_path.exists()

    _, emitted_lib, res_map = run_pipeline(ini, lanes=1 << 10, mode="uselib")
    # library answers must reproduce the full solve closely on this
    # single-phase model (every cell falls in an occupied bin)
    sel = emitted_full > emitted_full.max() * 1e-6
    rel = np.abs(emitted_lib[sel] - emitted_full[sel]) / emitted_full[sel]
    assert np.median(rel) < 0.05
    assert res_map.maps[0].shape[1:] == (8, 8)


def test_nnmake_then_nnsolve(model_dir):
    ini = write_ini(model_dir,
                    "nnmake  surro\nnnabs  0.55 2.2 25.0 250.0\n"
                    "nnemit  100.0 250.0 500.0\n")
    _, emitted_full, _ = run_pipeline(ini, lanes=1 << 10)
    assert (model_dir / "surro_tmp.nn").exists()

    ini2 = write_ini(model_dir,
                     "nnsolve  surro\nnnabs  0.55 2.2 25.0 250.0\n"
                     "nnemit  100.0 250.0 500.0\n")
    _, emitted_nn, _ = run_pipeline(ini2, lanes=1 << 10)
    # NN emission at the nnemit wavelengths must be close to the real solve
    from soc_tpu.constants import um2f
    from soc_tpu.io.dust import read_simple_dust
    freq = read_simple_dust(str(model_dir / "tmp.dust"), 0.01).freq
    idx = [int(np.argmin(np.abs(freq - um2f(u))))
           for u in (100.0, 250.0, 500.0)]
    a = emitted_nn[:, idx]
    b = emitted_full[:, idx]
    sel = b > 0
    rel = np.abs(a[sel] - b[sel]) / b[sel]
    assert np.median(rel) < 0.1
    # all other columns stay zero in an nnsolve run
    other = np.ones(len(freq), bool)
    other[idx] = False
    assert np.abs(emitted_nn[:, other]).max() == 0.0


def test_nnsolve_reads_reference_torch_checkpoint(model_dir):
    """End-to-end `nnsolve` with a REFERENCE-trained surrogate: a torch
    state-dict checkpoint named <prefix>_<dust>.nn plus the A_/E_<dust>
    .norm companions (the exact on-disk artifacts of ASOC_aux_NN.NN_fit,
    ASOC_aux_NN.py:110-113,159) drive the ini pipeline, and the emitted
    columns match the torch forward pass on the pipeline's own absorbed
    field -- proving the wiring (file naming, norm lookup, channel
    selection), not just the unit-level import."""
    torch = pytest.importorskip("torch")
    tnn = torch.nn
    torch.manual_seed(3)
    net = tnn.Sequential(tnn.Linear(4, 13), tnn.LeakyReLU(),
                         tnn.Linear(13, 17), tnn.LeakyReLU(),
                         tnn.Linear(17, 13), tnn.LeakyReLU(),
                         tnn.Linear(13, 3))
    state = {("layers." + k): v for k, v in net.state_dict().items()}
    torch.save(state, model_dir / "surro_tmp.nn")
    rng = np.random.default_rng(11)
    ma = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    me = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    ma.tofile(model_dir / "A_tmp.norm")
    me.tofile(model_dir / "E_tmp.norm")

    nn_um = (0.55, 2.2, 25.0, 250.0)
    em_um = (100.0, 250.0, 500.0)
    ini = write_ini(model_dir,
                    "nnsolve  surro\n"
                    "nnabs  %s\nnnemit  %s\n"
                    % (" ".join(map(str, nn_um)),
                       " ".join(map(str, em_um))))
    _, emitted_nn, _ = run_pipeline(ini, lanes=1 << 10)

    from soc_tpu.constants import um2f
    from soc_tpu.io.dust import read_simple_dust
    freq = read_simple_dust(str(model_dir / "tmp.dust"), 0.01).freq
    iabs = [int(np.argmin(np.abs(freq - um2f(u)))) for u in nn_um]
    iemit = [int(np.argmin(np.abs(freq - um2f(u)))) for u in em_um]
    raw = np.fromfile(model_dir / "absorbed.data", np.float32)
    cells, nf = raw[:2].view(np.int32)
    absorbed = raw[2:].reshape(cells, nf)

    x = np.clip(absorbed[:, iabs], 1.0e-29, 1.0e32) / ma[None, :]
    with torch.no_grad():
        want = net(torch.tensor(x)).numpy() * me[None, :]
    np.testing.assert_allclose(emitted_nn[:, iemit], want,
                               rtol=2e-5, atol=1e-5)
    other = np.ones(nf, bool)
    other[iemit] = False
    assert np.abs(emitted_nn[:, other]).max() == 0.0


def test_gset_dust_pipeline_with_nenumber(tmp_path):
    """Full ASOC_driver-style run with a STOCHASTIC (gset) dust: the RT
    stage swaps in an auto-generated <name>_simple.dust
    (ASOC_driver.py:240-245) and the solver file honours the `nenumber`
    keyword (ASOC_driver.py:93,131-132)."""
    import sys
    sys.path.insert(0, "tests")
    from test_dust_compiler import dustem_files  # noqa: F401 (fixture)
    from soc_tpu.solve import dust_compiler as dc
    from soc_tpu.solve.grain_model import write_gset_dust
    from soc_tpu.io.cloud import write_hierarchy
    from soc_tpu.solve.solver_file import read_solver

    # build a gset dust + matching dsc/bg on its own frequency grid
    um = np.sort(np.logspace(-1, 3, 30))
    from soc_tpu.constants import um2f
    freq = np.sort(um2f(um))
    import test_dust_compiler as tdc
    fixture = tdc.dustem_files.__wrapped__(tmp_path)
    grain, lam, qf, gf, cf = fixture
    dust = dc.compile_dust(grain, lam, qf, gf, cf)
    gset = dc.to_gset(dust)
    write_gset_dust(str(tmp_path / "gs_TST.dust"), gset)
    dsc, csc = dc.tabulated_scattering_function(dust, freq, bins=2500)
    dc.write_scattering_file(str(tmp_path / "tst.dsc"), dsc, csc)
    np.ones(len(freq), np.float32).tofile(tmp_path / "bg.bin")
    write_hierarchy(tmp_path / "tmp.cloud", N, N, N, [N ** 3],
                    [np.ones(N ** 3, np.float32)])

    ini = tmp_path / "run.ini"
    ini.write_text("""
gridlength      0.01
cloud           tmp.cloud
mapping         8 8 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         gs_TST.dust
dsc             tst.dsc 2500
background      bg.bin
bgpackets       %d
iterations      1
nenumber        48
prefix          tst
absorbed        absorbed.data
emitted         emitted.data
temperature     tst.T
""" % (8 * 6 * N * N))
    res_rt, emitted, res_map = run_pipeline(str(ini), lanes=1 << 10)
    assert (tmp_path / "TST_simple.dust").exists()
    sol = read_solver(str(tmp_path / "gs_TST.solver"))
    assert sol.ne == 48
    assert np.isfinite(emitted).all() and emitted.max() > 0
    assert res_map.maps[0].max() > 0


def test_library_device_lookup_matches_host():
    """The jitted on-device library lookup (the reference runs this as a
    kernel for all cells, kernel_SOC_lookup.c:4) must agree with the NumPy
    path; save_library must strip the device cache."""
    import pickle
    from soc_tpu.solve import library as libmod
    rng = np.random.default_rng(7)
    nf, cells = 16, 4096
    absorbed = rng.lognormal(0.0, 2.0, (cells, nf)).astype(np.float32)
    emitted = rng.random((cells, nf)).astype(np.float32)
    lib = libmod.build_library(absorbed, emitted, [1, 5, 9], nbins=16)
    host = libmod.solve_with_library(lib, absorbed, device=False)
    dev = np.asarray(libmod.solve_with_library(lib, absorbed, device=True))
    # float32 bin rounding may flip an edge cell to the neighbouring
    # (hole-filled) bin: demand exact agreement for virtually all cells
    same = np.all(host == dev, axis=1)
    assert same.mean() > 0.999
    assert lib.get("_dev") is not None      # cache populated
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.lib")
        libmod.save_library(p, lib)
        lib2 = libmod.load_library(p)
        assert "_dev" not in lib2
        h2 = libmod.solve_with_library(lib2, absorbed, device=False)
        np.testing.assert_array_equal(host, h2)
