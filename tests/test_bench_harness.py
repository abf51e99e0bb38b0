"""Integrity of the bench harness itself.

bench.py runs unattended on the accelerator; a broken code path there
costs the performance evidence of a run.  This drives the reference-scale
section end-to-end at toy size on the CPU mesh (the env knobs exist
exactly for this) and checks every reported quantity is present and sane.
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def bench(monkeypatch):
    monkeypatch.setenv("SOC_BENCH_LARGE_N", "16")
    monkeypatch.setenv("SOC_BENCH_LARGE_ROWS", str(1 << 12))
    monkeypatch.setenv("SOC_BENCH_XL_N", "32")
    monkeypatch.setenv("SOC_BENCH_XL_PKTS", str(1 << 13))
    sys.path.insert(0, REPO)
    import bench as b
    return b


def test_bench_xl_section(bench, tmp_path):
    workdir = str(tmp_path / "bw")
    bench.prepare_workdir(workdir)
    out = bench.bench_xl(workdir, 1 << 10)
    assert out["cells"] == 32 ** 3
    for k in ("gather_melem_per_s", "bg_transport_pps",
              "map_render_s_256x256x1"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["sane"] is True
    json.dumps(out)


def test_bench_large_section(bench, tmp_path):
    workdir = str(tmp_path / "bw")
    bench.prepare_workdir(workdir)
    out = bench.bench_large(workdir, 1 << 10, repeats=1)
    # all advertised fields present and finite
    assert out["cells"] == 16 ** 3 + 8 * 4096 + 8 * 512
    assert out["levels"] == 3
    for k in ("gather_melem_per_s", "scatter_melem_per_s",
              "bg_transport_pps", "a2e_stream_cells_per_sec",
              "map_render_s_512x512x44", "stepping_rate_msteps_per_s",
              "stepping_inloop_bound_msteps_per_s",
              "sol_stepping_fraction_vs_random_floor"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["a2e_stream_rows"] == 1 << 12
    assert out["sane"] is True
    json.dumps(out)                       # JSON-serializable as reported
