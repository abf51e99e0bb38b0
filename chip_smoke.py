#!/usr/bin/env python
"""Smoke run of soc_tpu's main paths on one NVIDIA GPU.

    python chip_smoke.py            # P1-P5 on one card
    python chip_smoke.py --four     # the multi-card tally paths on 4 cards

Phases (each a function of a size dict, so the CPU tests can run them at
a tiny size):

  P1  the generated 64^3 x 44-channel example with its full packet budget
      through ``soc_tpu.cli.main(["rt", ini])``, cold and warm: energy
      closure, temperatures, maps, and the spread between the two
      same-seed runs
  P2  a small ini on the GPU and on the CPU (the plain reference) in the
      same process: the counter-based RNG gives both the same packets
  P3  the 16.8M-cell octree through ``driver.run`` with the 44-channel
      [CELLS, NFREQ] tally on the device (packet budget cut, see the line)
  P4  the A2E solve on 2^20 cells of a generated GSET solver (NE=128,
      4 sizes), 512 cells against the float64 loop port, and the
      device-resident rate
  P5  a small scattered-light ini through ``cli.main(["sca", ini])``,
      against the CPU run of the same ini

``--four`` runs only P3's ini on one card, with ``devices 4`` and with
``domains 4``, and checks that every card's share of the tally is
non-zero.

Every time printed carries the card's name and power limit. The last line
of standard output is one JSON object: {"ok": ..., "device": {"platform",
"kind", "count"}}. Without a GPU the script exits non-zero.
"""

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# All float32 dots on these paths set precision=HIGHEST (no TF32).
FULL = dict(
    p1_n=64, p1_bgpackets=999999,
    p2_n=16, p2_bgpackets=98304, p2_lanes=1 << 12,
    p3_n=256, p3_simum=None, p3_lanes=1 << 17,
    p4_cells=1 << 20, p4_ref_cells=512, p4_ne=128,
    p5_n=16, p5_bgpackets=8 * 6 * 16 * 16, p5_lanes=1 << 12,
)
TINY = dict(
    p1_n=8, p1_bgpackets=8 * 6 * 8 * 8,
    p2_n=8, p2_bgpackets=8 * 6 * 8 * 8, p2_lanes=1 << 10,
    p3_n=32, p3_simum=(200.0, 300.0), p3_lanes=1 << 10,
    p4_cells=4096, p4_ref_cells=64, p4_ne=32,
    p5_n=8, p5_bgpackets=8 * 6 * 8 * 8, p5_lanes=1 << 10,
)

# P2/P5/--four: GPU and CPU (or 1-card and 4-card) runs follow the same
# packets; differences are float32 summation order (atomics on the GPU)
# and the rare packet whose last-ulp different step moves it across a
# cell boundary. Per-cell values are compared as the fraction of cells
# within rtol (tests/test_domain.py), totals tightly.
CELL_RTOL = 1e-3
T_RTOL = 2e-3
GOOD_FRACTION = 0.98
TOTAL_RTOL = 1e-3
CLOSURE_TOL = 5e-3
# P4: float32 device solve vs the float64 loop port, on every spectrum
# entry above 1e-6 of its cell's peak (127 substitution rows in float32)
A2E_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def card():
    """'name, power limit' of GPU 0 as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Clock:
    """Wall seconds and XLA compile seconds of a block of work."""

    def __init__(self):
        self.compile_s = 0.0
        import jax.monitoring
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration

    @contextlib.contextmanager
    def span(self, out, name):
        c0, t0 = self.compile_s, time.perf_counter()
        yield
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_compile_s"] = self.compile_s - c0


_CLOCK = None


def clock():
    global _CLOCK
    if _CLOCK is None:
        _CLOCK = Clock()
    return _CLOCK


@contextlib.contextmanager
def tagged_output():
    """Reprint what the block writes to stdout (the CLI's own timings),
    each line tagged with the card."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        for line in buf.getvalue().splitlines():
            print("  [%s] %s" % (card(), line))


@contextlib.contextmanager
def captured_runs():
    """Record the RunResult of every driver.run made inside the block (the
    CLI discards it)."""
    from soc_tpu.pipeline import driver
    runs, orig = [], driver.run

    def run(*a, **k):
        res = orig(*a, **k)
        runs.append(res)
        return res

    driver.run = run
    try:
        yield runs
    finally:
        driver.run = orig


def absorbed_photons(res, gl_pc):
    """Photons absorbed per channel, from the absorbed.data payload (the
    inverse of the driver's 8^level * FACTOR / (GL * DENS) scaling)."""
    from soc_tpu.constants import FACTOR, PARSEC
    from soc_tpu.solve.equilibrium import cell_levels
    dens = np.asarray(res.grid.dens, np.float64)
    leaf = dens > 0
    lev = np.asarray(cell_levels(res.grid))[leaf]
    w = dens[leaf] * gl_pc * PARSEC / (FACTOR * 8.0 ** lev)
    return w @ res.absorbed[leaf].astype(np.float64)


def closure(res, gl_pc):
    """max over channels of |absorbed + escaped - injected| / injected."""
    inj = np.asarray(res.injected, np.float64)
    sim = inj > 0
    err = (absorbed_photons(res, gl_pc) + res.escaped - inj)[sim] / inj[sim]
    return float(np.abs(err).max())


def bg_packets(res, bgpackets):
    """Background packets a run sent: 8 * AREA * BATCH per simulated
    channel (driver.simulate_background)."""
    per_batch = 8 * int(res.grid.area)
    batch = max(1, int(round(bgpackets / per_batch)))
    return float(np.sum(np.asarray(res.injected) > 0) * per_batch * batch)


def good_fraction(a, b, rtol, atol_rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = atol_rel * np.abs(b).max()
    return float(np.isclose(a, b, rtol=rtol, atol=atol).mean())


def rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def on_cpu():
    import jax
    return jax.default_device(jax.devices("cpu")[0])


def uv_mask(freq, um=5.0):
    """Channels shortward of um: no 10-20 K thermal emission there."""
    return 2.99792458e14 / np.asarray(freq) < um


def _example(workdir, n, bgpackets):
    """The example at n^3, its density scaled to keep the 64^3 column."""
    from soc_tpu.io import example
    return example.write_example(
        workdir, n=n, bgpackets=bgpackets,
        density=example.EXAMPLE_DENSITY * example.EXAMPLE_N / n)


def load_model(ini):
    """(grid, medium) of an ini's cloud and first dust."""
    from soc_tpu.config import RunConfig
    from soc_tpu.io.cloud import read_cloud
    from soc_tpu.io.dust import read_simple_dust, read_scattering_function
    from soc_tpu.transport.medium import medium_from_optics
    d = os.path.dirname(os.path.abspath(ini))
    cfg = RunConfig(ini)
    grid = read_cloud(os.path.join(d, cfg.file_cloud), cfg.kdensity,
                      cfg.max_levels)
    optics = [read_simple_dust(os.path.join(d, cfg.file_optical[0]),
                               cfg.gl)]
    freq = optics[0].freq
    dsc, csc = read_scattering_function(
        os.path.join(d, cfg.file_scafunc[0]), len(freq), 2500)
    return grid, medium_from_optics(optics, dsc, csc, freq)


def loop_rate(ini, lanes, iters=(64, 256)):
    """Seconds per iteration of the transport loop (one refill, then 16
    steps of every lane) on an ini's model: the mixed-frequency loop run
    for a fixed number of iterations with an unlimited packet budget, the
    fixed cost removed by taking the slope between two lengths."""
    import jax
    import jax.numpy as jnp
    from soc_tpu.transport.propagate import transport_run
    from soc_tpu.transport.sources import stream_hi_base
    grid, medium = load_model(ini)
    nfreq = medium.nfreq
    physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
                   tw=medium.tw)
    params = dict(photons=jnp.ones(nfreq, jnp.float32), ifreq=None,
                  per_freq=jnp.int32(1 << 24), ifreq0=jnp.int32(0),
                  k0=jnp.uint32(0), hi_base=jnp.uint32(stream_hi_base("bg")))
    times = []
    for n in iters:
        def go():
            tabs, _, _, _ = transport_run(
                grid, physics, params, jnp.int32(2 ** 31 - 1),
                jnp.zeros(grid.cells, jnp.float32),
                jnp.zeros((1, 1), jnp.float32), jnp.uint32(7),
                source_kind="bg", nlanes=lanes, max_iters=n, esc_bins=nfreq)
            return jax.block_until_ready(tabs)
        go()
        t0 = time.perf_counter()
        go()
        times.append(time.perf_counter() - t0)
    return (times[1] - times[0]) / (iters[1] - iters[0])


def phase_example(size, workdir):
    """P1: the example through `rt`, cold and warm."""
    from soc_tpu.cli import main
    ini = _example(workdir, size["p1_n"], size["p1_bgpackets"])
    out, ck = {}, clock()
    with captured_runs() as runs:
        for name in ("cold", "warm"):
            with ck.span(out, name), tagged_output():
                assert main(["rt", ini]) == 0
    r1, r2 = runs
    t, m = r2.temperature, r2.maps[0]
    uv = uv_mask(r2.freq)
    out.update(
        cells=int(r2.grid.cells), nfreq=len(r2.freq),
        timings=r2.timings,
        closure=closure(r2, 0.01),
        t_min=float(t.min()), t_max=float(t.max()),
        map_peak=float(m.max()),
        map_uv_peak=float(np.abs(m[uv]).max()),
        rerun_absorbed=rel_diff(r2.absorbed, r1.absorbed),
        rerun_t=float(np.abs(r2.temperature - r1.temperature).max()),
        rerun_map=rel_diff(r2.maps[0], r1.maps[0]))
    from soc_tpu.pipeline.driver import DEFAULT_LANES
    out["bg_packets"] = bg_packets(r2, size["p1_bgpackets"])
    out["bg_packets_per_s"] = out["bg_packets"] \
        / r2.timings["constant_sources"]
    out["loop_s_per_iter"] = loop_rate(ini, DEFAULT_LANES)
    out["loop_iters_per_s"] = 1.0 / out["loop_s_per_iter"]
    out["loop_lane_steps_per_s"] = 16 * DEFAULT_LANES \
        / out["loop_s_per_iter"]
    out["ok"] = bool(
        out["closure"] < CLOSURE_TOL and 10.0 <= out["t_min"]
        and out["t_max"] <= 20.0 and np.isfinite(m).all()
        and out["map_peak"] > 0
        and out["map_uv_peak"] <= 1e-10 * out["map_peak"]
        and np.isfinite(r2.absorbed).all())
    return out


def _compare_runs(ref, got, prefix, out):
    out[prefix + "ctabs_total"] = abs(got.ctabs.sum() / ref.ctabs.sum() - 1)
    out[prefix + "absorbed_good"] = good_fraction(got.absorbed, ref.absorbed,
                                                  CELL_RTOL)
    out[prefix + "t_good"] = good_fraction(got.temperature, ref.temperature,
                                           T_RTOL)
    out[prefix + "map_good"] = good_fraction(got.maps[0], ref.maps[0],
                                             CELL_RTOL)
    return (out[prefix + "ctabs_total"] < TOTAL_RTOL
            and min(out[prefix + k] for k in
                    ("absorbed_good", "t_good", "map_good")) > GOOD_FRACTION)


def phase_reference(size, workdir):
    """P2: the same small ini on the accelerator and on the CPU."""
    from soc_tpu.pipeline import driver
    ini = _example(workdir, size["p2_n"], size["p2_bgpackets"])
    out, ck = {}, clock()
    with ck.span(out, "device"):
        dev = driver.run(ini, lanes=size["p2_lanes"], write_files=False)
    with on_cpu(), ck.span(out, "cpu"):
        cpu = driver.run(ini, lanes=size["p2_lanes"], write_files=False)
    ok = _compare_runs(cpu, dev, "", out)
    out["closure"] = closure(dev, 0.01)
    out["ok"] = bool(ok and out["closure"] < CLOSURE_TOL)
    return out


LARGE_INI = """\
gridlength      0.01
cloud           large.cloud
density         1.0
seed            1.0
optical         tmp.dust
dsc             tmp.dsc 2500
bgpackets       1
background      bg_intensity.bin
mapping         64 64 {pix}
directions      0.0 0.0
iterations      1
prefix          large
absorbed        absorbed.data
emitted         emitted.data
temperature     large.T
{extra}"""


def write_large(size, workdir, name="large", extra=""):
    """P3's ini: the at-scale octree, bgpackets 1 (8 packets per surface
    element per simulated channel, the least the background source sends),
    simulated band cut by `simum` when the size says so."""
    from soc_tpu.io.example import write_dust_inputs, write_large_cloud
    write_dust_inputs(workdir)
    write_large_cloud(os.path.join(workdir, "large.cloud"), size["p3_n"])
    if size["p3_simum"]:
        extra = "simum %g %g\n" % size["p3_simum"] + extra
    path = os.path.join(workdir, name + ".ini")
    with open(path, "w") as fp:
        fp.write(LARGE_INI.format(pix=size["p3_n"] / 64.0, extra=extra))
    return path


def phase_large(size, workdir):
    """P3: the 16.8M-cell octree, tally [CELLS, NFREQ] on the device."""
    import jax
    from soc_tpu.pipeline import driver
    ini = write_large(size, workdir)
    out, ck = {}, clock()
    for name in ("cold", "warm"):
        with ck.span(out, name):
            res = driver.run(ini, lanes=size["p3_lanes"], write_files=False)
    sim = np.asarray(res.injected) > 0
    out.update(cells=int(res.grid.cells), levels=int(res.grid.levels),
               tally_bytes=int(res.grid.cells) * len(res.freq) * 4,
               channels_simulated=int(sim.sum()),
               packets=bg_packets(res, 1),
               cut="bgpackets 1 (8 packets per surface element and "
                   "channel, the least the background source sends)"
                   + (" + simum %g %g" % size["p3_simum"]
                      if size["p3_simum"] else ""),
               timings=res.timings, closure=closure(res, 0.01))
    out["bg_packets_per_s"] = out["packets"] / res.timings["constant_sources"]
    t = res.temperature[np.asarray(res.grid.dens) > 0]
    out["t_min"], out["t_max"] = float(t.min()), float(t.max())
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    out["ok"] = bool(out["closure"] < CLOSURE_TOL and np.isfinite(t).all()
                     and np.isfinite(res.maps[0]).all())
    return out


def a2e_solver(ne, freq):
    """GSET solver with 4 stochastic sizes on the example's grid."""
    from soc_tpu.io.example import gset_dust, isrf_absorptions
    from soc_tpu.solve import solver_prep
    dust = gset_dust(size_a=[5e-8, 1e-7, 3e-7, 1e-6],
                     s_frac=[0.4, 0.3, 0.2, 0.1])
    return solver_prep.build_solver(dust, freq, ne=ne), \
        isrf_absorptions(dust, freq)


def a2e_bytes_per_cell(ne, nfreq, nsize):
    """Least device-memory bytes per cell the XLA solve moves, from the
    shapes: per size the [NE, NE] heating matrix is written once, read and
    rewritten once by the fold, read once by the substitution, and the
    [NE] population vector is read and rewritten on each of NE rows; plus
    the absorbed row in and the emission row out."""
    return 4 * (nsize * (4 * ne * ne + 2 * ne * ne) + 2 * nfreq)


def phase_a2e(size, workdir):
    """P4: A2E on a million cells; 512 against the float64 oracle."""
    import jax
    from soc_tpu.io.example import example_freq
    from soc_tpu.solve import a2e_reference, stochastic
    out, ck = {}, clock()
    ne = size["p4_ne"]
    with ck.span(out, "prep"):
        solver, unit = a2e_solver(ne, example_freq())
    cells, nfreq = size["p4_cells"], solver.nfreq
    rng = np.random.default_rng(0)
    strength = (10.0 ** rng.uniform(0.0, 4.0, cells)).astype(np.float32)
    absorbed = strength[:, None] * unit[None, :]
    with ck.span(out, "first"):
        emitted = stochastic.solve_emission(solver, absorbed)
    with ck.span(out, "host"):
        emitted = stochastic.solve_emission(solver, absorbed)
    out["host_cells_per_s"] = cells / out["host_s"]

    nref = size["p4_ref_cells"]
    ref = a2e_reference.solve_emission(solver, absorbed[:nref])
    got = stochastic.solve_emission(solver, absorbed[:nref], clip_last=False)
    sig = ref > 1e-6 * ref.max(axis=1, keepdims=True)
    out["ref_max_rel"] = float((np.abs(got - ref)[sig] / ref[sig]).max())

    batch = min(16384, cells)
    stacks = stochastic.size_stacks(solver, solver.nsize)
    blk = jax.device_put(absorbed.reshape(-1, batch, nfreq))
    jax.block_until_ready(stochastic.solve_all_chunks(*stacks, blk, None,
                                                      ne))
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(stochastic.solve_all_chunks(*stacks, blk, None,
                                                          ne))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    out["device_s"] = best
    out["device_cells_per_s"] = cells / best
    out["bytes_per_cell"] = a2e_bytes_per_cell(ne, nfreq, solver.nsize)
    # share of the H100's 3.35 TB/s at that traffic (a lower bound)
    out["bandwidth_share"] = (out["device_cells_per_s"]
                              * out["bytes_per_cell"] / 3.35e12)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    out["ok"] = bool(np.isfinite(emitted).all() and emitted.max() > 0
                     and out["ref_max_rel"] < A2E_RTOL)
    return out


SCA_INI = """\
gridlength      0.01
cloud           tmp.cloud
mapping         {n} {n} 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc 2500
background      bg_intensity.bin
bgpackets       {bgpac}
iterations      1
simum           0.2 1.0
"""


def phase_sca(size, workdir):
    """P5: scattered light through `sca` on the device and on the CPU."""
    from soc_tpu.cli import main
    from soc_tpu.io.example import write_dust_inputs, write_uniform_cloud
    from soc_tpu.pipeline import scattering
    out, ck = {}, clock()
    inis = []
    for sub in ("device", "cpu"):
        d = os.path.join(workdir, sub)
        write_dust_inputs(d)
        write_uniform_cloud(os.path.join(d, "tmp.cloud"), size["p5_n"])
        with open(os.path.join(d, "sca.ini"), "w") as fp:
            fp.write(SCA_INI.format(n=size["p5_n"],
                                    bgpac=size["p5_bgpackets"]))
        inis.append(os.path.join(d, "sca.ini"))
    with ck.span(out, "device"), tagged_output():
        assert main(["sca", inis[0]]) == 0
    with on_cpu(), ck.span(out, "cpu"):
        scattering.run(inis[1], nlanes=1 << 14)

    def load(ini):
        with open(os.path.join(os.path.dirname(ini), "outcoming.socs"),
                  "rb") as fp:
            _, _, nf = np.fromfile(fp, np.int32, 3)
            np.fromfile(fp, np.float32, nf)
            return np.fromfile(fp, np.float32)

    dev, cpu = load(inis[0]), load(inis[1])
    out["total_rel"] = abs(float(dev.sum(dtype=np.float64)
                                 / cpu.sum(dtype=np.float64)) - 1.0)
    out["pixel_good"] = good_fraction(dev, cpu, CELL_RTOL)
    out["ok"] = bool(np.isfinite(dev).all() and dev.sum() > 0
                     and out["total_rel"] < TOTAL_RTOL)
    return out


def phase_four(size, workdir, n=4):
    """--four: P3's ini on one card, with `devices n` and `domains n`."""
    import jax
    import jax.numpy as jnp
    from soc_tpu.pipeline import driver
    from soc_tpu.parallel.product import ProductMesh, run_freqs
    out, ck = {}, clock()
    runs = {}
    for key, extra in (("one", ""), ("devices", "devices %d\n" % n),
                       ("domains", "domains %d\n" % n)):
        ini = write_large(size, workdir, key, extra)
        with ck.span(out, key):
            runs[key] = driver.run(ini, lanes=size["p3_lanes"],
                                   write_files=False)
        print("  %s: %.1f s (compile %.1f s)" % (
            key, out[key + "_s"], out[key + "_compile_s"]), flush=True)
    one = runs["one"]
    ok = _compare_runs(one, runs["devices"], "devices_", out)
    dom = runs["domains"]
    out["domains_ctabs_total"] = abs(dom.ctabs.sum() / one.ctabs.sum() - 1)
    out["domains_t_good"] = good_fraction(dom.temperature, one.temperature,
                                          T_RTOL)
    ok = ok and out["domains_ctabs_total"] < TOTAL_RTOL \
        and out["domains_t_good"] > GOOD_FRACTION

    # every card's share of the work: the per-channel tally shards of one
    # sharded background sweep, and each Z-slab's cells in the domains run
    from soc_tpu.io.dust import read_simple_dust, read_scattering_function
    from soc_tpu.transport.medium import medium_from_optics
    grid = one.grid
    optics = [read_simple_dust(os.path.join(workdir, "tmp.dust"), 0.01)]
    freq = optics[0].freq
    dsc, csc = read_scattering_function(os.path.join(workdir, "tmp.dsc"),
                                        len(freq), 2500)
    medium = medium_from_optics(optics, dsc, csc, freq)
    pm = ProductMesh(n, len(freq))
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = pm.zeros_intf(grid.cells)
    per_freq = 1 << 16
    tabs, intf, _, _, _ = run_freqs(
        pm, grid, medium, "bg", lambda i: dict(photons=jnp.float32(1.0)),
        per_freq, tabs, intf, 7, size["p3_lanes"], True)
    out["devices_shard_sums"] = [float(np.asarray(s.data).sum())
                                 for s in intf.addressable_shards]
    nx, nz = grid.nx, grid.nz
    root = np.asarray(dom.ctabs)[: nx * grid.ny * nz].reshape(nz, -1)
    out["domains_slab_sums"] = [float(s.sum()) for s in
                                np.array_split(root, n)]
    out["shards_nonzero"] = bool(
        len(out["devices_shard_sums"]) == n
        and min(out["devices_shard_sums"]) > 0
        and min(out["domains_slab_sums"]) > 0)
    out["devices_mesh"] = dict(dp=pm.n_dp, freq=pm.n_freq)
    out["device_count"] = len(jax.devices())
    out["ok"] = bool(ok and out["shards_nonzero"])
    return out


PHASES = [("P1 example rt", phase_example),
          ("P2 reference cpu", phase_reference),
          ("P3 at scale", phase_large),
          ("P4 a2e", phase_a2e),
          ("P5 sca", phase_sca)]


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, dict):
        return "{" + ", ".join("%s: %s" % (k, _fmt(x))
                               for k, x in v.items()) + "}"
    return str(v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card devices/domains comparison")
    args = ap.parse_args(argv)
    try:
        import jax
        import soc_tpu  # noqa: F401
    except ImportError as e:
        print(json.dumps({"ok": False, "error": "import: %s" % e}))
        return 2
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"ok": False, "error": "no GPU: JAX found %s"
                          % dev.platform}))
        return 1
    from soc_tpu.utils.cache import enable_compile_cache
    cache = enable_compile_cache()
    where = card()
    print("jax %s, compile cache %s" % (jax.__version__, cache))
    phases = [("four-card", phase_four)] if args.four else PHASES
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as tmp:
        for name, fn in phases:
            wd = os.path.join(tmp, name.split()[0])
            os.makedirs(wd)
            t0 = time.perf_counter()
            try:
                res = fn(FULL, wd)
            except Exception:
                traceback.print_exc()
                res = {"ok": False}
            ok = ok and res.get("ok", False)
            print("%s [%s]: %.1f s; %s" % (name, where,
                                           time.perf_counter() - t0,
                                           _fmt(res)), flush=True)
    print(where)
    print(json.dumps({"ok": bool(ok), "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
