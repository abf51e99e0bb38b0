"""Multi-chip execution: packet data-parallelism x frequency parallelism.

The reference is strictly single-device (SURVEY.md section 2.4); its implicit
parallel axes are packets (work items) and the serial frequency loop. Here
both become mesh axes:

  * 'dp'   -- packet data-parallel: every device simulates an id-disjoint
              slice of the packet budget (RNG streams are keyed by global
              (phase|freq, in-freq index) ids, so results are device-count
              invariant); per-cell tallies are reduced with psum.
  * 'freq' -- frequency-parallel: frequency channels are blocked over the
              second axis; each block runs its channels' transport locally
              and the integrated tally is psum'ed (the trapezoid sum over
              frequency is a linear reduction, so it commutes with psum).

Every pipeline phase is covered: the constant sources (bg / healpix bg /
point sources), the cell-emission iteration hot path, the equilibrium
temperature solve + thermal emission (cells sharded over the whole mesh),
and orthographic map rendering (pixel rows over dp, frequencies over freq).
`sharded_pipeline` chains them into the full simulate->solve->map run.
Spatial domain decomposition of the grid itself lives in
soc_tpu.parallel.domain.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..transport.propagate import transport_run
from ..transport.sources import stream_hi_base


def make_mesh(devices=None, freq_axis=1):
    """Build a (dp, freq) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % freq_axis != 0:
        freq_axis = 1
    dp = n // freq_axis
    dev = np.asarray(devices).reshape(dp, freq_axis)
    return Mesh(dev, ("dp", "freq"))


def _sharded_transport(grid, medium, mesh, kind, hi_base, per_freq,
                       make_params, seed, nlanes, max_iters, extra_specs=(),
                       extra_args=()):
    """Generic (dp x freq)-sharded uniform-frequency transport sweep.

    make_params(fl, gfreq, extras) builds the per-frequency source params
    INSIDE the shard (fl = local channel, gfreq = global channel index,
    extras = the shard-local slices of extra_args). Per-frequency arrays in
    extra_args are sharded along their leading NFREQ axis.
    Returns (tabs [CELLS] fully reduced, escaped [NFREQ]).
    """
    nf = medium.nfreq
    n_freq_ax = mesh.shape["freq"]
    n_dp = mesh.shape["dp"]
    assert nf % n_freq_ax == 0, "NFREQ must divide the freq mesh axis"
    assert per_freq % n_dp == 0, "per_freq must divide the dp mesh axis"
    nf_local = nf // n_freq_ax
    per_dev = per_freq // n_dp

    in_specs = (P("freq"), P("freq"), P("freq", None), P("freq"),
                *extra_specs)

    @partial(shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=(P(), P("freq")), check_vma=False)
    def run(kabs_l, ksca_l, csc_l, tw_l, *extras):
        fq = lax.axis_index("freq")
        dp = lax.axis_index("dp")
        tabs = jnp.zeros(grid.cells, jnp.float32)
        intf = jnp.zeros((1, 1), jnp.float32)
        esc_l = []
        for fl in range(nf_local):
            gfreq = (fq * nf_local + fl).astype(jnp.int32)
            physics = dict(kabs=kabs_l[fl], ksca=ksca_l[fl],
                           csc=csc_l[fl], tw=tw_l[fl])
            params = make_params(fl, gfreq, extras)
            params.update(ifreq=gfreq,
                          per_freq=jnp.int32(per_freq),
                          k0=(dp * per_dev).astype(jnp.uint32),
                          hi_base=jnp.uint32(hi_base))
            tabs, intf, esc, absd = transport_run(
                grid, physics, params, jnp.int32(per_dev), tabs, intf,
                seed, source_kind=kind, nlanes=nlanes, max_iters=max_iters)
            esc_l.append(esc[0])
        tabs = lax.psum(tabs, ("dp", "freq"))
        esc = lax.psum(jnp.stack(esc_l), "dp")
        return tabs, esc

    return run(medium.abs_gl, medium.sca_gl, medium.csc, medium.tw,
               *extra_args)


def sharded_background_run(grid, medium, bg_photons, per_freq, seed, mesh,
                           nlanes=1 << 14, max_iters=1 << 30):
    """Distributed phase-1 isotropic background simulation.

    bg_photons : [NFREQ] photons per packet per frequency (host array)
    per_freq   : packets per frequency (split over the dp axis)
    """
    bg_photons = jnp.asarray(bg_photons, jnp.float32)

    def make_params(fl, gfreq, extras):
        return dict(photons=extras[0][fl])

    return _sharded_transport(
        grid, medium, mesh, "bg", stream_hi_base("bg"), per_freq,
        make_params, seed, nlanes, max_iters,
        extra_specs=(P("freq"),), extra_args=(bg_photons,))


def sharded_point_source_run(grid, medium, ps_pos, ps_photons, per_freq,
                             seed, mesh, nlanes=1 << 14, max_iters=1 << 30):
    """Distributed point-source simulation.

    ps_pos : [S, 3]; ps_photons : [S, NFREQ] photons/packet (host arrays).
    """
    ps_pos = jnp.asarray(ps_pos, jnp.float32)
    # shard over the frequency axis: [NFREQ, S]
    phot = jnp.asarray(np.asarray(ps_photons, np.float32).T)

    def make_params(fl, gfreq, extras):
        return dict(ps_pos=ps_pos, photons=extras[0][fl])

    return _sharded_transport(
        grid, medium, mesh, "ps", stream_hi_base("ps"), per_freq,
        make_params, seed, nlanes, max_iters,
        extra_specs=(P("freq", None),), extra_args=(phot,))


def sharded_hpbg_run(grid, medium, hpbg_photons, per_freq, seed, mesh,
                     nlanes=1 << 14, max_iters=1 << 30):
    """Distributed healpix-sky background simulation.

    hpbg_photons : [NFREQ, NPIX] photons per packet per sky pixel.
    """
    hp = jnp.asarray(hpbg_photons, jnp.float32)

    def make_params(fl, gfreq, extras):
        return dict(hpbg=extras[0][fl], cdf=None)

    return _sharded_transport(
        grid, medium, mesh, "hpbg", stream_hi_base("hpbg"), per_freq,
        make_params, seed, nlanes, max_iters,
        extra_specs=(P("freq", None),), extra_args=(hp,))


def sharded_cell_emission_run(grid, medium, emitted, per_cell, seed, mesh,
                              iteration=0, nlanes=1 << 14,
                              max_iters=1 << 30):
    """Distributed dust re-emission (the iteration hot path, SimRAM_CL).

    emitted : [CELLS, NFREQ] photons/Hz/H; photon weight EMIT/per_cell,
    packets per frequency = per_cell * CELLS split over dp.
    """
    per_freq = per_cell * grid.cells
    emit_t = jnp.asarray(np.asarray(emitted, np.float32).T
                         / np.float32(per_cell))          # [NFREQ, CELLS]

    def make_params(fl, gfreq, extras):
        return dict(emit=extras[0][fl], per_cell=jnp.int32(per_cell))

    return _sharded_transport(
        grid, medium, mesh, "cell", stream_hi_base("cell", iteration),
        per_freq, make_params, seed, nlanes, max_iters,
        extra_specs=(P("freq", None),), extra_args=(emit_t,))


def sharded_solve_temperature(grid, table, emit_total, gl_cm, mesh,
                              cr_heating=0.0):
    """Equilibrium T solve with cells sharded over the whole mesh.

    The per-cell lookup is embarrassingly parallel; cells are blocked over
    the flattened (dp, freq) axes and the result all-gathered.
    Returns temperature [CELLS] (replicated).
    """
    from ..constants import FACTOR, PLANCK
    from ..solve.equilibrium import cell_levels
    ndev = mesh.devices.size
    cells = grid.cells
    pad = (-cells) % ndev
    lev = jnp.pad(cell_levels(grid), (0, pad))
    dens = jnp.pad(grid.dens, (0, pad))
    tabs = jnp.pad(jnp.asarray(emit_total), (0, pad))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(("dp", "freq")), P(("dp", "freq")),
                       P(("dp", "freq"))),
             out_specs=P(("dp", "freq")), check_vma=False)
    def solve(tabs_l, dens_l, lev_l):
        from ..solve.equilibrium import temperature_lookup
        return temperature_lookup(table, tabs_l, dens_l, lev_l, gl_cm,
                                  cr_heating=cr_heating)

    t = solve(tabs, dens, lev)
    return t[:cells]


def sharded_emission(freq, abs_gl, temperature, gl_cm, mesh):
    """Thermal emission [CELLS, NFREQ] with cells sharded over the mesh."""
    from ..solve.equilibrium import emission
    ndev = mesh.devices.size
    cells = temperature.shape[0]
    pad = (-cells) % ndev
    t = jnp.pad(jnp.asarray(temperature), (0, pad))
    freq = jnp.asarray(freq, jnp.float32)
    abs_gl = jnp.asarray(abs_gl, jnp.float32)

    @partial(shard_map, mesh=mesh, in_specs=P(("dp", "freq")),
             out_specs=P(("dp", "freq"), None), check_vma=False)
    def emit(t_l):
        return emission(freq, abs_gl, t_l, gl_cm)

    return emit(t)[:cells]


def sharded_render_ortho(grid, emit_map, ext_gl, odir, ra, de, centre,
                         map_dx, npix, mesh):
    """Orthographic map with pixel rows sharded over dp and frequency
    channels over the freq axis.

    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]).
    """
    from ..render.mapping import render_ortho
    nxp, nyp = npix
    n_dp = mesh.shape["dp"]
    n_freq_ax = mesh.shape["freq"]
    nf = emit_map.shape[1]
    assert nyp % n_dp == 0, "NY must divide the dp axis"
    assert nf % n_freq_ax == 0, "NF must divide the freq axis"
    nrows = nyp // n_dp

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, "freq"), P("freq")),
             out_specs=(P("freq", "dp", None), P("freq", "dp", None),
                        P("dp", None)), check_vma=False)
    def render(emit_l, ext_l):
        dp = lax.axis_index("dp")
        phot, tau, colden = render_ortho(
            grid, emit_l, ext_l, odir, ra, de, centre, map_dx,
            (nxp, nyp), row0=dp * nrows, nrows=nrows)
        # colden is frequency-independent: replicated over freq, emit one
        return phot, tau, colden

    return render(jnp.asarray(emit_map), jnp.asarray(ext_gl))


def sharded_pipeline(grid, medium, freq, bg_photons, per_freq, gl_pc,
                     mesh, iterations=1, per_cell=1, npix=(16, 16),
                     centre=None, obs=(0.0, 0.0), seed=7,
                     nlanes=1 << 12, max_iters=1 << 30):
    """Full simulate -> solve -> re-emit -> map pipeline over the mesh.

    The multi-chip mirror of pipeline.driver._run_inner's core path:
    phase-1 background, equilibrium T solve + emission, `iterations`
    rounds of sharded cell re-emission, and a sharded orthographic map.
    Returns dict(tabs, escaped, temperature, emitted, map, tau, colden).
    """
    from ..render.mapping import map_scale_kk, observer_basis
    from ..solve.equilibrium import build_temperature_table
    from ..constants import PARSEC
    gl_cm = gl_pc * PARSEC
    tabs, esc = sharded_background_run(grid, medium, bg_photons, per_freq,
                                       seed, mesh, nlanes=nlanes,
                                       max_iters=max_iters)
    table = build_temperature_table(freq, medium.abs_gl, gl_pc)
    emit_total = tabs
    temperature = emitted = None
    for iteration in range(max(1, iterations)):
        if per_cell > 0 and emitted is not None:
            tabs_it, _ = sharded_cell_emission_run(
                grid, medium, emitted, per_cell, seed, mesh,
                iteration=iteration, nlanes=nlanes, max_iters=max_iters)
            emit_total = tabs_it + tabs
        temperature = sharded_solve_temperature(grid, table, emit_total,
                                                gl_cm, mesh)
        emitted = sharded_emission(freq, medium.abs_gl, temperature, gl_cm,
                                   mesh)
        if per_cell <= 0:
            break
    if centre is None:
        centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
    kk = map_scale_kk(gl_pc)
    emit_map = (jnp.asarray(emitted)
                * (kk * jnp.asarray(freq, jnp.float32))[None, :]
                ).astype(jnp.float32)
    ext_gl = medium.abs_gl + medium.sca_gl
    odir, ra, de = observer_basis(*obs)
    phot, tau, colden = sharded_render_ortho(
        grid, emit_map, ext_gl, jnp.asarray(odir), jnp.asarray(ra),
        jnp.asarray(de), jnp.asarray(centre, jnp.float32), 1.0, npix, mesh)
    return dict(tabs=tabs, escaped=esc, temperature=temperature,
                emitted=emitted, map=phot, tau=tau, colden=colden)
