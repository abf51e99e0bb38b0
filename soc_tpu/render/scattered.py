"""Scattered-light imaging with peel-off (the ASOCS workload).

Reference: ASOCS.py + kernel_ASOC_sca.c. Packets propagate without absorption
tallies (attenuation is applied at scattering events as
exp(-free_path * k_abs/k_sca), kernel_ASOC_sca.c:290-300); at every
scattering a *deterministic* ray is peeled off toward each observer:

    OUT[idir, pix] += PHOTONS * exp(-tau_LOS) * DSC(cos theta)

with forced first scattering (FFS) at packet birth: the entry ray's total
scattering depth tau gives W = 1-exp(-tau), free_path = -log(1 - W u),
PHOTONS *= W (kernel_ASOC_sca.c:227-244).

Structure -- three jitted phases alternated from the host:
  A. spawn: generate a full pool of packets + vectorized FFS march
  B. propagate: masked-lane loop until the pool dies OR the event buffer is
     nearly full; scattering events are appended via a prefix-sum
  C. peel-off: march every buffered event's LOS to the surface for each
     observer (full-occupancy vectorized marches) and scatter-add into maps

This event-based split keeps the expensive LOS marches at ~100% lane
occupancy instead of wasting a marching loop on the ~2% of lanes that
scatter in any given propagation step.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..constants import MAX_SCATTERINGS, PEPS
from ..ops import traverse
from ..transport.propagate import PacketBatch, _deflect, _csc_lookup
from .. import rng as socrng


@jax.tree_util.register_dataclass
@dataclass
class ScatterEvents:
    """Fixed-capacity event buffer [E]."""

    pos: jax.Array        # [E, 3] level-local position of the scattering
    level: jax.Array      # [E]
    ind: jax.Array        # [E]
    dir: jax.Array        # [E, 3] packet direction at the scattering
    photons: jax.Array    # [E]
    valid: jax.Array      # [E] bool


# Peel-off rays and FFS chords stop once the accumulated optical depth
# exceeds this: exp(-30) ~ 9e-14, below the float32 resolution of any
# map pixel. The reference marches to the surface unconditionally
# (kernel_ASOC_sca.c:310-412) -- the truncation changes results by a
# bounded < 1e-13 relative amount while skipping the optically-dead
# tail of every sightline in thick models.
TAU_PEEL_CUT = 30.0


def _march_tau(grid, pos, level, ind, dir, ext, active, max_steps=None,
               max_dist=None, tau_cut=None):
    """Vectorized LOS march to the surface accumulating ext optical depth.

    Returns (tau, exit_pos). ext is k_abs+k_sca (peel-off) or k_sca (FFS),
    a scalar for the uniform-frequency path. max_dist (per-ray, GL units)
    stops the march at the observer (the reference's min(dx, GetStep) in
    the internal-observer peel-off, kernel_ASOC_sca.c:300-312). tau_cut
    terminates rays whose attenuation is already numerically zero
    (TAU_PEEL_CUT above).

    max_steps defaults to a bound no straight ray can exceed -- a diagonal
    crossing at the deepest refinement plus slack -- so long sightlines on
    large refined grids are never silently truncated (the reference
    marches unbounded).
    """
    if max_steps is None:
        max_steps = 8 * (grid.nx + grid.ny + grid.nz) \
            * (1 << (grid.levels - 1)) + 1024
    if max_dist is None:
        max_dist = jnp.full(pos.shape[0], jnp.inf, jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, left = state
        live = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, dir, level, ind, anc, live)
        failed = live & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, dir, failed)
        w = jnp.minimum(ds, left)
        tau = tau + jnp.where(live, w * dens * ext, 0.0)
        left = jnp.where(live, left - w, left)
        nind = jnp.where(left <= 0.0, -1, nind)
        if tau_cut is not None:
            nind = jnp.where(tau > tau_cut, -1, nind)
        return it + 1, npos, nlevel, nind, anc, tau, left

    ind = jnp.where(active, ind, -1)
    tau = jnp.zeros(pos.shape[0], jnp.float32)
    state = (jnp.int32(0), pos, level, ind,
             traverse.stack_from_par(grid, level, ind), tau,
             jnp.asarray(max_dist, jnp.float32))
    _, pos, _, _, _, tau, _ = lax.while_loop(cond, body, state)
    return tau, pos


def _ffs_hash2(seed, stream, hi, k):
    """Two deterministic uniforms in [0, 1) for the reservoir FFS: a
    murmur3-style integer finalizer of (seed, stream id, segment index).

    Selection-only randomness -- the FFS weight w and the per-segment
    probabilities stay exact, the hash only picks WHICH segment wins the
    reservoir -- so a full 13-round counter RNG per march step would buy
    nothing measurable; reproducibility is the same (pure function of the
    packet identity and segment index)."""
    x = (stream ^ (hi * jnp.uint32(0x9E3779B9))
         ^ (k * jnp.uint32(0x85EBCA6B)) ^ seed)
    # one murmur3 finalizer for the selection uniform; the within-segment
    # offset uniform gets a cheap decorrelating mix of the same state
    # (it only shapes the sub-cell position, not the segment weights)
    a = x ^ (x >> jnp.uint32(16))
    a = a * jnp.uint32(0x7FEB352D)
    a = a ^ (a >> jnp.uint32(15))
    a = a * jnp.uint32(0x846CA68B)
    a = a ^ (a >> jnp.uint32(16))
    c = a * jnp.uint32(0x9E3779B9)
    c = c ^ (c >> jnp.uint32(16))
    scale = jnp.float32(1.0 / (1 << 24))
    return ((a >> jnp.uint32(8)).astype(jnp.float32) * scale,
            (c >> jnp.uint32(8)).astype(jnp.float32) * scale)


def _reservoir_update(ksca, seed, stream, hi, rk, pos, dir, level, ind,
                      dens, tau, dtau, update, res):
    """One segment of the single-pass FFS reservoir.

    The forced first scattering samples the first-interaction law
    p(s) ds = ksca rho(s) exp(-tau(s)) ds / w along the entry chord
    (kernel_ASOC_sca.c:227-244 draws the quantile AFTER a full tau
    march and re-marches to it -- two chords). Reservoir sampling picks
    the same distribution in ONE pass: with A_k = 1-exp(-tau_k) the
    running unnormalized CDF, segment k replaces the candidate with
    probability (A_k - A_{k-1})/A_k, and the within-segment offset is the
    truncated exponential -log1p(-v (1-exp(-dtau))). Exact for ideal
    uniforms regardless of the hash; the FFS weight is A_N = w as before.

    res: dict(pos, level, ind, tau, A) -- candidate state + running CDF.
    """
    a_new = -jnp.expm1(-(tau + dtau))
    u1, u2 = _ffs_hash2(seed, stream, hi, rk)
    # u1 < (a_new - A)/a_new, division-free (a_new == 0 -> no replace)
    rep = update & (u1 * a_new < a_new - res["A"])
    t_in = -jnp.log1p(-u2 * (-jnp.expm1(-dtau)))
    dxl = jnp.maximum(
        0.0, t_in / jnp.maximum(ksca * dens, 1e-30)
        * jnp.exp2(level.astype(jnp.float32)) - 2.0 * PEPS)
    return {
        "pos": jnp.where(rep[:, None], pos + dxl[:, None] * dir,
                         res["pos"]),
        "level": jnp.where(rep, level, res["level"]),
        "ind": jnp.where(rep, ind, res["ind"]),
        "tau": jnp.where(rep, tau + t_in, res["tau"]),
        "A": jnp.where(update, a_new, res["A"]),
    }


def _march_ffs(grid, ksca, seed, pos, level, ind, dir, stream, hi,
               max_steps=None):
    """Single-pass forced-first-scattering chord march: accumulate the
    total scattering depth AND reservoir-sample the forced scattering
    point in the same sweep (see _reservoir_update -- the two-march
    chord+flight of the reference collapses to one chord).

    Returns (w, cand_pos, cand_level, cand_ind, cand_tau)."""
    if max_steps is None:
        max_steps = 8 * (grid.nx + grid.ny + grid.nz) \
            * (1 << (grid.levels - 1)) + 1024
    n = pos.shape[0]
    res = dict(pos=pos, level=level, ind=ind,
               tau=jnp.zeros(n, jnp.float32), A=jnp.zeros(n, jnp.float32))

    def cond(state):
        it = state[0]
        return (it < max_steps) & jnp.any(state[3] >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, rk, res = state
        live = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, dir, level, ind, anc, live)
        failed = live & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, dir, failed)
        dtau = jnp.where(live, ds * dens * ksca, 0.0)
        res = _reservoir_update(ksca, seed, stream, hi, rk, pos, dir,
                                level, ind, dens, tau, dtau, live, res)
        tau = tau + dtau
        rk = rk + live.astype(jnp.uint32)
        nind = jnp.where(tau > TAU_PEEL_CUT, -1, nind)
        return it + 1, npos, nlevel, nind, anc, tau, rk, res

    ind0 = ind
    state = (jnp.int32(0), pos, level, ind,
             traverse.stack_from_par(grid, level, ind),
             jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.uint32), res)
    _, _, _, _, _, tau, _, res = lax.while_loop(cond, body, state)
    # dead-at-birth lanes never updated: keep their ind at -1
    cind = jnp.where(ind0 >= 0, res["ind"], -1)
    return res["A"], res["pos"], res["level"], cind, res["tau"]


@partial(jax.jit, static_argnames=("source_kind", "nlanes", "ffs"))
def spawn(grid, physics, source_params, total_packets, next_id, seed,
          source_kind="bg", nlanes=1 << 14, ffs=True):
    """Phase A: fill the pool with fresh packets + forced first scattering.

    With ffs the returned batch is already FROZEN AT its forced
    scattering point (pending=True): the single-pass reservoir march
    (_march_ffs) samples the scattering location during the same chord
    sweep that measures the FFS weight w, so the flight re-march of the
    two-pass scheme never happens. The expm1/log1p forms guard the
    optically thin channels (naive 1-exp(-tau) quantized the FFS weight
    by ~10% and lost 62% of forced scatterings at 60um on the
    soc_example dust).

    Returns (b, free_path, pending, next_id); feed pending straight into
    propagate_events, whose first service pass appends the forced events.
    """
    from ..transport.sources import GENERATORS
    seed = jnp.uint32(seed)
    ids = next_id + jnp.arange(nlanes, dtype=jnp.int32)
    can = ids < total_packets
    ids_local = jnp.where(can, ids, 0)
    b = GENERATORS[source_kind](grid, ids_local, seed, source_params)
    ind = jnp.where(can, b.ind, -1)

    photons = b.photons
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    if ffs:
        w, cpos, clevel, cind, ctau = _march_ffs(
            grid, ksca, seed, b.pos, b.level, ind, b.dir, b.stream, b.hi)
        # weight = w (the FFS bias) times the absorption attenuation up
        # to the scattering depth (applied at the scattering in the
        # two-pass scheme, kernel_ASOC_sca.c:296-300)
        photons = photons * w * jnp.exp(-ctau * kabs
                                        / jnp.maximum(ksca, 1e-30))
        ind = jnp.where(w < 1.0e-22, -1, cind)
        pos, level = cpos, clevel
        pending = ind >= 0
        scat = jnp.where(pending, 1, 0)
        free_path = jnp.zeros(nlanes, jnp.float32)
    else:
        # birth free path (counter slot 2, same as transport_run)
        u = socrng.uniform1(seed, b.stream,
                            jnp.full_like(b.stream, 2), b.hi)
        free_path = -jnp.log(u)
        pos, level = b.pos, b.level
        pending = jnp.zeros(nlanes, bool)
        scat = b.scatterings

    b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                    photons=photons, ifreq=b.ifreq, stream=b.stream,
                    hi=b.hi, counter=b.counter + jnp.uint32(1),
                    scatterings=scat, e_cell=b.e_cell)
    return b, free_path, pending, next_id + jnp.int32(nlanes)


def _pack_event_rows(pos, dir, photons, level, ind):
    """One packed event row per lane: pos3 | dir3 | photons | level | ind
    (ints bit-cast to float32) -- the wire format of the event buffer."""
    as_f = lambda x: lax.bitcast_convert_type(x, jnp.float32)
    return jnp.concatenate([pos, dir, photons[:, None],
                            as_f(level)[:, None], as_f(ind)[:, None]],
                           axis=1)


def _unpack_events(evbuf, ecount, capacity):
    """Inverse of _pack_event_rows over the whole buffer."""
    as_i = lambda x: lax.bitcast_convert_type(x, jnp.int32)
    return ScatterEvents(
        pos=evbuf[:, 0:3], dir=evbuf[:, 3:6], photons=evbuf[:, 6],
        level=as_i(evbuf[:, 7]), ind=as_i(evbuf[:, 8]),
        valid=jnp.arange(capacity) < ecount)


def _service_scatter(grid, physics, seed, capacity, b, act,
                     evbuf, ecount, free_path, tau):
    """The scattering service shared by propagate_events and sca_run --
    their per-packet RNG sequences are documented bit-identical, and
    sharing this body makes that parity structural instead of
    copy-discipline. For the act lanes (frozen at their scattering
    point): append the peel-off event, draw the new direction (species
    roulette ~ ABU[cell]*SCA then that species' CSC under WITH_MSF,
    kernel_ASOC.c:786-795; else the tabulated inverse-CDF), kill lanes
    that reached the scattering cap after this final event
    (kernel_ASOC_sca.c:437), and reset free-path/tau progress.

    Returns (evbuf, ecount, dir, ind, counter, free_path, tau)."""
    csc = physics["csc"]
    bins = csc.shape[-1]
    sc = act.astype(jnp.int32)
    rank = jnp.cumsum(sc) - sc
    slot = jnp.where(act, ecount + rank, capacity)   # OOB drop
    evbuf = evbuf.at[slot].set(
        _pack_event_rows(b.pos, b.dir, b.photons, b.level, b.ind),
        mode="drop")
    ecount = ecount + jnp.sum(sc)

    u_bin, u_phi, u_fp, u_sp = socrng.uniform4(seed, b.stream,
                                               b.counter, b.hi)
    if "msf_csc" in physics:
        gidx = jnp.clip(grid.off[jnp.clip(b.level, 0, grid.levels - 1)]
                        + jnp.maximum(b.ind, 0), 0, grid.cells - 1)
        msf_csc = physics["msf_csc"]            # [NDUST, BINS]
        wspec = (physics["msf_abu"][gidx, :]
                 * physics["msf_sca"][None, :])
        cdf = jnp.cumsum(wspec, axis=1)
        r = 0.99999 * u_sp * cdf[:, -1]
        species = jnp.sum((cdf < r[:, None]).astype(jnp.int32), axis=1)
        species = jnp.clip(species, 0, msf_csc.shape[0] - 1)
        bin_idx = jnp.clip((u_bin * bins).astype(jnp.int32), 0, bins - 1)
        cos_theta = msf_csc[species, bin_idx]
    else:
        cos_theta = _csc_lookup(csc, b.ifreq, u_bin, bins)
    new_dir = jnp.where(
        act[:, None], _deflect(b.dir, cos_theta, (2.0 * jnp.pi) * u_phi),
        b.dir)
    over = act & (b.scatterings >= MAX_SCATTERINGS)
    ind = jnp.where(over, -1, b.ind)
    counter = b.counter + act.astype(jnp.uint32)
    free_path = jnp.where(act, -jnp.log(u_fp), free_path)
    tau = jnp.where(act, 0.0, tau)
    return evbuf, ecount, new_dir, ind, counter, free_path, tau


@partial(jax.jit, static_argnames=("capacity", "max_iters",
                                   "service_period"))
def propagate_events(grid, physics, b, free_path, tau, pending, events,
                     ecount, seed, capacity=1 << 16, max_iters=1 << 20,
                     service_period=4):
    """Phase B: step the pool, appending scattering events, until the pool
    is dead or the buffer cannot hold another full-pool round of events.

    March/service split (same as transport_run): the march steps do pure
    geometry + tau accumulation and FREEZE lanes whose free path ends;
    a periodic service pass then handles every frozen lane at once --
    the event append (one packed row scatter: pos3 | dir3 | photons |
    level | ind bit-cast), the RNG draw, the deflection and the new free
    path. RNG is consumed per scattering event, so a packet's sequence is
    independent of the marching cadence.

    (tau, pending) are part of the persistent pool state: a capacity-bound
    exit must not reset a lane's optical-depth progress (that would
    stretch its free path) nor lose its frozen-event flag -- the caller
    flushes the buffer and calls again with the same pool.
    """
    seed = jnp.uint32(seed)
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    nlanes = b.lanes
    evbuf0 = _pack_event_rows(events.pos, events.dir, events.photons,
                              events.level, events.ind)

    def service(b, pending, free_path, tau, evbuf, ecount, anc):
        # b.dir is still the INCOMING direction; b.pos froze at the
        # scattering point -- _service_scatter appends + redirects
        act = pending & (b.ind >= 0)
        evbuf, ecount, dirx, ind, counter, free_path, tau = \
            _service_scatter(grid, physics, seed, capacity, b, act,
                             evbuf, ecount, free_path, tau)
        nb = PacketBatch(
            pos=b.pos, dir=dirx, level=b.level, ind=ind,
            photons=b.photons, ifreq=b.ifreq, stream=b.stream, hi=b.hi,
            counter=counter, scatterings=b.scatterings, e_cell=b.e_cell)
        return nb, pending & ~act, free_path, tau, evbuf, ecount, anc

    def march(b, pending, free_path, tau, evbuf, ecount, anc):
        alive = b.ind >= 0
        active = alive & ~pending
        gidx = jnp.clip(grid.off[jnp.clip(b.level, 0, grid.levels - 1)]
                        + jnp.maximum(b.ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
        ds_gl = ds_local * jnp.exp2(-b.level.astype(jnp.float32))
        dtau_sca = ds_gl * dens * ksca
        scatter_now = active & (free_path < tau + dtau_sca)

        # scattering position: partial step within the current cell
        dx_gl = (free_path - tau) / jnp.maximum(ksca * dens, 1e-30)
        dx_local = jnp.maximum(
            0.0, dx_gl * jnp.exp2(b.level.astype(jnp.float32)) - 2.0 * PEPS)
        pos_scatter = b.pos + dx_local[:, None] * b.dir
        # attenuation by absorption along the whole free path
        # (kernel_ASOC_sca.c:296-300)
        photons = jnp.where(
            scatter_now,
            b.photons * jnp.exp(-free_path * kabs
                                / jnp.maximum(ksca, 1e-30)),
            b.photons)

        posx = jnp.where(active[:, None], pos_boundary, b.pos)
        cross = active & ~scatter_now
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, anc, cross)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)

        pos = jnp.where(scatter_now[:, None], pos_scatter, npos)
        level = jnp.where(scatter_now, b.level, nlevel)
        ind = jnp.where(scatter_now, b.ind, nind)
        scat = b.scatterings + scatter_now.astype(jnp.int32)
        pending = pending | scatter_now
        tau = jnp.where(scatter_now, free_path,
                        jnp.where(cross, tau + dtau_sca, tau))
        nb = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                         photons=photons, ifreq=b.ifreq, stream=b.stream,
                         hi=b.hi, counter=b.counter,
                         scatterings=scat, e_cell=b.e_cell)
        return nb, pending, free_path, tau, evbuf, ecount, anc

    def cond(state):
        it, b, pending, fp, tau, evbuf, ecount, anc = state
        return ((it < max_iters) & jnp.any(b.ind >= 0)
                & (ecount + nlanes <= capacity))

    def body(state):
        it, b, pending, free_path, tau, evbuf, ecount, anc = state
        st = (b, pending, free_path, tau, evbuf, ecount, anc)
        st = service(*st)
        st = lax.fori_loop(0, service_period, lambda _, s: march(*s), st)
        b, pending, free_path, tau, evbuf, ecount, anc = st
        return it + 1, b, pending, free_path, tau, evbuf, ecount, anc

    state = (jnp.int32(0), b, pending, free_path, tau, evbuf0, ecount,
             traverse.stack_from_par(grid, b.level, b.ind))
    state = lax.while_loop(cond, body, state)
    _, b, pending, free_path, tau, evbuf, ecount, _ = state
    # the loop only exits with every lane dead (all owed events already
    # appended by the service that killed them) or capacity-bound (frozen
    # lanes stay pending for the caller's next invocation)
    events = _unpack_events(evbuf, ecount, capacity)
    return b, free_path, tau, pending, events, ecount


def _dsc_value(physics, gidx, cos_theta):
    """Phase-function value for a peel-off ray given the scattering cell.

    With multiple scattering functions (WITH_MSF) the reference picks a
    random dust ~ ABU*SCA and uses its DSC (kernel_ASOC_sca.c:340-348);
    here the expectation of that draw -- the abundance-weighted mean DSC --
    is used directly (same mean, strictly lower variance, no extra RNG).
    """
    dsc = physics["dsc"]
    bins = dsc.shape[-1]
    bin_idx = jnp.clip(((1.0 + cos_theta) * 0.5 * bins).astype(jnp.int32),
                       0, bins - 1)
    if "msf_dsc" in physics:
        w = physics["msf_abu"][gidx, :] * physics["msf_sca"][None, :]
        vals = physics["msf_dsc"][:, bin_idx]          # [NDUST, E]
        return jnp.sum(w.T * vals, axis=0) \
            / jnp.maximum(jnp.sum(w, axis=1), 1e-30)
    return dsc[bin_idx]


def _event_dsc(grid, physics, events, cos_theta):
    gidx = jnp.clip(grid.off[jnp.clip(events.level, 0, grid.levels - 1)]
                    + jnp.maximum(events.ind, 0), 0, grid.cells - 1)
    return _dsc_value(physics, gidx, cos_theta)


@partial(jax.jit, static_argnames=("npix",))
def peel_off(grid, physics, events, odirs, ra, de, centre, map_dx, npix,
             out):
    """Phase C: deterministic rays from each event to each observer.

    out : [NDIR, NY, NX] accumulated scattered surface brightness
    """
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    nxp, nyp = npix
    ndir = odirs.shape[0]
    out_flat = out.reshape(-1)

    for idir in range(ndir):
        odir = odirs[idir]
        tau, exit_pos = _march_tau(
            grid, events.pos, events.level, events.ind,
            jnp.broadcast_to(odir, events.pos.shape),
            kabs + ksca, events.valid, tau_cut=TAU_PEEL_CUT)
        cos_theta = jnp.clip(jnp.sum(events.dir * odir[None, :], axis=-1),
                             -0.9999, 0.9999)
        delta = events.photons * jnp.exp(-tau) \
            * _event_dsc(grid, physics, events, cos_theta)
        # project the exit position onto the observer's map plane
        rel = exit_pos - jnp.asarray(centre, jnp.float32)[None, :]
        i = ((0.5 * nxp - 0.00005)
             + jnp.sum(rel * ra[idir][None, :], axis=-1) / map_dx)
        j = ((0.5 * nyp - 0.00005)
             + jnp.sum(rel * de[idir][None, :], axis=-1) / map_dx)
        ii = jnp.floor(i).astype(jnp.int32)
        jj = jnp.floor(j).astype(jnp.int32)
        ok = (events.valid & (ii >= 0) & (jj >= 0)
              & (ii < nxp) & (jj < nyp))
        flat_idx = jnp.where(ok, idir * nxp * nyp + jj * nxp + ii,
                             out_flat.shape[0])
        out_flat = out_flat.at[flat_idx].add(delta, mode="drop")
    return out_flat.reshape(out.shape)


@partial(jax.jit, static_argnames=("nside",))
def peel_off_healpix(grid, physics, events, obs_pos, nside, out):
    """Healpix peel-off for an internal observer (kernel_ASOC_sca.c NDIR<0
    branch): from each scattering event, one deterministic ray toward the
    observer position; delta = PHOTONS/(4 pi? no: 1/d^2) exp(-tau) DSC,
    binned by the arrival direction's healpix pixel.

    out : [12*nside^2] accumulated all-sky scattered intensity.
    """
    from . import healpix as hp
    from ..ops.traverse import root_pos
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    obs_pos = jnp.asarray(obs_pos, jnp.float32)

    rp = root_pos(grid, events.pos, events.level, events.ind)
    vec = obs_pos[None, :] - rp
    dist = jnp.linalg.norm(vec, axis=-1)
    odir = vec / jnp.maximum(dist, 1e-6)[:, None]
    odir = jnp.where(jnp.abs(odir) < 1e-5, 1e-5, odir)
    tau, _ = _march_tau(grid, events.pos, events.level, events.ind,
                        odir, kabs + ksca, events.valid, max_dist=dist,
                        tau_cut=TAU_PEEL_CUT)
    cos_theta = jnp.clip(jnp.sum(events.dir * odir, axis=-1),
                         -0.9999, 0.9999)
    delta = (events.photons * jnp.exp(-tau)
             * _event_dsc(grid, physics, events, cos_theta)
             / jnp.maximum(dist * dist, 1e-6))
    # arrival direction seen by the observer: -odir
    theta = jnp.arccos(jnp.clip(-odir[:, 2], -1.0, 1.0))
    phi = jnp.arctan2(odir[:, 1], odir[:, 0])
    pix = hp.ang2pix_ring(nside, theta, phi)
    idx = jnp.where(events.valid, pix, out.shape[0])
    return out.at[idx].add(delta, mode="drop")


def sca_pool_init(grid, nlanes):
    """Fresh (all-dead) persistent pool state for sca_run."""
    n = nlanes
    z3 = jnp.zeros((n, 3), jnp.float32)
    b = PacketBatch(
        pos=z3, dir=z3 + (1.0 / np.sqrt(3.0)),
        level=jnp.zeros(n, jnp.int32), ind=jnp.full(n, -1, jnp.int32),
        photons=jnp.zeros(n, jnp.float32), ifreq=jnp.zeros(n, jnp.int32),
        stream=jnp.zeros(n, jnp.uint32), hi=jnp.zeros(n, jnp.uint32),
        counter=jnp.zeros(n, jnp.uint32),
        scatterings=jnp.zeros(n, jnp.int32),
        e_cell=jnp.full(n, -1, jnp.int32))
    return dict(
        b=b, stage=jnp.ones(n, jnp.int32),
        rpos=z3, rlevel=jnp.zeros(n, jnp.int32),
        rind=jnp.full(n, -1, jnp.int32),
        rtau=jnp.zeros(n, jnp.float32),
        rA=jnp.zeros(n, jnp.float32),
        rk=jnp.zeros(n, jnp.uint32),
        free_path=jnp.zeros(n, jnp.float32),
        tau=jnp.zeros(n, jnp.float32),
        pend_s=jnp.zeros(n, bool), pend_r=jnp.zeros(n, bool),
        next_id=jnp.int32(0),
        # loop-body tally: each body is refill_period lane-march steps, so
        # total lane-steps = iters * refill_period * nlanes -- the measured
        # workload behind the chord-equivalent accounting in bench
        iters=jnp.int32(0))


@partial(jax.jit, static_argnames=("source_kind", "nlanes", "ffs",
                                   "capacity", "max_iters", "refill_period",
                                   "service_period"))
def sca_run(grid, physics, source_params, total_packets, carry, events,
            ecount, seed, source_kind="bg", nlanes=1 << 14, ffs=True,
            capacity=1 << 16, max_iters=1 << 30, refill_period=32,
            service_period=32):
    """Unified scattered-light transport: spawn + FFS + flight in ONE
    lane-refill loop (the transport_run pattern).

    The separate spawn/propagate phases each marched a full pool until the
    SLOWEST lane finished, so mean occupancy decayed with the chord-length
    spread. Here every
    lane cycles through stages at ~100% occupancy:

      stage 0 (ffs): march the entry ray to the far boundary accumulating
        the total scattering depth tau_tot AND reservoir-sampling the
        forced scattering point in the same sweep (_reservoir_update;
        the reference's quantile-then-re-march scheme costs two chords,
        kernel_ASOC_sca.c:227-244). At the boundary the lane freezes and
        the next service pass jumps it to the candidate, applies
        photons *= w = 1-exp(-tau_tot) and the absorption attenuation,
        and appends the forced event in the same pass.
      stage 1: normal flight -- march, freeze at the scattering point,
        service appends the peel-off event + draws the new direction
        (identical to propagate_events), die on exit.
      dead lanes are refilled from the packet budget by prefix-sum.

    The per-packet RNG sequence (one uniform4 per scattering, reservoir
    hashes indexed by birth-relative segment number) is identical to the
    spawn/propagate_events pair, so the physics is unchanged -- only the
    scheduling differs.

    Returns (carry, events, ecount); call again with the returned carry
    (flushing the event buffer in between) until the pool is dead and the
    budget is exhausted.
    """
    from ..transport.sources import GENERATORS
    gen = GENERATORS[source_kind]
    seed = jnp.uint32(seed)
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    cells = grid.cells
    spb = max(1, refill_period // service_period)
    if nlanes * spb > capacity:
        raise ValueError("event capacity %d cannot hold one refill body of "
                         "events (%d lanes x %d services)"
                         % (capacity, nlanes, spb))
    evbuf0 = _pack_event_rows(events.pos, events.dir, events.photons,
                              events.level, events.ind)
    FP_FAR = jnp.float32(1e30)

    def service(c, evbuf, ecount, anc):
        b = c["b"]
        # ---- FFS resets FIRST: the stage-0 reservoir march finished
        # with the candidate scattering point in c["rpos"/"rlevel"/
        # "rind"/"rtau"] and the FFS weight w = c["rA"] = 1-exp(-tau_tot).
        # Jump straight to the candidate (no flight re-march), apply w
        # and the absorption attenuation to the scattering depth, and
        # hand the lane to the scatter service of the SAME pass -- the
        # forced event appends immediately, no idle service round.
        actr = c["pend_r"] & (b.ind >= 0)
        w = c["rA"]
        die = w < 1.0e-22
        pos = jnp.where(actr[:, None], c["rpos"], b.pos)
        level = jnp.where(actr, c["rlevel"], b.level)
        ind = jnp.where(actr, jnp.where(die, -1, c["rind"]), b.ind)
        photons = jnp.where(
            actr,
            b.photons * w * jnp.exp(-c["rtau"] * kabs
                                    / jnp.maximum(ksca, 1e-30)),
            b.photons)
        scat = jnp.where(actr & ~die, b.scatterings + 1, b.scatterings)
        stage = jnp.where(actr, 1, c["stage"])
        if grid.levels > 1:
            anc = jnp.where(actr[:, None],
                            traverse.stack_from_par(grid, level, ind), anc)
        b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                        photons=photons, ifreq=b.ifreq, stream=b.stream,
                        hi=b.hi, counter=b.counter,
                        scatterings=scat, e_cell=b.e_cell)

        # ---- scattering events: the shared append + redirect (includes
        # the freshly forced lanes)
        act = (c["pend_s"] | (actr & ~die)) & (b.ind >= 0)
        evbuf, ecount, dirx, ind, counter, free_path, tau = \
            _service_scatter(grid, physics, seed, capacity, b, act,
                             evbuf, ecount, c["free_path"], c["tau"])

        nb = PacketBatch(pos=b.pos, dir=dirx, level=b.level, ind=ind,
                         photons=b.photons, ifreq=b.ifreq, stream=b.stream,
                         hi=b.hi, counter=counter,
                         scatterings=b.scatterings, e_cell=b.e_cell)
        c = {**c, "b": nb, "stage": stage, "free_path": free_path,
             "tau": tau,
             "pend_s": (c["pend_s"] | (actr & ~die)) & ~act,
             "pend_r": c["pend_r"] & ~actr}
        return c, evbuf, ecount, anc

    def march(c, evbuf, ecount, anc):
        b = c["b"]
        stage = c["stage"]
        free_path = c["free_path"]
        tau = c["tau"]
        alive = b.ind >= 0
        active = alive & ~c["pend_s"] & ~c["pend_r"]
        gidx = jnp.clip(grid.off[jnp.clip(b.level, 0, grid.levels - 1)]
                        + jnp.maximum(b.ind, 0), 0, cells - 1)
        dens = grid.dens[gidx]
        # deferred descent (see transport.propagate): a lane on a link
        # cell spends this step descending one level, ALU-only
        if grid.levels > 1:
            is_link = active & (dens <= 0.0)
            active = active & ~is_link
        else:
            is_link = jnp.zeros_like(active)
        ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
        ds_gl = ds_local * jnp.exp2(-b.level.astype(jnp.float32))
        dtau_sca = ds_gl * dens * ksca
        in_flight = active & (stage == 1)
        scatter_now = in_flight & (free_path < tau + dtau_sca)

        # ---- stage-0 reservoir: sample the forced scattering point in
        # the same pass that accumulates tau (see _reservoir_update);
        # segment index rk matches _march_ffs so both engines make
        # identical reservoir decisions
        stage0 = active & (stage == 0)
        res = dict(pos=c["rpos"], level=c["rlevel"], ind=c["rind"],
                   tau=c["rtau"], A=c["rA"])
        res = _reservoir_update(ksca, seed, b.stream, b.hi, c["rk"],
                                b.pos, b.dir, b.level, b.ind, dens,
                                tau, jnp.where(stage0, dtau_sca, 0.0),
                                stage0, res)
        rk = c["rk"] + stage0.astype(jnp.uint32)

        dx_gl = (free_path - tau) / jnp.maximum(ksca * dens, 1e-30)
        dx_local = jnp.maximum(
            0.0, dx_gl * jnp.exp2(b.level.astype(jnp.float32)) - 2.0 * PEPS)
        pos_scatter = b.pos + dx_local[:, None] * b.dir
        photons = jnp.where(
            scatter_now,
            b.photons * jnp.exp(-free_path * kabs
                                / jnp.maximum(ksca, 1e-30)),
            b.photons)

        cross = active & ~scatter_now
        posx = jnp.where(cross[:, None], pos_boundary, b.pos)
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, anc, cross, descend=False)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)

        # stage-0 lanes that reached the far boundary -- or the
        # TAU_PEEL_CUT truncation depth (matching _march_ffs) -- freeze
        # for the FFS reset (their march state is discarded at the reset)
        exit0 = (cross & (stage == 0)
                 & ((nind < 0) | (tau + dtau_sca > TAU_PEEL_CUT)))
        apply = cross & ~exit0
        pos = jnp.where(scatter_now[:, None], pos_scatter,
                        jnp.where(apply[:, None], npos, b.pos))
        level = jnp.where(apply, nlevel, b.level)
        ind = jnp.where(apply, nind, b.ind)
        if grid.levels > 1:
            pos, level, ind, anc = traverse.descend_one(
                grid, pos, level, ind, anc, dens, is_link)
        scat = b.scatterings + scatter_now.astype(jnp.int32)
        tau = jnp.where(scatter_now, free_path,
                        jnp.where(cross, tau + dtau_sca, tau))
        nb = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                         photons=photons, ifreq=b.ifreq, stream=b.stream,
                         hi=b.hi, counter=b.counter,
                         scatterings=scat, e_cell=b.e_cell)
        c = {**c, "b": nb, "free_path": free_path, "tau": tau,
             "rpos": res["pos"], "rlevel": res["level"],
             "rind": res["ind"], "rtau": res["tau"], "rA": res["A"],
             "rk": rk,
             "pend_s": c["pend_s"] | scatter_now,
             "pend_r": c["pend_r"] | exit0}
        return c, evbuf, ecount, anc

    def cond(state):
        it, c, evbuf, ecount = state
        more = jnp.any(c["b"].ind >= 0) | (c["next_id"] < total_packets)
        return ((it < max_iters) & more
                & (ecount + nlanes * spb <= capacity))

    def body(state):
        it, c, evbuf, ecount = state
        b = c["b"]
        # ---- refill dead lanes from the budget
        dead = b.ind < 0
        deadi = dead.astype(jnp.int32)
        rank = jnp.cumsum(deadi) - deadi
        new_id = c["next_id"] + rank
        can = dead & (new_id < total_packets)
        ids_local = jnp.where(can, new_id, 0)
        nb = gen(grid, ids_local, seed, source_params)
        u2 = socrng.uniform1(seed, nb.stream,
                             jnp.full_like(nb.stream, 2), nb.hi)
        canl = can[:, None]
        b = PacketBatch(
            pos=jnp.where(canl, nb.pos, b.pos),
            dir=jnp.where(canl, nb.dir, b.dir),
            level=jnp.where(can, nb.level, b.level),
            ind=jnp.where(can, nb.ind, b.ind),
            photons=jnp.where(can, nb.photons, b.photons),
            ifreq=jnp.where(can, nb.ifreq, b.ifreq),
            stream=jnp.where(can, nb.stream, b.stream),
            hi=jnp.where(can, nb.hi, b.hi),
            counter=jnp.where(can, nb.counter + jnp.uint32(1), b.counter),
            scatterings=jnp.where(can, 0, b.scatterings),
            e_cell=jnp.where(can, nb.e_cell, b.e_cell))
        c = {**c, "b": b,
             "stage": jnp.where(can, 0 if ffs else 1, c["stage"]),
             "rind": jnp.where(can, -1, c["rind"]),
             "rtau": jnp.where(can, 0.0, c["rtau"]),
             "rA": jnp.where(can, 0.0, c["rA"]),
             "rk": jnp.where(can, jnp.uint32(0), c["rk"]),
             "free_path": jnp.where(can,
                                    FP_FAR if ffs else -jnp.log(u2),
                                    c["free_path"]),
             "tau": jnp.where(can, 0.0, c["tau"]),
             "pend_s": c["pend_s"] & ~can,
             "pend_r": c["pend_r"] & ~can,
             "next_id": c["next_id"] + jnp.sum(can.astype(jnp.int32))}

        anc = traverse.stack_from_par(grid, c["b"].level, c["b"].ind)
        st = (c, evbuf, ecount, anc)
        for _ in range(spb):
            st = service(*st)
            st = lax.fori_loop(0, service_period, lambda _, s: march(*s), st)
        c, evbuf, ecount, _ = st
        return it + 1, c, evbuf, ecount

    state = (jnp.int32(0), carry, evbuf0, ecount)
    state = lax.while_loop(cond, body, state)
    it, carry, evbuf, ecount = state
    carry = {**carry, "iters": carry["iters"] + it}
    events = _unpack_events(evbuf, ecount, capacity)
    return carry, events, ecount


@partial(jax.jit, static_argnames=("npix", "mode", "nlanes",
                                   "refill_period", "max_iters"))
def peel_off_run(grid, physics, events, ecount, odirs, ra, de, centre,
                 map_dx, npix, out_flat, obs_pos, mode="ortho",
                 nlanes=1 << 14, refill_period=32, max_iters=1 << 30):
    """Peel-off as a lane-refill march: one persistent ray pool drained
    from the event x observer work list.

    The chunked peel_off marched each fixed chunk until its SLOWEST ray
    exited; here exited rays deposit and are refilled immediately, keeping
    occupancy ~100% across the whole event buffer.

    mode="ortho": work item (event, idir) -> ray along odirs[idir], deposit
    into the [NDIR,NY,NX] map at the exit-position projection.
    mode="healpix": one ray per event toward obs_pos (max_dist = the
    observer distance), deposit into the all-sky [12 nside^2] map.
    """
    kabs = physics["kabs"]
    ksca = physics["ksca"]
    ext = kabs + ksca
    cells = grid.cells
    n = nlanes
    if mode == "ortho":
        ndir = odirs.shape[0]
        nxp, nyp = npix
    else:
        from . import healpix as hp
        from ..ops.traverse import root_pos
        ndir = 1
        nside = int(np.sqrt(out_flat.shape[0] // 12))
        obs_pos = jnp.asarray(obs_pos, jnp.float32)
    total_work = ecount * ndir
    oob = out_flat.shape[0]

    def deposit(c, out_flat):
        has = (c["ind"] < 0) & (c["eidx"] >= 0)
        cos_theta = jnp.clip(jnp.sum(c["evdir"] * c["rdir"], axis=-1),
                             -0.9999, 0.9999)
        delta = c["ph"] * jnp.exp(-c["tau"]) \
            * _dsc_value(physics, c["egidx"], cos_theta)
        if mode == "ortho":
            rel = c["pos"] - jnp.asarray(centre, jnp.float32)[None, :]
            ra_l = ra[c["idir"]]
            de_l = de[c["idir"]]
            i = ((0.5 * nxp - 0.00005)
                 + jnp.sum(rel * ra_l, axis=-1) / map_dx)
            j = ((0.5 * nyp - 0.00005)
                 + jnp.sum(rel * de_l, axis=-1) / map_dx)
            ii = jnp.floor(i).astype(jnp.int32)
            jj = jnp.floor(j).astype(jnp.int32)
            ok = has & (ii >= 0) & (jj >= 0) & (ii < nxp) & (jj < nyp)
            flat_idx = jnp.where(ok, c["idir"] * nxp * nyp + jj * nxp + ii,
                                 oob)
        else:
            delta = delta / jnp.maximum(c["dist"] * c["dist"], 1e-6)
            theta = jnp.arccos(jnp.clip(-c["rdir"][:, 2], -1.0, 1.0))
            phi = jnp.arctan2(c["rdir"][:, 1], c["rdir"][:, 0])
            pix = hp.ang2pix_ring(nside, theta, phi)
            flat_idx = jnp.where(has, pix, oob)
        out_flat = out_flat.at[flat_idx].add(delta, mode="drop")
        return {**c, "eidx": jnp.where(has, -1, c["eidx"])}, out_flat

    def cond(state):
        it, c, out_flat = state
        return ((it < max_iters)
                & (jnp.any(c["ind"] >= 0) | (c["next"] < total_work)))

    def body(state):
        it, c, out_flat = state
        c, out_flat = deposit(c, out_flat)

        # ---- refill from the work list
        dead = c["ind"] < 0
        deadi = dead.astype(jnp.int32)
        rank = jnp.cumsum(deadi) - deadi
        wid = c["next"] + rank
        can = dead & (wid < total_work)
        widc = jnp.where(can, wid, 0)
        if mode == "ortho":
            ei = widc // ndir
            di = (widc % ndir).astype(jnp.int32)
        else:
            ei = widc
            di = jnp.zeros_like(widc)
        epos = events.pos[ei]
        elvl = events.level[ei]
        eind = events.ind[ei]
        egidx = jnp.clip(grid.off[jnp.clip(elvl, 0, grid.levels - 1)]
                         + jnp.maximum(eind, 0), 0, cells - 1)
        if mode == "ortho":
            rdir_new = odirs[di]
            dist = jnp.full(n, jnp.inf, jnp.float32)
        else:
            rp = root_pos(grid, epos, elvl, eind)
            vec = obs_pos[None, :] - rp
            dist = jnp.linalg.norm(vec, axis=-1)
            rdir_new = vec / jnp.maximum(dist, 1e-6)[:, None]
            rdir_new = jnp.where(jnp.abs(rdir_new) < 1e-5, 1e-5, rdir_new)
        canl = can[:, None]
        c = {**c,
             "pos": jnp.where(canl, epos, c["pos"]),
             "level": jnp.where(can, elvl, c["level"]),
             "ind": jnp.where(can, eind, c["ind"]),
             "rdir": jnp.where(canl, rdir_new, c["rdir"]),
             "evdir": jnp.where(canl, events.dir[ei], c["evdir"]),
             "ph": jnp.where(can, events.photons[ei], c["ph"]),
             "egidx": jnp.where(can, egidx, c["egidx"]),
             "eidx": jnp.where(can, ei, c["eidx"]),
             "idir": jnp.where(can, di, c["idir"]),
             "tau": jnp.where(can, 0.0, c["tau"]),
             "dist": jnp.where(can, dist, c["dist"]),
             "left": jnp.where(can, dist, c["left"]),
             "next": c["next"] + jnp.sum(can.astype(jnp.int32))}

        anc = traverse.stack_from_par(grid, c["level"], c["ind"])

        def march(_, st):
            c, anc = st
            live = c["ind"] >= 0
            gidx = jnp.clip(
                grid.off[jnp.clip(c["level"], 0, grid.levels - 1)]
                + jnp.maximum(c["ind"], 0), 0, cells - 1)
            dens = grid.dens[gidx]
            # deferred descent: link lanes descend one level this step
            if grid.levels > 1:
                is_link = live & (dens <= 0.0)
                step_ok = live & ~is_link
            else:
                is_link = jnp.zeros_like(live)
                step_ok = live
            ds_local, pos_b = traverse.boundary_step(c["pos"], c["rdir"])
            ds = ds_local * jnp.exp2(-c["level"].astype(jnp.float32))
            posx = jnp.where(step_ok[:, None], pos_b, c["pos"])
            npos, nlevel, nind, anc = traverse.index_update_stack(
                grid, posx, c["level"], c["ind"], anc, step_ok,
                descend=False)
            failed = step_ok & (nlevel == c["level"]) & (nind == c["ind"])
            npos = jnp.where(failed[:, None], npos + PEPS * c["rdir"], npos)
            w = jnp.minimum(ds, c["left"])
            tau = c["tau"] + jnp.where(step_ok, w * dens * ext, 0.0)
            left = jnp.where(step_ok, c["left"] - w, c["left"])
            nind = jnp.where(step_ok & (left <= 0.0), -1, nind)
            # optically dead rays stop early (see TAU_PEEL_CUT)
            nind = jnp.where(tau > TAU_PEEL_CUT, -1, nind)
            if grid.levels > 1:
                npos, nlevel, nind, anc = traverse.descend_one(
                    grid, npos, nlevel, nind, anc, dens, is_link)
            c = {**c, "pos": npos, "level": nlevel, "ind": nind,
                 "tau": tau, "left": left}
            return c, anc

        c, _ = lax.fori_loop(0, refill_period, march, (c, anc))
        return it + 1, c, out_flat

    z3 = jnp.zeros((n, 3), jnp.float32)
    c0 = dict(pos=z3, level=jnp.zeros(n, jnp.int32),
              ind=jnp.full(n, -1, jnp.int32),
              rdir=z3 + 1.0, evdir=z3, ph=jnp.zeros(n, jnp.float32),
              egidx=jnp.zeros(n, jnp.int32),
              eidx=jnp.full(n, -1, jnp.int32),
              idir=jnp.zeros(n, jnp.int32),
              tau=jnp.zeros(n, jnp.float32),
              dist=jnp.zeros(n, jnp.float32),
              left=jnp.zeros(n, jnp.float32),
              next=jnp.int32(0))
    state = (jnp.int32(0), c0, out_flat)
    state = lax.while_loop(cond, body, state)
    it, c, out_flat = state
    _, out_flat = deposit(c, out_flat)        # final flush
    # `it` counts loop bodies of refill_period lane-marches each -- the
    # peel-ray half of the lane-step accounting in bench (sca_run carries
    # the transport half in its pool dict)
    return out_flat, it


def empty_events(capacity):
    return ScatterEvents(
        pos=jnp.zeros((capacity, 3), jnp.float32),
        level=jnp.zeros(capacity, jnp.int32),
        ind=jnp.zeros(capacity, jnp.int32),
        dir=jnp.zeros((capacity, 3), jnp.float32),
        photons=jnp.zeros(capacity, jnp.float32),
        valid=jnp.zeros(capacity, bool))


@partial(jax.jit, static_argnames=("source_kind", "nlanes", "ffs",
                                   "capacity", "npix", "mode",
                                   "max_rounds"))
def _sca_channel_fused(grid, physics, source_params, total, seed, odirs,
                       ra, de, centre, map_dx, npix, out_flat, obs_pos,
                       source_kind="bg", nlanes=1 << 14, ffs=True,
                       capacity=1 << 20, mode="ortho", max_rounds=1 << 16):
    """One whole scattered-light channel as a single jitted loop:
    alternate sca_run (until the event buffer fills or the budget drains)
    with peel_off_run, entirely on device. Identical math and RNG streams
    to the host-flushed simulate_scattering loop; exists so the channel
    can run INSIDE shard_map for multi-chip execution."""

    def cond(st):
        it, carry, out_flat = st
        return (it < max_rounds) & (jnp.any(carry["b"].ind >= 0)
                                    | (carry["next_id"] < total))

    def body(st):
        it, carry, out_flat = st
        events = empty_events(capacity)
        carry, events, ecount = sca_run(
            grid, physics, source_params, total, carry, events,
            jnp.int32(0), seed, source_kind=source_kind, nlanes=nlanes,
            ffs=ffs, capacity=capacity)
        out_flat, _ = peel_off_run(
            grid, physics, events, ecount, odirs, ra, de, centre,
            map_dx, npix, out_flat, obs_pos, mode=mode, nlanes=nlanes)
        return it + 1, carry, out_flat

    carry = sca_pool_init(grid, nlanes)
    _, _, out_flat = lax.while_loop(cond, body,
                                    (jnp.int32(0), carry, out_flat))
    return out_flat


def simulate_scattering_sharded(n_devices, grid, physics, source_params,
                                total_packets, odirs, ra, de, centre,
                                map_dx, npix, seed, source_kind="bg",
                                nlanes=1 << 14, ffs=True,
                                capacity=1 << 20, healpix_nside=0,
                                obs_pos=None):
    """Multi-chip scattered light (`devices N` in the ASOCS pipeline):
    the packet budget splits over a flat dp mesh by global id range (the
    product-path identity scheme, so results match the single-device run
    allclose) and each device runs the fused channel loop independently;
    the only communication is one psum of the output map per channel."""
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.asarray(devices), ("dp",))
    n = len(devices)
    healpix = healpix_nside > 0
    if healpix:
        out_shape = (12 * healpix_nside * healpix_nside,)
        obs_pos = jnp.asarray(obs_pos, jnp.float32)
        mode = "healpix"
    else:
        odirs = jnp.asarray(np.atleast_2d(odirs), jnp.float32)
        ra = jnp.asarray(np.atleast_2d(ra), jnp.float32)
        de = jnp.asarray(np.atleast_2d(de), jnp.float32)
        out_shape = (odirs.shape[0], npix[1], npix[0])
        obs_pos = jnp.zeros(3, jnp.float32)
        mode = "ortho"
    total = int(total_packets)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P()), out_specs=P(), check_vma=False)
    def run(phys, params, seed_t):
        dp = lax.axis_index("dp")
        q, r = total // n, total % n
        my = (q + (dp < r)).astype(jnp.int32)
        k0 = (dp * q + jnp.minimum(dp, r)).astype(jnp.uint32)
        params = dict(params)
        params["k0"] = params.get("k0", jnp.uint32(0)) + k0
        out_flat = jnp.zeros(int(np.prod(out_shape)), jnp.float32)
        out_flat = _sca_channel_fused(
            grid, phys, params, my, seed_t, odirs, ra, de,
            jnp.asarray(centre, jnp.float32), map_dx, tuple(npix),
            out_flat, obs_pos, source_kind=source_kind, nlanes=nlanes,
            ffs=ffs, capacity=capacity, mode=mode)
        return lax.psum(out_flat, "dp")

    out = run(physics, dict(source_params), jnp.uint32(seed))
    return np.asarray(out).reshape(out_shape)


def simulate_scattering(grid, physics, source_params, total_packets,
                        odirs, ra, de, centre, map_dx, npix, seed,
                        source_kind="bg", nlanes=1 << 14, ffs=True,
                        capacity=1 << 20, healpix_nside=0, obs_pos=None,
                        return_stats=False):
    """Full single-frequency scattered-light simulation.

    Returns OUT[NDIR, NY, NX], or -- with healpix_nside > 0 and obs_pos
    set (the reference's NDIR<0 internal-observer mode, ASOCS.py:43-49) --
    an all-sky OUT[12*nside^2] around the observer position.

    Both the transport (sca_run) and the peel-off (peel_off_run) are
    lane-refill loops; the host only flushes the event buffer between
    rounds.

    return_stats=True additionally returns the measured transport
    workload {sca_iters, lane_steps, events}: lane_steps is the exact
    number of lane-march steps the sca_run pool executed, so bench can
    report chord-equivalents (FFS lane_steps / march-only lane_steps)
    instead of inferring them from timings.
    """
    healpix = healpix_nside > 0
    if healpix:
        out_shape = (12 * healpix_nside * healpix_nside,)
        obs_pos = jnp.asarray(obs_pos, jnp.float32)
    else:
        odirs = jnp.asarray(np.atleast_2d(odirs), jnp.float32)
        ra = jnp.asarray(np.atleast_2d(ra), jnp.float32)
        de = jnp.asarray(np.atleast_2d(de), jnp.float32)
        ndir = odirs.shape[0]
        nxp, nyp = npix
        out_shape = (ndir, nyp, nxp)
        obs_pos = jnp.zeros(3, jnp.float32)
    out_flat = jnp.zeros(int(np.prod(out_shape)), jnp.float32)
    total = jnp.int32(total_packets)
    carry = sca_pool_init(grid, nlanes)
    n_events = 0
    peel_iters = 0
    while True:
        events = empty_events(capacity)
        carry, events, ecount = sca_run(
            grid, physics, source_params, total, carry, events,
            jnp.int32(0), seed, source_kind=source_kind, nlanes=nlanes,
            ffs=ffs, capacity=capacity)
        ne = int(ecount)
        n_events += ne
        if ne > 0:
            out_flat, pit = peel_off_run(
                grid, physics, events, ecount, odirs, ra, de,
                jnp.asarray(centre, jnp.float32), map_dx,
                tuple(npix), out_flat, obs_pos,
                mode="healpix" if healpix else "ortho", nlanes=nlanes)
            peel_iters += int(pit)
        if (int(carry["next_id"]) >= total_packets
                and not bool(jnp.any(carry["b"].ind >= 0))):
            break
    out = np.asarray(out_flat).reshape(out_shape)
    if return_stats:
        iters = int(carry["iters"])
        return out, dict(sca_iters=iters, peel_iters=peel_iters,
                         lane_steps=iters * 32 * nlanes,
                         peel_lane_steps=peel_iters * 32 * nlanes,
                         events=n_events)
    return out
