"""Live spatial domain decomposition: grid slabs + ppermute halo exchange.

The reference's only domain coupling is the offline ROI photon file
(kernel_ASOC.c:469-505, 617-660: record boundary-crossing packets, re-inject
them in a second run). Here that becomes a LIVE exchange over the 'dp' mesh
axis: the root grid is split into Z-slabs, every device steps the packets
inside its slab, and packets crossing a slab face are packed into fixed-size
buffers and handed to the neighbor with ``lax.ppermute`` between stepping
super-steps -- the exchange overlaps with the next block of
local stepping that XLA schedules around it.

Key invariants:
  * RNG streams are the global (hi, lo) packet ids, and a packet carries its
    stream + draw counter across the exchange -- the random sequence each
    packet consumes is IDENTICAL to the single-device run, so domain
    decomposition changes results only through boundary-epsilon geometry.
  * Source ownership: every device evaluates the shared counter-based
    source for every packet id but keeps only the ids whose entry position
    falls in its slab; ids are owned by exactly one device.
  * Fixed shapes everywhere: emigrant buffers hold at most ``nlanes``
    packets per direction per super-step; a pending queue (capacity
    4*nlanes) absorbs arrivals that do not fit into free lanes immediately.
  * ONE physics implementation: the stepping inside the superstep loop is
    transport_run's own StepKit (transport.propagate.make_step_fns) with
    the domain emigrant hook -- per-frequency tallies, ALI, emission
    weighting, splitting, mirror boundaries, WITH_ABU/MSF and
    step/direction weighting therefore run under domains with the exact
    single-device semantics (grep: no march/scatter math in this file).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..constants import PEPS
from ..grid import Grid, decode_link_np, encode_link_np, build_parents
from ..ops import traverse
from ..transport.sources import background_entry, stream_hi_base


@dataclass
class SlabSet:
    """Host-side container of S stacked slab grids (Z-decomposition)."""

    dens: np.ndarray        # [S, CELLS_PAD]
    lcells: np.ndarray      # [S, LEVELS]
    off: np.ndarray         # [LEVELS] shared (levels padded to max size)
    par: np.ndarray         # [S, CELLS_PAD]
    gidx: np.ndarray        # [S, CELLS_PAD] global cell index, -1 = padding
    nx: int = 0
    ny: int = 0
    nz: int = 0             # GLOBAL z extent
    nz_local: int = 0
    levels: int = 0
    cells_pad: int = 0
    n_slabs: int = 0


def split_grid_slabs(grid, n_slabs):
    """Split an octree grid into Z-slabs of nz/S root planes each.

    Slab boundaries align with root-cell planes, so every sub-octree is
    fully contained in one slab; child links are renumbered per slab.
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    assert nz % n_slabs == 0, "NZ must divide the slab count"
    nzl = nz // n_slabs
    dens = np.asarray(grid.dens)
    off = np.asarray(grid.off)
    lcells = np.asarray(grid.lcells)
    levels = grid.levels

    per_slab = []       # per slab: list of (values, global_level_indices)
    for s in range(n_slabs):
        sel = np.arange(s * nx * ny * nzl, (s + 1) * nx * ny * nzl)
        level_vals = [dens[off[0] + sel].copy()]
        level_gidx = [off[0] + sel]
        for level in range(1, levels):
            vals_prev = level_vals[level - 1]
            parents = np.nonzero(vals_prev <= 0.0)[0]
            if len(parents) == 0:
                level_vals.append(np.zeros(0, np.float32))
                level_gidx.append(np.zeros(0, np.int64))
                continue
            first_old = decode_link_np(vals_prev[parents])
            child_old = (first_old[:, None]
                         + np.arange(8)[None, :]).reshape(-1)
            level_vals.append(dens[off[level] + child_old].copy())
            level_gidx.append(off[level] + child_old)
            # renumber: children of parent j occupy [8j, 8j+8)
            vals_prev[parents] = encode_link_np(8 * np.arange(len(parents)))
        per_slab.append((level_vals, level_gidx))

    # pad every level to the max size over slabs -> shared off[]
    max_l = [max(len(per_slab[s][0][l]) for s in range(n_slabs))
             for l in range(levels)]
    off_new = np.zeros(levels, np.int32)
    off_new[1:] = np.cumsum(max_l)[:-1]
    cells_pad = int(np.sum(max_l))
    dens_s = np.zeros((n_slabs, cells_pad), np.float32)
    lcells_s = np.zeros((n_slabs, levels), np.int32)
    par_s = np.full((n_slabs, cells_pad), -1, np.int32)
    gidx_s = np.full((n_slabs, cells_pad), -1, np.int32)
    max_l = np.asarray(max_l, np.int32)
    for s in range(n_slabs):
        level_vals, level_gidx = per_slab[s]
        lc = np.asarray([len(v) for v in level_vals], np.int32)
        lcells_s[s] = lc
        # padding cells carry a tiny positive density so they read as
        # (unreachable) leaves, never as child links
        flat = np.full(cells_pad, 1e-30, np.float32)
        for l in range(levels):
            flat[off_new[l]:off_new[l] + lc[l]] = level_vals[l]
            gidx_s[s, off_new[l]:off_new[l] + lc[l]] = level_gidx[l]
        dens_s[s] = flat
        par_s[s] = build_parents(flat, max_l, off_new, nx, ny, nzl)
    return SlabSet(dens=dens_s, lcells=lcells_s, off=off_new, par=par_s,
                   gidx=gidx_s, nx=nx, ny=ny, nz=nz, nz_local=nzl,
                   levels=levels, cells_pad=cells_pad, n_slabs=n_slabs)


# packet payload layout for the exchange buffers: 16 float32 words
# [pos3 | dir3 | photons | free_path | tau | stream | hi | counter | scat
#  | e_cell | split_depth | split_path]
_PK = 16


def _pack(b, free_path, tau, sp):
    as_f = lambda x: lax.bitcast_convert_type(x, jnp.float32)
    depth = sp.get("lane_depth", jnp.zeros_like(b.ind))
    path = sp.get("lane_path", jnp.zeros_like(b.stream))
    return jnp.concatenate([
        b.pos, b.dir,
        b.photons[:, None], free_path[:, None], tau[:, None],
        as_f(b.stream)[:, None], as_f(b.hi)[:, None],
        as_f(b.counter)[:, None],
        as_f(b.scatterings.astype(jnp.uint32))[:, None],
        as_f(b.e_cell.astype(jnp.uint32))[:, None],
        as_f(depth.astype(jnp.uint32))[:, None],
        as_f(path)[:, None]], axis=1)


def _unpack(buf):
    as_u = lambda x: lax.bitcast_convert_type(x, jnp.uint32)
    return dict(pos=buf[:, 0:3], dir=buf[:, 3:6], photons=buf[:, 6],
                free_path=buf[:, 7], tau=buf[:, 8],
                stream=as_u(buf[:, 9]), hi=as_u(buf[:, 10]),
                counter=as_u(buf[:, 11]),
                scat=as_u(buf[:, 12]).astype(jnp.int32),
                e_cell=as_u(buf[:, 13]).astype(jnp.int32),
                depth=as_u(buf[:, 14]).astype(jnp.int32),
                path=as_u(buf[:, 15]))


# physics entries that are per-cell GLOBAL arrays: remapped to slab-local
# [S, cells_pad(, ...)] layouts and sharded over dp
_PER_CELL_PHYSICS = ("opt_abs", "opt_sca", "msf_abu")

_DEFAULT_FEATURES = dict(per_freq_tally=False, icomps=0, with_ali=False,
                         mirror_mask=0, split_max=0)


def domain_background_run(slabs, physics, bg_photons, total_packets, seed,
                          mesh, nlanes=1 << 10, k_inner=32,
                          max_super=1 << 20, hi_base=None, features=None,
                          raw=False):
    """Isotropic-background transport over Z-slab domains on the dp axis.

    physics : uniform-frequency dict (scalar kabs/ksca/tw, csc [BINS]),
    optionally with the per-cell WITH_ABU/MSF/weighting extras -- the step
    physics is transport_run's own StepKit, so every physics option the
    single-device path supports runs under domains too.
    features : dict(per_freq_tally, icomps, with_ali, mirror_mask,
    split_max); returns (tabs [GLOBAL CELLS], escaped, lost, aux) where aux
    holds 'intf' [CELLS(, icomps)] and 'xab' [CELLS] when enabled. `lost`
    is the photon weight destroyed by pending-queue overflow (0 in any
    sane configuration; nonzero means nlanes is too small for the flux).

    Per-frequency callers pass hi_base = stream_hi_base("bg") + ifreq so
    every channel gets independent RNG streams; all per-frequency values
    (cross sections, photons, hi) are traced arguments of ONE cached
    jitted executable, so a frequency loop compiles exactly once.
    """
    hi = jnp.uint32(stream_hi_base("bg") if hi_base is None else hi_base)
    return _domain_call(
        slabs, physics, total_packets, seed, mesh, nlanes, k_inner,
        max_super, "bg", statics=(),
        src_values=(jnp.float32(bg_photons), hi), features=features,
        raw=raw)


def domain_cell_emission_run(slabs, physics, emit, per_cell, seed, mesh,
                             nlanes=1 << 10, k_inner=32,
                             max_super=1 << 20, hi_base=None,
                             cell_of_id=None, total_packets=None,
                             features=None, raw=False):
    """Cell-emission transport (the iteration hot path, SimRAM_CL) over
    Z-slab domains: each device owns the packets born in its slab's cells
    and boundary crossings ride the same ppermute halo exchange.

    emit : [GLOBAL CELLS] photon weight per packet per cell (already
    divided by per_cell, or multiplied by the EMWEI weight). Packet
    identity matches gen_cell: id k -> global flat cell k // per_cell (or
    cell_of_id[k] under emission weighting), uniforms from counter slots
    0-2, so tallies match the single-device run per packet.
    Returns (tabs [GLOBAL CELLS] host order, escaped, lost, aux).
    """
    S = slabs.n_slabs
    hi = jnp.uint32(stream_hi_base("cell") if hi_base is None else hi_base)
    gcells = int(np.sum(np.asarray(slabs.lcells)))
    if total_packets is None:
        total_packets = per_cell * gcells
    # host-side inverse maps: global flat cell -> local flat cell per slab
    # (cached on the SlabSet: rebuilding per frequency is pure waste)
    inv = getattr(slabs, "_inv_cache", None)
    if inv is None:
        inv = np.full((S, gcells), -1, np.int32)
        for s in range(S):
            m = slabs.gidx[s] >= 0
            inv[s, slabs.gidx[s][m]] = np.nonzero(m)[0].astype(np.int32)
        slabs._inv_cache = inv
    if cell_of_id is not None:
        src = (jnp.asarray(np.asarray(emit, np.float32)), hi,
               jnp.asarray(np.asarray(cell_of_id, np.int32)))
    else:
        src = (jnp.asarray(np.asarray(emit, np.float32)), hi)
    return _domain_call(
        slabs, physics, total_packets, seed, mesh, nlanes, k_inner,
        max_super, "cell",
        statics=(int(per_cell), gcells, cell_of_id is not None),
        src_values=src,
        extra_arrays=(jnp.asarray(inv),), extra_specs=(P("dp"),),
        features=features, raw=raw)


def domain_generator_run(slabs, physics, gen_name, params, total_packets,
                         seed, mesh, nlanes=1 << 10, k_inner=32,
                         max_super=1 << 20, hi_base=None, features=None,
                         raw=False):
    """Z-slab transport for any *surface/point* packet generator
    (point sources incl. all PS_METHODs, healpix background, ROI re-load).

    Entry states are geometry-only: the global generator is evaluated
    against a levels==1 dummy grid of the global dimensions (no density
    reads happen at level 0), each device keeps the ids whose entry
    position falls in its slab, and re-indexes them on its local slab
    octree. RNG identity matches the single-device per-frequency call
    (params gain ifreq=0 / hi_base=hi so hi equals base + channel).
    """
    params = dict(params)
    params["ifreq"] = jnp.int32(0)
    params["hi_base"] = jnp.uint32(stream_hi_base(gen_name)
                                   if hi_base is None else hi_base)
    return _domain_call(
        slabs, physics, total_packets, seed, mesh, nlanes, k_inner,
        max_super, "gen", statics=(gen_name, tuple(sorted(params))),
        src_values=(params, jnp.uint32(0)), features=features, raw=raw)


def _owner_of_cell(slabs):
    """[GCELLS] int32: owning slab of every global cell (cached)."""
    own = getattr(slabs, "_owner_cache", None)
    if own is None:
        gcells = int(np.sum(np.asarray(slabs.lcells)))
        own = np.zeros(gcells, np.int32)
        for si in range(slabs.n_slabs):
            m = slabs.gidx[si] >= 0
            own[slabs.gidx[si][m]] = si
        slabs._owner_cache = own
    return own


def _owner_lists(slabs, spawn_kind, statics, src_values, total, seed):
    """Per-slab ascending lists of the packet ids each slab OWNS.

    Round-2 weakness: every device evaluated the shared counter-based
    source for EVERY id and kept ~1/S of them -- O(total) redundant
    generator work per device and S refill windows to inject one pool.
    Ownership is a pure function of the id (entry position / emitting
    cell), so it is computed ONCE here -- on the host for cell emission
    (the inverse cell map), in one vectorized device pass for surface
    sources -- and each device then refills straight from its own list.
    Returns (own_ids [S, PAD] int32, own_n [S] int32, PAD); PAD is a
    stable power-of-two so every channel hits one cached executable.
    """
    S, nzl = slabs.n_slabs, slabs.nz_local
    total = int(total)
    if spawn_kind == "cell":
        per_cell, gcells, has_com = statics
        if has_com:
            gcell = np.asarray(src_values[2])[:total]
        else:
            gcell = np.arange(total, dtype=np.int64) // per_cell
        owner = _owner_of_cell(slabs)[np.clip(gcell, 0, gcells - 1)]
    else:
        owner = np.empty(total, np.int32)
        chunk = 1 << 22
        if spawn_kind == "bg":
            _, hi = src_values
            for i0 in range(0, total, chunk):
                ids = jnp.arange(i0, min(i0 + chunk, total),
                                 dtype=jnp.int32)
                stream = ids.astype(jnp.uint32)
                pos, _ = background_entry(
                    slabs.nx, slabs.ny, slabs.nz, stream,
                    jnp.full_like(stream, jnp.uint32(hi)),
                    jnp.uint32(seed))
                # match the device-side spawn test (floor(z/nzl) == rank
                # exactly): entries that round onto/over the outer Z face
                # are unowned (-1), not clipped into the last slab where
                # they would spawn dead yet count toward own_n
                z = np.asarray(pos[:, 2], np.float64)
                z = np.where(np.isfinite(z), z, -1.0)   # dead-at-birth
                z = np.clip(z, -1.0, S * nzl + 1.0)     # int32-safe
                ow = np.floor(z / nzl).astype(np.int32)
                ow[(ow < 0) | (ow >= S)] = -1
                owner[i0:i0 + len(ids)] = ow
        else:
            from ..transport.sources import GENERATORS
            gen = GENERATORS[statics[0]]
            params, _ = src_values
            nx, ny, nz = slabs.nx, slabs.ny, slabs.nz
            dummy = Grid(dens=jnp.zeros(1, jnp.float32),
                         lcells=jnp.asarray([nx * ny * nz], jnp.int32),
                         off=jnp.zeros(1, jnp.int32),
                         par=jnp.zeros(1, jnp.int32),
                         nx=nx, ny=ny, nz=nz, levels=1,
                         cells=nx * ny * nz)
            for i0 in range(0, total, chunk):
                ids = jnp.arange(i0, min(i0 + chunk, total),
                                 dtype=jnp.int32)
                nb = gen(dummy, ids, jnp.uint32(seed), params)
                z = np.asarray(nb.pos[:, 2], np.float64)
                # dead-at-birth lanes carry non-finite or sentinel-huge
                # positions: anything outside the grid maps to -1 below,
                # so clamp into int32-safe range before the cast
                z = np.where(np.isfinite(z), z, -1.0)
                z = np.clip(z, -1.0, S * nzl + 1.0)
                ow = np.floor(z / nzl).astype(np.int32)
                ow[(ow < 0) | (ow >= S)] = -1       # off the Z faces
                ow[np.asarray(nb.ind) < 0] = -1     # dead at birth
                owner[i0:i0 + len(ids)] = ow
    counts = np.bincount(owner[owner >= 0], minlength=S)
    pad = max(64, int(counts.max()), -(-total // S) + total // (2 * S))
    pad = 1 << (pad - 1).bit_length()
    own_ids = np.zeros((S, pad), np.int32)
    for si in range(S):
        lst = np.nonzero(owner == si)[0]
        own_ids[si, :len(lst)] = lst
    return (jnp.asarray(own_ids), jnp.asarray(counts.astype(np.int32)),
            pad)


_RUNNER_CACHE = {}


def _domain_call(slabs, physics, total_packets, seed, mesh, nlanes,
                 k_inner, max_super, spawn_kind, statics, src_values,
                 extra_arrays=(), extra_specs=(), features=None,
                 raw=False):
    """Invoke the cached jitted Z-slab runner and assemble host tallies.

    Returns (tabs [GLOBAL CELLS], escaped, lost, aux): aux carries 'intf'
    (per-frequency column, [CELLS] or [CELLS, 4]) and 'xab' ([CELLS])
    when the corresponding features are on.
    """
    feat = dict(_DEFAULT_FEATURES)
    feat.update(features or {})
    S = slabs.n_slabs
    assert mesh.shape["dp"] == S, "dp axis must equal the slab count"
    assert mesh.shape.get("freq", 1) == 1, "freq axis unused here"
    bins = physics["csc"].shape[-1]
    # split the physics dict: per-cell GLOBAL arrays are remapped to
    # slab-local [S, cells_pad(, ...)] and sharded over dp; the rest is
    # replicated. The ALI self-check additionally needs the local->global
    # cell map.
    phys_rep, phys_loc = {}, {}
    gidx = np.maximum(slabs.gidx, 0)
    for k, v in physics.items():
        if k in _PER_CELL_PHYSICS:
            g = np.asarray(v)
            loc = g[gidx]                      # [S, cells_pad(, D)]
            loc[slabs.gidx < 0] = 0
            phys_loc[k] = jnp.asarray(loc)
        else:
            phys_rep[k] = v
    if feat["with_ali"]:
        phys_loc["gidx"] = jnp.asarray(slabs.gidx)
    feat_key = tuple(sorted(feat.items()))
    key = (spawn_kind, statics, S, slabs.nx, slabs.ny, slabs.nz,
           slabs.nz_local, slabs.levels, slabs.cells_pad,
           tuple(int(x) for x in slabs.off), nlanes, k_inner, max_super,
           bins, len(extra_specs), mesh, feat_key,
           tuple(sorted(phys_rep)), tuple(sorted(phys_loc)))
    own_ids, own_n, pad = _owner_lists(slabs, spawn_kind, statics,
                                       src_values, total_packets, seed)
    key = key + (pad,)
    runner = _RUNNER_CACHE.get(key)
    if runner is None:
        runner = _build_domain_runner(slabs, mesh, nlanes, k_inner,
                                      max_super, spawn_kind, statics,
                                      tuple(extra_specs), feat)
        _RUNNER_CACHE[key] = runner
    tabs_s, intf_s, xab_s, esc, lost = runner(
        jnp.asarray(slabs.dens), jnp.asarray(slabs.lcells),
        jnp.asarray(slabs.par), phys_rep, phys_loc, tuple(src_values),
        own_ids, own_n, jnp.uint32(seed), *extra_arrays)
    if raw:
        # device-resident tallies in the per-slab [S, cells_pad(, D)]
        # layout: a per-frequency loop accumulates these ON DEVICE and
        # assembles once at the end (driver._run_domain_freqs), instead
        # of one host round-trip per channel
        return tabs_s, intf_s, xab_s, esc, lost
    aux = {}
    if feat["per_freq_tally"]:
        aux["intf"] = assemble_slab_tallies(
            slabs, intf_s, (feat["icomps"],) if feat["icomps"] else ())
    if feat["with_ali"]:
        aux["xab"] = assemble_slab_tallies(slabs, xab_s)
    tabs = assemble_slab_tallies(slabs, tabs_s)
    return tabs, float(np.asarray(esc)), float(np.asarray(lost)), aux


def assemble_slab_tallies(slabs, arr_s, extra_shape=()):
    """Per-slab local tallies [S, cells_pad(, D)] -> global [CELLS(, D)]
    host array (drops the padding cells via the gidx ownership map)."""
    total_cells = int(np.sum(np.asarray(slabs.lcells)))
    arr_s = np.asarray(arr_s).reshape((slabs.n_slabs, slabs.cells_pad)
                                      + extra_shape)
    out = np.zeros((total_cells,) + extra_shape, np.float32)
    for s in range(slabs.n_slabs):
        m = slabs.gidx[s] >= 0
        out[slabs.gidx[s][m]] = arr_s[s][m]
    return out


def _build_domain_runner(slabs, mesh, nlanes, k_inner, max_super,
                         spawn_kind, statics, extra_specs, feat):
    """Build the jitted shard_map superstep loop for one static config.

    The stepping inside is transport_run's own StepKit (march/service
    split, deferred octree descent, WITH_ABU/MSF, step/direction
    weighting, ALI, per-frequency tallies, splitting, rank-aware mirror
    boundaries) -- this runner only adds the Z-slab specifics: slab
    ownership at spawn, the emigrant pack/ppermute/pending-queue exchange,
    and the slab-local tally assembly. Everything that varies per
    frequency (cross sections, photon weights, hi, seed, budget) is a
    traced argument, so a frequency loop compiles exactly once.
    """
    import os
    from ..transport.propagate import (PacketBatch, init_split_state,
                                       make_dead, make_step_fns,
                                       serve_clones)
    from ..transport.sources import _isotropic_dir, _uniforms
    S = slabs.n_slabs
    nx, ny, nz, nzl = slabs.nx, slabs.ny, slabs.nz, slabs.nz_local
    levels, cells_pad = slabs.levels, slabs.cells_pad
    PCAP = 4 * nlanes
    fwd = [(i, (i + 1) % S) for i in range(S)]       # to upper neighbor
    bwd = [(i, (i - 1) % S) for i in range(S)]       # to lower neighbor
    off_l = np.asarray(slabs.off)
    off_c = jnp.asarray(slabs.off)
    per_freq_tally = bool(feat["per_freq_tally"])
    icomps = int(feat["icomps"])
    with_ali = bool(feat["with_ali"])
    mirror_mask = int(feat["mirror_mask"])
    split_max = int(feat["split_max"])
    service_period = int(os.environ.get("SOC_TPU_SERVICE_PERIOD", "16"))
    service_period = min(service_period, k_inner)

    def local_grid(dens_l, lcells_l, par_l):
        return Grid(dens=dens_l, lcells=lcells_l, off=off_c, par=par_l,
                    nx=nx, ny=ny, nz=nzl, levels=levels, cells=cells_pad)

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P("dp"), P("dp"), P("dp"),
                       P(), P("dp"), P(), P("dp"), P("dp"), P())
                      + tuple(extra_specs),
             out_specs=(P("dp"), P("dp"), P("dp"), P(), P()),
             check_vma=False)
    def run(dens_s, lcells_s, par_s, phys_rep, phys_loc, srcv,
            own_ids, own_n, seed, *extras):
        rank = lax.axis_index("dp")
        grid = local_grid(dens_s[0], lcells_s[0], par_s[0])
        own_l = own_ids[0]            # this slab's owned packet ids
        n_own = own_n[0]
        pad_own = own_l.shape[0]
        physics = dict(phys_rep)
        physics.update({k: v[0] for k, v in phys_loc.items()})
        kit = make_step_fns(
            grid, physics, seed, per_freq_tally=per_freq_tally,
            with_ali=with_ali, mirror_mask=mirror_mask,
            split_max=split_max,
            domain=dict(rank=rank, n_slabs=S, nz_local=nzl))
        do_split = kit.do_split

        if spawn_kind == "bg":
            bg_photons, hi = srcv

            def spawn_from_ids(ids, can):
                """Global source eval + slab-ownership filter."""
                stream = ids.astype(jnp.uint32)
                hiv = jnp.full_like(stream, hi)
                pos_g, dir = background_entry(nx, ny, nz, stream, hiv,
                                              seed)
                own = (jnp.floor(pos_g[:, 2] / nzl).astype(jnp.int32)
                       == rank)
                ok = can & own
                pos_l = pos_g.at[:, 2].add(-(rank * nzl)
                                           .astype(jnp.float32))
                pos_l = pos_l.at[:, 2].set(
                    jnp.clip(pos_l[:, 2], PEPS, nzl - PEPS))
                p, lev, ind = traverse.index_global(grid, pos_l)
                ind = jnp.where(ok, ind, -1)
                fp, w = kit.draw_birth_fp(stream, hiv)
                ph = jnp.full(ids.shape, bg_photons, jnp.float32)
                if kit.sw_a is not None:
                    ph = ph * w
                b = PacketBatch(
                    pos=p, dir=dir, level=lev, ind=ind, photons=ph,
                    ifreq=jnp.zeros_like(ind), stream=stream, hi=hiv,
                    counter=jnp.full_like(stream, 3),
                    scatterings=jnp.zeros_like(ind),
                    e_cell=jnp.full_like(ind, -1))
                return b, fp
        elif spawn_kind == "gen":
            # generic geometry-only source: evaluate the global generator
            # on a levels==1 dummy grid (entry positions never read the
            # density at level 0), keep the slab's own ids, re-index on
            # the local octree
            from ..transport.sources import GENERATORS
            gen_name = statics[0]
            gen = GENERATORS[gen_name]
            params_t, _ = srcv
            dummy = Grid(dens=jnp.zeros(1, jnp.float32),
                         lcells=jnp.asarray([nx * ny * nz], jnp.int32),
                         off=jnp.zeros(1, jnp.int32),
                         par=jnp.zeros(1, jnp.int32),
                         nx=nx, ny=ny, nz=nz, levels=1, cells=nx * ny * nz)

            def spawn_from_ids(ids, can):
                nb = gen(dummy, ids, seed, params_t)
                own = (jnp.floor(nb.pos[:, 2] / nzl).astype(jnp.int32)
                       == rank)
                ok = can & own & (nb.ind >= 0)
                pos_l = nb.pos.at[:, 2].add(-(rank * nzl)
                                            .astype(jnp.float32))
                pos_l = pos_l.at[:, 2].set(
                    jnp.clip(pos_l[:, 2], PEPS, nzl - PEPS))
                p, lev, ind = traverse.index_global(grid, pos_l)
                ind = jnp.where(ok, ind, -1)
                fp, w = kit.draw_birth_fp(nb.stream, nb.hi)
                ph = nb.photons
                if kit.sw_a is not None:
                    ph = ph * w
                b = PacketBatch(
                    pos=p, dir=nb.dir, level=lev, ind=ind, photons=ph,
                    ifreq=jnp.zeros_like(ind), stream=nb.stream, hi=nb.hi,
                    counter=nb.counter,
                    scatterings=jnp.zeros_like(ind),
                    e_cell=jnp.full_like(ind, -1))
                return b, fp
        else:
            per_cell, gcells, has_com = statics
            if has_com:
                emit_g, hi, com_g = srcv
            else:
                emit_g, hi = srcv
            inv_l = extras[0][0]

            def spawn_from_ids(ids, can):
                stream = ids.astype(jnp.uint32)
                hiv = jnp.full_like(stream, hi)
                if has_com:
                    gcell = jnp.clip(com_g[ids], 0, gcells - 1)
                else:
                    gcell = jnp.clip(ids // per_cell, 0, gcells - 1)
                lflat = inv_l[gcell]
                own = lflat >= 0
                ok = can & own
                lflat = jnp.maximum(lflat, 0)
                lev = jnp.zeros_like(lflat)
                for l in range(1, levels):
                    lev = jnp.where(lflat >= off_l[l], l, lev)
                loc = lflat - off_c[lev]
                u1, u2, u3, u4, u5, _ = _uniforms(seed, stream, hiv)
                if levels == 1:
                    x0 = (loc % nx).astype(jnp.float32)
                    y0 = ((loc // nx) % ny).astype(jnp.float32)
                    z0 = (loc // (nx * ny)).astype(jnp.float32)
                else:
                    sid = loc % 8
                    rx = (loc % nx).astype(jnp.float32)
                    ry = ((loc // nx) % ny).astype(jnp.float32)
                    rz = (loc // (nx * ny)).astype(jnp.float32)
                    x0 = jnp.where(lev == 0, rx,
                                   (sid % 2).astype(jnp.float32))
                    y0 = jnp.where(lev == 0, ry,
                                   ((sid // 2) % 2).astype(jnp.float32))
                    z0 = jnp.where(lev == 0, rz,
                                   (sid // 4).astype(jnp.float32))
                pos = jnp.stack([x0 + u1, y0 + u2, z0 + u3], -1)
                dir = _isotropic_dir(u4, u5).astype(jnp.float32)
                photons = emit_g[gcell]
                ind = jnp.where(ok, loc.astype(jnp.int32), -1)
                fp, w = kit.draw_birth_fp(stream, hiv)
                if kit.sw_a is not None:
                    photons = photons * w
                b = PacketBatch(
                    pos=pos, dir=dir, level=lev.astype(jnp.int32), ind=ind,
                    photons=photons, ifreq=jnp.zeros_like(ind),
                    stream=stream, hi=hiv,
                    counter=jnp.full_like(stream, 3),
                    scatterings=jnp.zeros_like(ind),
                    e_cell=gcell.astype(jnp.int32))
                return b, fp

        def superstep(carry):
            (it, b, pending, free_path, tau, emig, sp, pend, pend_n,
             next_id, tabs, intf, xab, esc, esc_pending, absd, lost,
             g_active) = carry

            # ---- flush escaped weight of lanes that died mid-block
            dead = (b.ind < 0) & (emig == 0)
            esc = esc + jnp.sum(jnp.where(dead, esc_pending, 0.0))
            esc_pending = jnp.where(dead, 0.0, esc_pending)

            # ---- serve pending split-clone requests into dead lanes
            if do_split:
                # anc=None: the superstep rebuilds stacks wholesale below
                b, pending, free_path, tau, sp, dead, _ = serve_clones(
                    seed, b, pending, free_path, tau, sp,
                    dead & (emig == 0))
                dead = (b.ind < 0) & (emig == 0)

            # ---- drain pending queue into free lanes
            free = dead
            fi = free.astype(jnp.int32)
            rankf = jnp.cumsum(fi) - fi
            take = free & (rankf < pend_n)
            slot = jnp.where(take, pend_n - 1 - rankf, 0)
            pk = _unpack(pend[slot])
            p2, plev, pind = traverse.index_global(grid, pk["pos"])
            tk = take[:, None]
            b = PacketBatch(
                pos=jnp.where(tk, p2, b.pos),
                dir=jnp.where(tk, pk["dir"], b.dir),
                level=jnp.where(take, plev, b.level),
                ind=jnp.where(take, jnp.where(pind >= 0, pind, -1), b.ind),
                photons=jnp.where(take, pk["photons"], b.photons),
                ifreq=b.ifreq,
                stream=jnp.where(take, pk["stream"], b.stream),
                hi=jnp.where(take, pk["hi"], b.hi),
                counter=jnp.where(take, pk["counter"], b.counter),
                scatterings=jnp.where(take, pk["scat"], b.scatterings),
                e_cell=jnp.where(take, pk["e_cell"], b.e_cell))
            free_path = jnp.where(take, pk["free_path"], free_path)
            tau = jnp.where(take, pk["tau"], tau)
            pending = pending & ~take
            if do_split:
                sp = {**sp,
                      "lane_depth": jnp.where(take, pk["depth"],
                                              sp["lane_depth"]),
                      "lane_path": jnp.where(take, pk["path"],
                                             sp["lane_path"])}
            pend_n = pend_n - jnp.sum(take.astype(jnp.int32))

            # ---- refill remaining free lanes from THIS slab's owned-id
            # list (no shared-budget scan: every drawn id is kept)
            free = (b.ind < 0) & (emig == 0)
            fi = free.astype(jnp.int32)
            rankf = jnp.cumsum(fi) - fi
            lidx = next_id + rankf
            can = free & (lidx < n_own)
            ids = own_l[jnp.clip(lidx, 0, pad_own - 1)]
            nb, sfp = spawn_from_ids(jnp.where(can, ids, 0), can)
            cl = can[:, None]
            b = PacketBatch(
                pos=jnp.where(cl, nb.pos, b.pos),
                dir=jnp.where(cl, nb.dir, b.dir),
                level=jnp.where(can, nb.level, b.level),
                ind=jnp.where(can, nb.ind, b.ind),
                photons=jnp.where(can, nb.photons, b.photons),
                ifreq=b.ifreq,
                stream=jnp.where(can, nb.stream, b.stream),
                hi=jnp.where(can, nb.hi, b.hi),
                counter=jnp.where(can, nb.counter, b.counter),
                scatterings=jnp.where(can, nb.scatterings, b.scatterings),
                e_cell=jnp.where(can, nb.e_cell, b.e_cell))
            free_path = jnp.where(can, sfp, free_path)
            tau = jnp.where(can, 0.0, tau)
            pending = pending & ~can
            if do_split:
                sp = {**sp,
                      "lane_depth": jnp.where(can, 0, sp["lane_depth"]),
                      "lane_path": jnp.where(can, jnp.uint32(0),
                                             sp["lane_path"])}
            next_id = next_id + jnp.sum(can.astype(jnp.int32))

            # ---- k_inner shared-physics steps (service + march blocks,
            # exactly transport_run's inner loop; ancestor stack rebuilt
            # once per superstep: arrivals and refills just changed lanes)
            anc = traverse.stack_from_par(grid, b.level, b.ind)
            lane_c = kit.lane_const_of(b)
            roi_c = jnp.zeros(1, jnp.float32)
            st = (b, pending, free_path, tau, tabs, intf, esc_pending,
                  absd, xab, roi_c, sp, anc, lane_c, emig)
            for _ in range(max(1, k_inner // service_period)):
                st = kit.service(*st)
                st = lax.fori_loop(0, service_period,
                                   lambda _, s: kit.march(*s), st)
            (b, pending, free_path, tau, tabs, intf, esc_pending, absd,
             xab, roi_c, sp, anc, lane_c, emig) = st

            # ---- pack + exchange emigrants (z shifted to neighbor frame)
            def pack_dirn(sign):
                sel = emig == sign
                si = sel.astype(jnp.int32)
                ranks = jnp.cumsum(si) - si
                slot = jnp.where(sel, ranks, nlanes)
                zshift = jnp.where(sign > 0, -float(nzl), float(nzl))
                posz = b.pos.at[:, 2].add(zshift)
                posz = posz.at[:, 2].set(
                    jnp.clip(posz[:, 2], PEPS, nzl - PEPS))
                bb = PacketBatch(
                    pos=posz, dir=b.dir, level=b.level, ind=b.ind,
                    photons=b.photons, ifreq=b.ifreq, stream=b.stream,
                    hi=b.hi, counter=b.counter,
                    scatterings=b.scatterings, e_cell=b.e_cell)
                payload = _pack(bb, free_path, tau, sp)
                buf = jnp.zeros((nlanes + 1, _PK), jnp.float32)
                buf = buf.at[slot].set(payload, mode="drop")
                return buf[:nlanes], jnp.sum(si)

            up_buf, n_up = pack_dirn(1)
            dn_buf, n_dn = pack_dirn(-1)
            emig = jnp.zeros_like(emig)
            # ring permute; the wrap-around entries carry count 0
            r_up = lax.ppermute(up_buf, "dp", fwd)
            c_up = lax.ppermute(jnp.where(rank == S - 1, 0, n_up), "dp",
                                fwd)
            r_dn = lax.ppermute(dn_buf, "dp", bwd)
            c_dn = lax.ppermute(jnp.where(rank == 0, 0, n_dn), "dp", bwd)

            # ---- append arrivals to the pending queue; arrivals past the
            # queue capacity go to the OOB drop slot (index PCAP) rather
            # than clobbering slot PCAP-1 with a stale payload, and their
            # photon weight is charged to the `lost` counter so energy
            # non-conservation is VISIBLE to the caller (lost stays 0
            # unless a slab receives > 4*nlanes undrained arrivals)
            idx = pend_n + jnp.arange(nlanes)
            arr = jnp.arange(nlanes) < c_up
            okl = arr & (idx < PCAP)
            lost = lost + jnp.sum(jnp.where(arr & ~okl, r_up[:, 6], 0.0))
            pend = pend.at[jnp.where(okl, idx, PCAP)].set(r_up, mode="drop")
            pend_n = jnp.minimum(pend_n + c_up, PCAP)
            idx = pend_n + jnp.arange(nlanes)
            arr = jnp.arange(nlanes) < c_dn
            okl = arr & (idx < PCAP)
            lost = lost + jnp.sum(jnp.where(arr & ~okl, r_dn[:, 6], 0.0))
            pend = pend.at[jnp.where(okl, idx, PCAP)].set(r_dn, mode="drop")
            pend_n = jnp.minimum(pend_n + c_dn, PCAP)

            active = (jnp.any(b.ind >= 0) | (next_id < n_own)
                      | (pend_n > 0))
            if do_split:
                active = active | jnp.any(sp["pending"])
            g_active = lax.psum(active.astype(jnp.int32), "dp")
            return (it + 1, b, pending, free_path, tau, emig, sp, pend,
                    pend_n, next_id, tabs, intf, xab, esc, esc_pending,
                    absd, lost, g_active)

        def cond(carry):
            return (carry[0] < max_super) & (carry[-1] > 0)

        n = nlanes
        if per_freq_tally:
            ishape = (cells_pad, 1, icomps) if icomps else (cells_pad, 1)
        else:
            ishape = (1, 1)
        carry = (jnp.int32(0), make_dead(n),
                 jnp.zeros(n, bool),                              # pending
                 jnp.zeros(n, jnp.float32),                       # free_path
                 jnp.zeros(n, jnp.float32),                       # tau
                 jnp.zeros(n, jnp.int32),                         # emig
                 init_split_state(n, grid.levels) if do_split else {},
                 jnp.zeros((PCAP, _PK), jnp.float32),             # pend
                 jnp.int32(0),                                    # pend_n
                 jnp.int32(0),                                    # next_id
                 jnp.zeros(cells_pad, jnp.float32),               # tabs
                 jnp.zeros(ishape, jnp.float32),                  # intf
                 jnp.zeros(cells_pad if with_ali else 1,
                           jnp.float32),                          # xab
                 jnp.float32(0.0),                                # esc
                 jnp.zeros(n, jnp.float32),                       # esc_pend
                 jnp.float32(0.0),                                # absd
                 jnp.float32(0.0),                                # lost
                 jnp.int32(1))                                    # g_active
        carry = lax.while_loop(cond, superstep, carry)
        b = carry[1]
        tabs = carry[10]
        intf = carry[11]
        xab = carry[12]
        esc = carry[13] + jnp.sum(carry[14])
        esc = lax.psum(esc, "dp")
        lost = lax.psum(carry[16], "dp")
        if per_freq_tally:
            intf_out = intf[:, 0]          # the single local channel
        else:
            intf_out = jnp.zeros(cells_pad, jnp.float32)
            if icomps:
                intf_out = jnp.zeros((cells_pad, icomps), jnp.float32)
        if not with_ali:
            xab = jnp.zeros(cells_pad, jnp.float32)
        return (tabs[None, :], intf_out[None], xab[None, :], esc, lost)

    return run
