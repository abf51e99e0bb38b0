"""Photon-packet propagation: the hot loop of the framework.

A redesign, for XLA, of the reference's per-work-item propagation loops
(SimRAM_PB/CL, kernel_ASOC.c:557-806). One fused ``lax.while_loop`` steps a
fixed-shape pool of packet lanes; every iteration advances each live packet by
one *event* (cell-boundary crossing or scattering) and immediately **refills
lanes that died** with fresh packets from the remaining budget via an
exclusive prefix-sum over dead lanes. This keeps lane occupancy near 100% for
the entire run -- in place of the reference's GPU oversubscription -- and
makes the random stream of every packet a pure function of its global id
(device-count and batch-size invariant).

Tallies are XLA scatter-adds; dead lanes scatter to an out-of-bounds index
with mode='drop' so they never serialize against cell 0.

Physics per step (kernel_ASOC.c semantics):
  * step to the next cell boundary; tau_abs = ds*n*k_abs, tau_sca = ds*n*k_sca
  * if the scattering free path ends inside the step: move there, deposit the
    partial absorption, draw a new direction from the inverse-CDF table and a
    new free path; kill after MAX_SCATTERINGS
  * else deposit delta = photons*(1-exp(-tau_abs)) (Taylor below TAULIM),
    attenuate, accumulate tau, cross into the next cell
  * failed steps are recovered by a PEPS nudge (kernel_ASOC.c:640-672)

March/service split: the step cost is dominated by gather/scatter memory
ops (scripts/ablate_step.py ablates them one by one), and the phase-function
table gather is one of the larger ones. Scattering events are only a few
percent of steps, so the loop is split: *march* steps do
traversal + deposit only, and a lane whose free path ends freezes at the
scattering point (``pending``); every ``service_period`` march steps a
*service* step draws the new direction + free path for all pending lanes at
once. The counter-based RNG makes the delay bias-free (draws are keyed by
(stream, counter), not by wall-clock step) and keeps every packet's random
sequence device-count invariant: counters advance only when draws are
consumed (birth + one evaluation per scattering event).

The step physics itself is packaged by ``make_step_fns`` into a StepKit so
the Z-slab domain-decomposed runner (parallel/domain.py) drives the SAME
march/service code -- domain runs differ only in the emigrant hook (exits
through interior slab faces freeze for the halo exchange instead of
escaping), never in the physics.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..constants import (ADHOC, DEPS, MAX_SCATTERINGS, PEPS, PHOTON_LIMIT,
                         TAULIM)
from ..ops import traverse
from ..ops.traverse import _suboct as _suboct_of
from .. import rng as socrng


@jax.tree_util.register_dataclass
@dataclass
class PacketBatch:
    """SoA packet state; all arrays share the lane axis [N]."""

    pos: jax.Array        # [N, 3] level-local coordinates
    dir: jax.Array        # [N, 3] unit direction
    level: jax.Array      # [N] int32 hierarchy level
    ind: jax.Array        # [N] int32 level-local cell index, -1 = dead
    photons: jax.Array    # [N] float32 photon weight
    ifreq: jax.Array      # [N] int32 frequency channel
    stream: jax.Array     # [N] uint32 RNG stream id low word (in-freq index)
    hi: jax.Array         # [N] uint32 stream id high word (phase|iter|freq)
    counter: jax.Array    # [N] uint32 RNG draw counter
    scatterings: jax.Array  # [N] int32
    e_cell: jax.Array     # [N] int32 emitting cell (ALI); -1 otherwise
    # [N, levels-1] ancestor stack of the birth cell, set by the source
    # generators (the leaf walk they already do records it for free) so
    # the refill step needs no PAR gathers; None outside the refill path
    anc: jax.Array | None = None

    @property
    def lanes(self):
        return self.pos.shape[0]


def _deflect(dir, cos_theta, phi):
    """Rotate unit vectors by theta around a uniform azimuth (distributionally
    equivalent to the reference's Deflect, kernel_ASOC_aux.c:499)."""
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    ax = jnp.abs(dir[..., 0])
    helper = jnp.where((ax < 0.9)[..., None],
                       jnp.asarray([1.0, 0.0, 0.0], dir.dtype),
                       jnp.asarray([0.0, 1.0, 0.0], dir.dtype))
    t1 = jnp.cross(dir, helper)
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = jnp.cross(dir, t1)
    new = (cos_theta[..., None] * dir
           + (sin_theta * jnp.cos(phi))[..., None] * t1
           + (sin_theta * jnp.sin(phi))[..., None] * t2)
    new = jnp.where(jnp.abs(new) < DEPS, DEPS, new)
    return new / jnp.linalg.norm(new, axis=-1, keepdims=True)


def _csc_lookup(csc_table, ifreq, u_bin, bins):
    """cos(theta) from the cumulative-scattering inverse-CDF table.

    csc_table is either [BINS] (uniform-frequency fast path: 1-D gather) or
    [NFREQ, BINS] (mixed-frequency pool)."""
    bin_idx = jnp.clip((u_bin * bins).astype(jnp.int32), 0, bins - 1)
    if csc_table.ndim == 1:
        return csc_table[bin_idx]
    return csc_table[ifreq, bin_idx]


def make_dead(n):
    """A fully dead packet batch of n lanes."""
    z3 = jnp.zeros((n, 3), jnp.float32)
    zi = jnp.full(n, -1, jnp.int32)
    return PacketBatch(
        pos=z3, dir=z3 + (1.0 / np.sqrt(3.0)),
        level=jnp.zeros(n, jnp.int32), ind=zi,
        photons=jnp.zeros(n, jnp.float32),
        ifreq=jnp.zeros(n, jnp.int32),
        stream=jnp.zeros(n, jnp.uint32),
        hi=jnp.zeros(n, jnp.uint32),
        counter=jnp.zeros(n, jnp.uint32),
        scatterings=jnp.zeros(n, jnp.int32),
        e_cell=jnp.full(n, -1, jnp.int32))


def init_split_state(nlanes, levels=1):
    """Fresh per-lane split/clone bookkeeping (see transport_run split_max)."""
    return dict(anc=jnp.zeros((nlanes, max(levels - 1, 1)), jnp.int32),
                pos=jnp.zeros((nlanes, 3), jnp.float32),
                dir=jnp.zeros((nlanes, 3), jnp.float32),
                level=jnp.zeros(nlanes, jnp.int32),
                ind=jnp.zeros(nlanes, jnp.int32),
                photons=jnp.zeros(nlanes, jnp.float32),
                ifreq=jnp.zeros(nlanes, jnp.int32),
                stream=jnp.zeros(nlanes, jnp.uint32),
                hi=jnp.zeros(nlanes, jnp.uint32),
                path=jnp.zeros(nlanes, jnp.uint32),
                depth=jnp.zeros(nlanes, jnp.int32),
                face=jnp.zeros(nlanes, jnp.int32),
                lane_depth=jnp.zeros(nlanes, jnp.int32),
                lane_path=jnp.zeros(nlanes, jnp.uint32),
                pending=jnp.zeros(nlanes, bool),
                clones=jnp.uint32(0))


def serve_clones(seed, b, pending, free_path, tau, sp, dead, anc=None):
    """Serve pending split-clone requests into dead lanes (shared by the
    single-device refill and the domain superstep). Returns the updated
    (b, pending, free_path, tau, sp, dead, anc); adopted lanes inherit
    the donor's ancestor stack recorded at split time (pass anc=None to
    skip -- the domain superstep rebuilds stacks wholesale instead)."""
    nlanes = b.lanes
    di = dead.astype(jnp.int32)
    drank = jnp.cumsum(di) - di
    pend = sp["pending"]
    pi = pend.astype(jnp.int32)
    prank = jnp.cumsum(pi) - pi
    n_pend = jnp.sum(pi)
    n_dead = jnp.sum(di)
    lanes_idx = jnp.arange(nlanes, dtype=jnp.int32)
    donor_map = jnp.zeros(nlanes, jnp.int32).at[
        jnp.where(pend, prank, nlanes)].set(lanes_idx, mode="drop")
    adopt = dead & (drank < n_pend)
    donor = donor_map[jnp.clip(drank, 0, nlanes - 1)]
    new_stream = sp["stream"][donor]
    hi_clone = sp["hi"][donor]
    cbase = sp["path"][donor] * jnp.uint32(64)
    # re-sample the clone's entry point over the crossed octet
    # face (tangential coords uniform in [PEPS, 2-PEPS]); draw
    # from the clone's own counter block
    u1, u2 = socrng.uniform2(seed, new_stream, cbase, hi_clone)
    dpos = sp["pos"][donor]
    axis = sp["face"][donor]                  # 0/1/2 crossing axis
    span = jnp.float32(2.0 - 2.0 * PEPS)
    t1 = PEPS + span * u1
    t2 = PEPS + span * u2
    jpos = jnp.stack([
        jnp.where(axis == 0, dpos[:, 0],
                  jnp.where(axis == 1, t1, t1)),
        jnp.where(axis == 1, dpos[:, 1],
                  jnp.where(axis == 0, t1, t2)),
        jnp.where(axis == 2, dpos[:, 2], t2)], axis=1)
    # deepest-level octets only: at level 0 keep the exact position
    jpos = jnp.where((sp["level"][donor] > 0)[:, None], jpos, dpos)
    # recompute the sub-cell index within the same octet
    first = sp["ind"][donor] - _suboct_of(dpos)
    jind = jnp.where(sp["level"][donor] > 0,
                     first + _suboct_of(jpos), sp["ind"][donor])
    al = adopt[..., None]
    b = PacketBatch(
        pos=jnp.where(al, jpos, b.pos),
        dir=jnp.where(al, sp["dir"][donor], b.dir),
        level=jnp.where(adopt, sp["level"][donor], b.level),
        ind=jnp.where(adopt, jind, b.ind),
        photons=jnp.where(adopt, sp["photons"][donor], b.photons),
        ifreq=jnp.where(adopt, sp["ifreq"][donor], b.ifreq),
        stream=jnp.where(adopt, new_stream, b.stream),
        hi=jnp.where(adopt, hi_clone, b.hi),
        counter=jnp.where(adopt, cbase + jnp.uint32(3), b.counter),
        scatterings=jnp.where(adopt, 0, b.scatterings),
        e_cell=jnp.where(adopt, -1, b.e_cell))
    # birth free path from slot cbase+2 for clones, slot 2 for
    # everyone else (the batch-wide draw is masked away)
    fp_u = socrng.uniform1(
        seed, b.stream,
        jnp.where(adopt, cbase + jnp.uint32(2), jnp.uint32(2)),
        b.hi)
    free_path = jnp.where(adopt, -jnp.log(fp_u), free_path)
    tau = jnp.where(adopt, 0.0, tau)
    pending = pending & ~adopt
    sp = {**sp,
          "lane_depth": jnp.where(adopt, sp["depth"][donor],
                                  sp["lane_depth"]),
          "lane_path": jnp.where(adopt, sp["path"][donor],
                                 sp["lane_path"]),
          "pending": pend & ~(prank < n_dead),
          "clones": sp["clones"]
          + jnp.sum(adopt.astype(jnp.uint32))}
    if anc is not None:
        anc = jnp.where(al, sp["anc"][donor], anc)
    return b, pending, free_path, tau, sp, b.ind < 0, anc


class StepKit:
    """The march/service physics of transport_run, packaged for reuse.

    Built by ``make_step_fns``; used by transport_run (the single-device
    lane pool) AND by parallel/domain.py (the Z-slab superstep loop), so
    there is exactly ONE implementation of the step physics in the
    framework.
    """

    def __init__(self, service, march, draw_birth_fp, draw_fp_weighted,
                 lane_const, lane_const_of, do_split, split_max, sw_a):
        self.service = service
        self.march = march
        self.draw_birth_fp = draw_birth_fp
        self.draw_fp_weighted = draw_fp_weighted
        self.lane_const = lane_const
        self.lane_const_of = lane_const_of
        self.do_split = do_split
        self.split_max = split_max
        self.sw_a = sw_a


def make_step_fns(grid, physics, seed, *, per_freq_tally=False,
                  esc_bins=1, with_ali=False, roi_nside=0, mirror_mask=0,
                  split_max=0, domain=None):
    """Build the (service, march) step functions over the canonical state

      (b, pending, free_path, tau, tabs, intf, esc_pending, absd, xab_c,
       roi_c, sp, anc, lane_c, emig)

    ``domain``: None for the single-device pool, or a dict
      dict(rank=<traced dp index>, n_slabs=S, nz_local=nzl)
    enabling Z-slab emigrant detection: a packet exiting through an
    interior slab face freezes with emig=+-1 (handed to the neighbor by
    the caller's exchange) instead of escaping, and mirrored Z faces apply
    only on the boundary slabs. All other physics -- absorption deposits,
    scattering, ALI self-absorption, per-frequency tallies, per-cell
    abundances (WITH_ABU/MSF), step/direction weighting, splitting, ROI
    crossings -- is shared verbatim between the two execution modes.
    """
    csc = physics["csc"]
    bins = csc.shape[-1]
    kabs_t = physics["kabs"]
    ksca_t = physics["ksca"]
    tw_t = physics["tw"]
    uniform_freq = (jnp.ndim(kabs_t) == 0)
    cells = grid.cells

    # Mixed-frequency pools: per-lane dynamic-row gathers (csc[ifreq, bin]
    # and kabs/ksca/tw[ifreq]) are a large share of the step. A packet's
    # frequency is fixed for
    # its whole life, so hoist those gathers out of the inner step: once per
    # refill body we materialize per-lane kabs/ksca/tw and a flattened-CSC
    # row offset (loop-invariant across the refill_period inner steps), and
    # the step's phase-function lookup becomes a single 1-D gather.
    lane_const = (not uniform_freq and "opt_abs" not in physics
                  and "msf_csc" not in physics and "dw_a" not in physics)
    csc_flat = csc.reshape(-1) if lane_const else None

    # STEP_WEIGHT free-path stretching (kernel_ASOC.c:516-541). sw_a in
    # physics enables it; method 1 (sw_a alone): p(tau) = A exp(-A tau),
    # weight exp((A-1) tau)/A. Method 2 (sw_a + sw_b): the two-exponential
    # mixture p(tau) = A B exp(-A tau) + 2 A (1-B) exp(-2 A tau), sampled
    # by the closed-form inverse CDF ((1-B) x^2 + B x = u with
    # x = exp(-A tau)), weight exp(-tau)/p(tau) -- the exact quadratic and
    # weight expressions of the reference kernel.
    sw_a = physics.get("sw_a", None)
    sw_b = physics.get("sw_b", None)
    if sw_a is not None:
        split_max = 0          # splitting assumes memoryless free paths
    # clone RNG identity: a clone keeps the donor packet's (stream, hi)
    # and draws from a disjoint counter block 64*path, where `path` is the
    # binary split-path code (bit k set <=> this node is the clone branch
    # of a split at depth k+1). Unique per clone, independent of phase,
    # frequency, or host-side chunking -- unlike a global clone counter,
    # which collides across sources and across 4M-packet chunks. The
    # 64-slot block bound holds because a lane consumes at most 3 birth
    # slots + MAX_SCATTERINGS counter steps; path*64 stays in uint32 for
    # split_max <= 26.
    split_max = min(split_max, 26)
    do_split = split_max > 0

    if domain is not None:
        dom_rank = domain["rank"]
        dom_s = int(domain["n_slabs"])
        dom_nzl = int(domain["nz_local"])
        # slab-local -> global cell map for the ALI self-absorption check
        # (e_cell is a GLOBAL cell id; tally indices here are slab-local)
        dom_gidx = physics.get("gidx", None)

    def draw_fp_weighted(u):
        if sw_a is None:
            return -jnp.log(u), 1.0
        if sw_b is None:
            fp = -jnp.log(u) / sw_a
            return fp, jnp.exp(sw_a * fp - fp) / sw_a
        # STEP_WEIGHT==2 (kernel_ASOC.c:529-541)
        x = ((-sw_b + jnp.sqrt(sw_b * sw_b + 4.0 * u * (1.0 - sw_b)))
             / (2.0 - 2.0 * sw_b))
        fp = -jnp.log(jnp.maximum(x, 1e-30)) / sw_a
        w = 1.0 / (sw_a * sw_b * jnp.exp((1.0 - sw_a) * fp)
                   + 2.0 * sw_a * (1.0 - sw_b)
                   * jnp.exp((1.0 - 2.0 * sw_a) * fp))
        return fp, w

    def draw_birth_fp(stream, hi):
        # birth free path: counter slot 2, first word
        u = socrng.uniform1(seed, stream, jnp.full_like(stream, 2), hi)
        return draw_fp_weighted(u)

    def lane_const_of(b):
        if not lane_const:
            return ()
        return (kabs_t[b.ifreq], ksca_t[b.ifreq], tw_t[b.ifreq],
                b.ifreq * bins)

    def service(b, pending, free_path, tau, tabs, intf, esc_pending, absd,
                xab_c, roi_c, sp, anc, lane_c=(), emig=None):
        """Serve pending scattering events: one RNG evaluation, the
        phase-function table gather and the deflection, for every frozen
        lane at once (the expensive per-step work the march steps skip)."""
        act = pending & (b.ind >= 0)
        if "msf_csc" in physics:
            u_fp, u_bin, u_phi, u_sp = socrng.step_uniforms4(
                seed, b.stream, b.counter, b.hi)
        else:
            u_fp, u_bin, u_phi = socrng.step_uniforms(
                seed, b.stream, b.counter, b.hi)
        dw_corr = None
        if "msf_csc" in physics:
            # multiple scattering functions (WITH_MSF): pick the scattering
            # species with probability ABU[cell,d]*SCA_d / sum
            # (kernel_ASOC.c:786-795), then sample that species' CSC
            gidx = jnp.clip(grid.off[jnp.clip(b.level, 0, grid.levels - 1)]
                            + jnp.maximum(b.ind, 0), 0, cells - 1)
            msf_csc = physics["msf_csc"]          # [NDUST, BINS]
            wspec = (physics["msf_abu"][gidx, :]
                     * physics["msf_sca"][None, :])   # [N, NDUST]
            cdf = jnp.cumsum(wspec, axis=1)
            r = 0.99999 * u_sp * cdf[:, -1]
            species = jnp.sum((cdf < r[:, None]).astype(jnp.int32), axis=1)
            species = jnp.clip(species, 0, msf_csc.shape[0] - 1)
            bin_idx = jnp.clip((u_bin * bins).astype(jnp.int32), 0, bins - 1)
            cos_theta = msf_csc[species, bin_idx]
        elif "dw_a" in physics:
            # DIR_WEIGHT (WScatter, kernel_ASOC_aux.c:567): sample the
            # deflection from HG(DW_A) relative to the current direction,
            # weight correction p_DSC(cos)/p_HG(cos); incompatible with MSF
            # (as in the reference)
            a = physics["dw_a"]
            t = (1.0 - a * a) / (1.0 - a + 2.0 * a * u_bin)
            cos_theta = jnp.clip((1.0 + a * a - t * t)
                                 / (2.0 * a + 1e-6), -1.0, 1.0)
            p_hg = jnp.maximum(
                (1.0 / (4.0 * jnp.pi)) * (1.0 - a * a)
                / (1.0 + a * a - 2.0 * a * cos_theta) ** 1.5, 1e-6)
            dscv = physics["dsc"]
            dbin = jnp.clip(((1.0 + cos_theta) * 0.5 * dscv.shape[-1]
                             ).astype(jnp.int32), 0, dscv.shape[-1] - 1)
            p_true = jnp.maximum(dscv[dbin], 1e-6)
            dw_corr = p_true / p_hg
        elif lane_const:
            bin_idx = jnp.clip((u_bin * bins).astype(jnp.int32), 0, bins - 1)
            cos_theta = csc_flat[lane_c[3] + bin_idx]
        else:
            cos_theta = _csc_lookup(csc, b.ifreq, u_bin, bins)
        new_dir = _deflect(b.dir, cos_theta, (2.0 * jnp.pi) * u_phi)

        fp_next, w_next = draw_fp_weighted(u_fp)
        photons = b.photons
        if sw_a is not None:
            photons = jnp.where(act, photons * w_next, photons)
        if dw_corr is not None:
            photons = jnp.where(act, photons * dw_corr, photons)
        nb = PacketBatch(
            pos=b.pos,
            dir=jnp.where(act[..., None], new_dir, b.dir),
            level=b.level, ind=b.ind, photons=photons, ifreq=b.ifreq,
            stream=b.stream, hi=b.hi,
            counter=b.counter + act.astype(jnp.uint32),
            scatterings=b.scatterings, e_cell=b.e_cell)
        free_path = jnp.where(act, fp_next, free_path)
        tau = jnp.where(act, 0.0, tau)
        return (nb, pending & ~act, free_path, tau, tabs, intf, esc_pending,
                absd, xab_c, roi_c, sp, anc, lane_c, emig)

    def march(b, pending, free_path, tau, tabs, intf, esc_pending, absd,
              xab_c, roi_c, sp, anc, lane_c=(), emig=None):
        alive = b.ind >= 0
        active = alive & ~pending          # frozen lanes await service
        if domain is not None:
            active = active & (emig == 0)  # emigrants await the exchange
        gidx = jnp.clip(grid.off[jnp.clip(b.level, 0, grid.levels - 1)]
                        + jnp.maximum(b.ind, 0), 0, cells - 1)
        dens = grid.dens[gidx]
        # deferred descent: a lane may sit on a refined (link) cell -- the
        # density gather doubles as the link test, and such a lane spends
        # this step descending ONE level (ALU only) instead of marching.
        # This removes the (levels-1)-gather unrolled descent chain from
        # every step: each march step costs exactly one hierarchy gather.
        if grid.levels > 1:
            is_link = active & (dens <= 0.0)
            active = active & ~is_link
        else:
            is_link = jnp.zeros_like(active)
        if "opt_abs" in physics:
            # WITH_ABU: per-cell abundance-weighted cross sections for the
            # current frequency (reference OPT array, ASOC.py:1146-1175);
            # may be stored bfloat16 (optishalf) -- widen for the math
            kabs = physics["opt_abs"][gidx].astype(jnp.float32)
            ksca = physics["opt_sca"][gidx].astype(jnp.float32)
            tw = tw_t
        elif uniform_freq:
            kabs, ksca, tw = kabs_t, ksca_t, tw_t
        elif lane_const:
            kabs, ksca, tw = lane_c[0], lane_c[1], lane_c[2]
        else:
            kabs = kabs_t[b.ifreq]
            ksca = ksca_t[b.ifreq]
            tw = tw_t[b.ifreq]

        # ---- geometric step to next boundary
        ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
        ds_gl = ds_local * jnp.exp2(-b.level.astype(jnp.float32))
        tau_abs_full = ds_gl * dens * kabs
        dtau_sca = ds_gl * dens * ksca

        scatter_now = active & (free_path < tau + dtau_sca)

        # ---- scattering point inside this cell
        dx_gl = (free_path - tau) / jnp.maximum(ksca * dens, 1e-30)
        tau_abs_part = dx_gl * dens * kabs
        dx_local = jnp.maximum(
            0.0, dx_gl * jnp.exp2(b.level.astype(jnp.float32)) - 2.0 * PEPS)
        pos_scatter = b.pos + dx_local[..., None] * b.dir

        # ---- absorption deposit (shared scatter-add; dead lanes dropped OOB)
        tau_abs = jnp.where(scatter_now, tau_abs_part, tau_abs_full)
        att = jnp.exp(-tau_abs)
        delta = jnp.where(tau_abs > TAULIM,
                          b.photons * (1.0 - att),
                          b.photons * tau_abs * (1.0 - 0.5 * tau_abs))
        didx = jnp.where(active, gidx, cells)         # OOB => dropped
        if with_ali:
            if domain is not None and dom_gidx is not None:
                selfc = dom_gidx[jnp.clip(didx, 0, cells - 1)] == b.e_cell
            else:
                selfc = didx == b.e_cell
            tabs = tabs.at[jnp.where(selfc, cells, didx)].add(
                delta * tw * ADHOC, mode="drop")
            new_xab = xab_c.at[jnp.where(selfc, didx, cells)].add(
                delta * tw * ADHOC, mode="drop")
        else:
            tabs = tabs.at[didx].add(delta * tw * ADHOC, mode="drop")
            new_xab = xab_c
        if per_freq_tally:
            if intf.ndim == 3:
                # SAVE_INTENSITY==2: (I, Ix, Iy, Iz) component tallies
                # (reference INT/INTX/INTY/INTZ buffers, ASOC.py:35)
                w4 = jnp.concatenate([jnp.ones_like(delta)[:, None],
                                      b.dir], axis=1)
                intf = intf.at[didx, b.ifreq].add(delta[:, None] * w4,
                                                  mode="drop")
            else:
                intf = intf.at[didx, b.ifreq].add(delta, mode="drop")
        absd = absd + jnp.sum(jnp.where(active, delta, 0.0))
        photons = jnp.where(active, b.photons * att, b.photons)

        # ---- crossing branch: move into next cell (ancestor-stack
        # up-walk: no PAR gathers on the hot path)
        posx = jnp.where(active[..., None], pos_boundary, b.pos)
        cross = active & ~scatter_now
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, anc, cross, descend=False)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)
        dirx = b.dir
        if mirror_mask:
            # mirrored faces reflect exiting packets back inside (Mirror,
            # kernel_ASOC_aux.c:1054; ini keyword 'mirror xXyYzZ').
            # exited lanes hold root coordinates in npos. Under domain
            # decomposition the Z faces are mirrored only on the boundary
            # slabs (interior slab faces belong to the halo exchange).
            bounds = jnp.asarray([grid.nx, grid.ny, grid.nz], jnp.float32)
            exiting = cross & (nind < 0)
            lo_hit = npos <= 0.0
            hi_hit = npos >= bounds
            if domain is None:
                lo_m = jnp.asarray([bool(mirror_mask & 1),
                                    bool(mirror_mask & 4),
                                    bool(mirror_mask & 16)])
                hi_m = jnp.asarray([bool(mirror_mask & 2),
                                    bool(mirror_mask & 8),
                                    bool(mirror_mask & 32)])
                lo_m = lo_m[None, :]
                hi_m = hi_m[None, :]
            else:
                lo_m = jnp.stack([
                    jnp.full((), bool(mirror_mask & 1)),
                    jnp.full((), bool(mirror_mask & 4)),
                    jnp.full((), bool(mirror_mask & 16)) & (dom_rank == 0)])
                hi_m = jnp.stack([
                    jnp.full((), bool(mirror_mask & 2)),
                    jnp.full((), bool(mirror_mask & 8)),
                    jnp.full((), bool(mirror_mask & 32))
                    & (dom_rank == dom_s - 1)])
                lo_m = lo_m[None, :]
                hi_m = hi_m[None, :]
            refl = (lo_hit & lo_m) | (hi_hit & hi_m)
            refl = refl & exiting[:, None]
            rpos = jnp.where(lo_hit, PEPS - npos,
                             jnp.where(hi_hit, 2.0 * bounds - PEPS - npos,
                                       npos))
            mpos = jnp.where(refl, jnp.clip(rpos, PEPS, bounds - PEPS),
                             npos)
            dirx = jnp.where(refl, -b.dir, b.dir)
            mirrored = jnp.any(refl, axis=-1)
            mp, ml, mi = traverse.index_global(grid, mpos)
            npos = jnp.where(mirrored[:, None], mp, npos)
            nlevel = jnp.where(mirrored, ml, nlevel)
            nind = jnp.where(mirrored, mi, nind)
            if grid.levels > 1:
                anc = jnp.where(mirrored[:, None],
                                traverse.stack_from_par(grid, ml, mi), anc)

        # ---- ROI save: packets that just crossed into the ROI box
        if roi_nside > 0:
            from .roi import roi_element_index
            from ..ops.traverse import root_pos
            roi_mask = physics["roi_mask"]
            new_gidx = jnp.clip(
                grid.off[jnp.clip(nlevel, 0, grid.levels - 1)]
                + jnp.maximum(nind, 0), 0, cells - 1)
            was_in = roi_mask[gidx]
            now_in = roi_mask[new_gidx] & (nind >= 0)
            entered = cross & now_in & ~was_in
            rp = root_pos(grid, npos, nlevel, nind)
            rnx, rny, rnz, rstep = physics["roi_dim"]
            elem = roi_element_index(rp, b.dir, physics["roi_box"],
                                     rnx, rny, rnz, rstep)
            npix_hp = 12 * roi_nside * roi_nside
            theta = jnp.arccos(jnp.clip(b.dir[:, 2], -1.0, 1.0))
            phi = jnp.arctan2(b.dir[:, 1], b.dir[:, 0])
            from ..render.healpix import ang2pix_ring
            hpix = ang2pix_ring(roi_nside, theta, phi)
            slot = jnp.where(entered, elem * npix_hp + hpix,
                             roi_c.shape[0])
            roi_c = roi_c.at[slot].add(photons, mode="drop")

        # ---- domain decomposition: exits through an interior slab face
        # freeze as emigrants (the caller's ppermute exchange moves them);
        # only exits through the global X/Y faces (and the outer Z faces
        # of the boundary slabs) escape
        exited = cross & (nind < 0)
        if domain is not None:
            out_xy = ((npos[:, 0] <= 0.0) | (npos[:, 0] >= grid.nx)
                      | (npos[:, 1] <= 0.0) | (npos[:, 1] >= grid.ny))
            z = npos[:, 2]
            go_up = exited & ~out_xy & (z >= 0.5 * dom_nzl) \
                & (dom_rank < dom_s - 1)
            go_dn = exited & ~out_xy & (z < 0.5 * dom_nzl) & (dom_rank > 0)
            new_emig = jnp.where(go_up, 1, jnp.where(go_dn, -1, 0))
            emig = jnp.where(active, new_emig, emig)
            exited = exited & (new_emig == 0)

        # ---- merge: scattering lanes freeze at the scattering point
        # (direction + new free path drawn at the next service step)
        pos = jnp.where(scatter_now[..., None], pos_scatter, npos)
        level = jnp.where(scatter_now, b.level, nlevel)
        ind = jnp.where(scatter_now, b.ind, nind)
        dir = jnp.where(scatter_now[..., None], b.dir, dirx)

        # ---- deferred descent: link lanes move one level down
        if grid.levels > 1:
            pos, level, ind, anc = traverse.descend_one(
                grid, pos, level, ind, anc, dens, is_link)

        # ---- packet splitting: at most ONE split in flight per lane --
        # the clone slot holds until the next refill body serves it, so a
        # multi-level descent within one body splits only at the first
        # crossed level (the reference's BUFFER stack spawns per level,
        # kernel_ASOC.c:3263-3360). Unbiased either way: the weight is
        # halved exactly when a clone is actually posted; the cost is
        # less variance reduction on deep (>1 level per ~refill_period
        # steps) descents, bounded by split_max as usual.
        if do_split:
            want = is_link & ~sp["pending"] \
                & (sp["lane_depth"] < split_max)
            photons = jnp.where(want, 0.5 * photons, photons)
            depth_new = sp["lane_depth"] + want.astype(jnp.int32)
            # crossing axis: the octet coordinate closest to a face
            fdist = jnp.minimum(pos, 2.0 - pos)
            face = jnp.argmin(fdist, axis=1).astype(jnp.int32)
            wl = want[..., None]
            clone_path = sp["lane_path"] | jnp.left_shift(
                jnp.uint32(1),
                jnp.clip(depth_new - 1, 0, 31).astype(jnp.uint32))
            sp = {**sp,
                  "pos": jnp.where(wl, pos, sp["pos"]),
                  "dir": jnp.where(wl, dir, sp["dir"]),
                  "level": jnp.where(want, level, sp["level"]),
                  "ind": jnp.where(want, ind, sp["ind"]),
                  "photons": jnp.where(want, photons, sp["photons"]),
                  "ifreq": jnp.where(want, b.ifreq, sp["ifreq"]),
                  "stream": jnp.where(want, b.stream, sp["stream"]),
                  "hi": jnp.where(want, b.hi, sp["hi"]),
                  "path": jnp.where(want, clone_path, sp["path"]),
                  "depth": jnp.where(want, depth_new, sp["depth"]),
                  "face": jnp.where(want, face, sp["face"]),
                  "anc": jnp.where(wl, anc, sp["anc"]),
                  "pending": sp["pending"] | want,
                  "lane_depth": depth_new}
        scat = b.scatterings + scatter_now.astype(jnp.int32)
        overscattered = scatter_now & (scat > MAX_SCATTERINGS)
        # magnitude test: WITH_REFERENCE delta packets carry NEGATIVE
        # weights that must keep propagating (the tally math is linear)
        exhausted = active & (jnp.abs(photons) < PHOTON_LIMIT)
        esc_pending = esc_pending + jnp.where(
            (exited | overscattered) & active, photons, 0.0)
        ind = jnp.where(overscattered | exhausted, jnp.int32(-1), ind)
        tau = jnp.where(scatter_now, 0.0,
                        jnp.where(cross, tau + dtau_sca, tau))
        pending = (pending | scatter_now) & (ind >= 0)

        nb = PacketBatch(pos=pos, dir=dir, level=level, ind=ind,
                         photons=photons, ifreq=b.ifreq, stream=b.stream,
                         hi=b.hi, counter=b.counter,
                         scatterings=scat, e_cell=b.e_cell)
        return (nb, pending, free_path, tau, tabs, intf, esc_pending, absd,
                new_xab, roi_c, sp, anc, lane_c, emig)

    return StepKit(service, march, draw_birth_fp, draw_fp_weighted,
                   lane_const, lane_const_of, do_split, split_max, sw_a)


@partial(jax.jit, static_argnames=("source_kind", "nlanes", "max_iters",
                                   "per_freq_tally", "refill_period",
                                   "esc_bins", "with_ali", "roi_nside",
                                   "mirror_mask", "split_max",
                                   "service_period"),
         donate_argnums=(4, 5))
def transport_run(grid, physics, source_params, total_packets, tabs, intf,
                  seed, source_kind="bg", nlanes=1 << 17,
                  max_iters=1 << 30, per_freq_tally=False, refill_period=16,
                  esc_bins=1, with_ali=False, xab=None, roi_nside=0,
                  roi_tally=None, mirror_mask=0, split_max=0,
                  service_period=None):
    """Drain ``total_packets`` packets through the grid with lane refill.

    physics : dict with
        'kabs', 'ksca' : scalar () or [NFREQ] cross sections / density / GL
        'csc'          : [BINS] or [NFREQ, BINS] inverse-CDF table
        'tw'           : scalar or [NFREQ] frequency integration weight
        optionally 'opt_abs'/'opt_sca' : [CELLS] per-cell cross sections
        (variable-abundance WITH_ABU mode; uniform-frequency runs only)
    source_params : pytree for the generator (see transport.sources
        packet_identity); contains either 'ifreq' (uniform-frequency mode,
        enables the scalar-cross-section fast path) or 'per_freq'+'ifreq0',
        plus optional 'k0' / 'hi_base' stream-identity origins
    tabs : [CELLS] integrated tally (donated)
    intf : [CELLS, NFREQ] or [1, 1] per-frequency tally (donated)

    Returns (tabs, intf, escaped[esc_bins], absorbed_scalar[, xab]) --
    photon-count balances for conservation accounting (escaped is
    per-frequency when esc_bins == NFREQ in mixed-frequency mode).
    with_ali=True additionally routes absorption deposits landing in a
    packet's own emitting cell into the xab tally (accelerated lambda
    iteration escape-probability accounting, kernel_ASOC.c:1487-1496);
    xab must then be a [CELLS] array (donation not applied).

    roi_nside > 0 enables WITH_ROI_SAVE: packets crossing into the ROI box
    (physics['roi_mask'] per-cell flags, physics['roi_box'] root-cell
    limits, physics['roi_dim'] (rnx,rny,rnz,step)) are histogrammed into
    roi_tally [NELEM * 12 * nside^2] (kernel_ASOC.c:617-660).

    split_max > 0 enables in-flight packet splitting at octree refinement
    boundaries -- the fixed-shape equivalent of the reference's
    SimBgSplit/SimHpSplit ray stacks (kernel_ASOC.c:2121-3554). A packet
    crossing into a FINER level halves its weight and posts a clone
    request (its post-crossing state) that the lane-refill step serves
    into dead lanes before drawing fresh source packets. Like the
    reference's sub-rays (spawned across the leading face of the entered
    octet, kernel_ASOC.c:3263-3360), the clone re-samples its entry point
    uniformly over that face -- the beam interpretation that lets the
    refined sub-structure be sampled below the parent packet density; the
    parent keeps its exact position, so the pair samples both the true
    point and the face average. The clone gets a fresh stream from a
    dedicated id space and a fresh free path (valid: the remaining
    exponential path is memoryless; splitting is therefore disabled when
    STEP_WEIGHT stretching is on). A packet splits at most split_max
    times.
    """
    from .sources import GENERATORS
    gen = GENERATORS[source_kind]
    if service_period is None:
        import os
        service_period = int(os.environ.get("SOC_TPU_SERVICE_PERIOD", "16"))
    service_period = min(service_period, refill_period)
    if refill_period % service_period:
        raise ValueError("service_period must divide refill_period")
    seed = jnp.uint32(seed)
    kit = make_step_fns(grid, physics, seed,
                        per_freq_tally=per_freq_tally, esc_bins=esc_bins,
                        with_ali=with_ali, roi_nside=roi_nside,
                        mirror_mask=mirror_mask, split_max=split_max)
    do_split = kit.do_split
    sw_a = kit.sw_a

    def cond(state):
        it = state[0]
        b = state[1]
        next_id = state[5]
        active = jnp.any(b.ind >= 0) | (next_id < total_packets)
        if do_split:
            active = active | jnp.any(state[13]["pending"])
        return (it < max_iters) & active

    def body(state):
        (it, b, pending, free_path, tau, next_id, tabs, intf, esc,
         esc_pending, absd, xab_c, roi_c, sp, anc) = state

        # ---- flush per-lane escaped weight of dead lanes into the
        # per-frequency bins (one-hot reduction: no scatter serialization)
        dead = b.ind < 0
        flush = jnp.where(dead, esc_pending, 0.0)
        if esc_bins == 1:
            esc = esc + jnp.sum(flush)[None]
        else:
            onehot = (b.ifreq[:, None]
                      == jnp.arange(esc_bins, dtype=jnp.int32)[None, :])
            esc = esc + jnp.einsum("n,nk->k", flush,
                                   onehot.astype(jnp.float32),
                                   precision=lax.Precision.HIGHEST)
        esc_pending = jnp.where(dead, 0.0, esc_pending)

        # ---- serve pending split-clone requests into dead lanes first
        if do_split:
            b, pending, free_path, tau, sp, dead, anc = serve_clones(
                seed, b, pending, free_path, tau, sp, dead, anc)

        # ---- refill dead lanes from the remaining packet budget
        deadi = dead.astype(jnp.int32)
        rank = jnp.cumsum(deadi) - deadi              # exclusive prefix sum
        new_id = next_id + rank
        can = dead & (new_id < total_packets)
        ids_local = jnp.where(can, new_id, 0)
        nb = gen(grid, ids_local, seed, source_params)
        canl = can[..., None]
        b = PacketBatch(
            pos=jnp.where(canl, nb.pos, b.pos),
            dir=jnp.where(canl, nb.dir, b.dir),
            level=jnp.where(can, nb.level, b.level),
            ind=jnp.where(can, nb.ind, b.ind),
            photons=jnp.where(can, nb.photons, b.photons),
            ifreq=jnp.where(can, nb.ifreq, b.ifreq),
            stream=jnp.where(can, nb.stream, b.stream),
            hi=jnp.where(can, nb.hi, b.hi),
            counter=jnp.where(can, nb.counter, b.counter),
            scatterings=jnp.where(can, 0, b.scatterings),
            e_cell=jnp.where(can, nb.e_cell, b.e_cell))
        fp_new, w_new = kit.draw_birth_fp(nb.stream, nb.hi)
        free_path = jnp.where(can, fp_new, free_path)
        pending = pending & ~can
        if do_split:
            sp = {**sp, "lane_depth": jnp.where(can, 0, sp["lane_depth"]),
                  "lane_path": jnp.where(can, jnp.uint32(0),
                                         sp["lane_path"])}
        if sw_a is not None:
            b = PacketBatch(pos=b.pos, dir=b.dir, level=b.level, ind=b.ind,
                            photons=jnp.where(can, b.photons * w_new,
                                              b.photons),
                            ifreq=b.ifreq, stream=b.stream, hi=b.hi,
                            counter=b.counter, scatterings=b.scatterings,
                            e_cell=b.e_cell)
        tau = jnp.where(can, 0.0, tau)
        next_id = next_id + jnp.sum(can.astype(jnp.int32))

        # ---- ancestor stack for the PAR-free up-walk in the march steps:
        # refilled lanes get theirs from the generator (whose leaf walk
        # records it for free); the march and serve_clones maintain it
        # incrementally in between -- NO PAR gathers in the refill body
        if grid.levels > 1:
            anc = jnp.where(can[:, None], nb.anc, anc)

        # ---- per-lane physics constants, refreshed once per refill body
        # (amortized over the refill_period inner steps)
        lane_c = kit.lane_const_of(b)

        # ---- refill_period physics steps between refills (amortizes the
        # generator cost; lanes that die mid-block idle until the next
        # refill). Each sub-block first services pending scatter events,
        # then runs service_period cheap march steps.
        def phys(_, st):
            return kit.march(*st)

        st = (b, pending, free_path, tau, tabs, intf, esc_pending, absd,
              xab_c, roi_c, sp, anc, lane_c, None)
        for _ in range(max(1, refill_period // service_period)):
            st = kit.service(*st)
            st = lax.fori_loop(0, service_period, phys, st)
        (b, pending, free_path, tau, tabs, intf, esc_pending, absd, xab_c,
         roi_c, sp, anc, lane_c, _) = st
        return (it + 1, b, pending, free_path, tau, next_id, tabs, intf,
                esc, esc_pending, absd, xab_c, roi_c, sp, anc)

    if xab is None:
        xab = jnp.zeros(1, jnp.float32)
    if roi_tally is None:
        roi_tally = jnp.zeros(1, jnp.float32)
    b0 = make_dead(nlanes)
    sp0 = init_split_state(nlanes, grid.levels) if do_split else {}
    state = (jnp.int32(0), b0, jnp.zeros(nlanes, bool),
             jnp.zeros(nlanes, jnp.float32),
             jnp.zeros(nlanes, jnp.float32), jnp.int32(0), tabs, intf,
             jnp.zeros(esc_bins, jnp.float32),
             jnp.zeros(nlanes, jnp.float32), jnp.float32(0.0), xab,
             roi_tally, sp0,
             jnp.zeros((nlanes, max(grid.levels - 1, 1)), jnp.int32))
    state = lax.while_loop(cond, body, state)
    (_, b, _, _, _, _, tabs, intf, esc, esc_pending, absd, xab,
     roi_tally, sp_out, _) = state
    # final flush: lanes that died in the last block
    if esc_bins == 1:
        esc = esc + jnp.sum(esc_pending)[None]
    else:
        onehot = (b.ifreq[:, None]
                  == jnp.arange(esc_bins, dtype=jnp.int32)[None, :])
        esc = esc + jnp.einsum("n,nk->k", esc_pending,
                               onehot.astype(jnp.float32),
                               precision=lax.Precision.HIGHEST)
    extras = []
    if with_ali:
        extras.append(xab)
    if roi_nside > 0:
        extras.append(roi_tally)
    if do_split:
        extras.append(sp_out["clones"])
    if extras:
        return (tabs, intf, esc, absd, *extras)
    return tabs, intf, esc, absd
