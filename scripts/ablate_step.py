#!/usr/bin/env python
"""Ablation microbenchmark of the transport step loop on the device.

Replicates the structure of transport.propagate.transport_run's hot path
(mixed-frequency pool: flush + refill + refill_period physics steps) with a
FIXED iteration count and an infinite packet budget, so every ablation runs
the identical loop shape and the time difference attributes the cost of the
ablated component.

Usage:  python scripts/ablate_step.py [variant ...]
        (no args = all variants)
"""

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax

from soc_tpu.constants import ADHOC, MAX_SCATTERINGS, PEPS, PHOTON_LIMIT, TAULIM
from soc_tpu.ops import traverse
from soc_tpu.transport.propagate import _csc_lookup, _deflect
from soc_tpu.transport.sources import GENERATORS, stream_hi_base
from soc_tpu import rng as socrng

LANES = int(os.environ.get("ABLATE_LANES", 1 << 14))
ITERS = int(os.environ.get("ABLATE_ITERS", 150))
REFILL = int(os.environ.get("ABLATE_REFILL", 8))
NFREQ = 44


def load_workload(workdir=None):
    """(grid, medium) of the generated 64^3 example (soc_tpu.io.example),
    written to workdir (default: a temporary directory)."""
    import tempfile
    from soc_tpu.io.cloud import read_cloud
    from soc_tpu.io.dust import read_simple_dust, read_scattering_function
    from soc_tpu.io.example import write_example
    from soc_tpu.transport.medium import medium_from_optics
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="soc_ablate.")
    write_example(workdir)
    grid = read_cloud(os.path.join(workdir, "tmp.cloud"), 1.0e3, 30)
    optics = [read_simple_dust(os.path.join(workdir, "tmp.dust"), 0.01)]
    freq = optics[0].freq
    dsc, csc = read_scattering_function(os.path.join(workdir, "tmp.dsc"),
                                        len(freq), 2500)
    medium = medium_from_optics(optics, dsc, csc, freq)
    return grid, medium


@partial(jax.jit, static_argnames=("variant", "nlanes", "iters"))
def ablate_run(grid, physics, bg_photons, seed, variant="full",
               nlanes=LANES, iters=ITERS):
    gen = GENERATORS["bg"]
    csc = physics["csc"]
    bins = csc.shape[-1]
    csc_flat = csc.reshape(-1)
    kabs_t, ksca_t, tw_t = physics["kabs"], physics["ksca"], physics["tw"]
    cells = grid.cells
    esc_bins = NFREQ
    seed = jnp.uint32(seed)
    total_packets = jnp.int32(2**31 - 1)
    hi_base = jnp.uint32(stream_hi_base("bg"))
    source_params = dict(photons=jnp.float32(1.0), ifreq=jnp.int32(0),
                         per_freq=jnp.int32(1 << 20), hi_base=hi_base)
    opt_const = variant in ("opt_optconst", "opt_all", "opt_all_matmul",
                            "opt_cscbf16", "opt_fusegather")
    opt_cflat = variant in ("opt_cscflat", "opt_all", "opt_all_matmul",
                            "opt_cscbf16")
    if variant == "opt_cscbf16":
        csc_flat = csc_flat.astype(jnp.bfloat16)
    # fused gather: one concatenated table [dens | csc_flat]; per-step the
    # dens index and the csc index go through ONE gather of 2N elements
    fuse_tab = jnp.concatenate([grid.dens, csc_flat]) \
        if variant == "opt_fusegather" else None
    opt_matmul = variant in ("opt_matmul_tally", "opt_all_matmul")
    # two-level decomposition of the cell index for the matmul tally
    TLO = 512
    thi = (cells + TLO - 1) // TLO

    def step(b_pos, b_dir, b_level, b_ind, b_photons, b_ifreq, b_stream,
             b_hi, b_counter, b_scat, b_kabs, b_ksca, b_tw, b_coff,
             free_path, tau, tabs, esc_pending, absd):
        alive = b_ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(b_level, 0, grid.levels - 1)]
                        + jnp.maximum(b_ind, 0), 0, cells - 1)
        if variant == "no_densgather":
            dens = jnp.full(nlanes, 1000.0, jnp.float32)
        elif variant == "opt_fusegather":
            dens = None                      # gathered jointly below
        else:
            dens = grid.dens[gidx]
        if variant == "no_gatherk":
            kabs = kabs_t[20]
            ksca = ksca_t[20]
            tw = tw_t[20]
        elif opt_const:
            kabs, ksca, tw = b_kabs, b_ksca, b_tw
        else:
            kabs = kabs_t[b_ifreq]
            ksca = ksca_t[b_ifreq]
            tw = tw_t[b_ifreq]

        cos_fused = None
        if variant == "opt_fusegather":
            # RNG is independent of the geometry -- draw early so the
            # dens and csc lookups land in ONE gather of 2N indices
            uf_fp, uf_bin, uf_phi = socrng.step_uniforms(
                seed, b_stream, b_counter, b_hi)
            f_bin = jnp.clip((uf_bin * bins).astype(jnp.int32), 0,
                             bins - 1)
            idx2 = jnp.concatenate([gidx, cells + b_coff + f_bin])
            g2 = fuse_tab[idx2]
            dens = g2[:nlanes]
            cos_fused = g2[nlanes:]

        ds_local, pos_boundary = traverse.boundary_step(b_pos, b_dir)
        ds_gl = ds_local * jnp.exp2(-b_level.astype(jnp.float32))
        tau_abs_full = ds_gl * dens * kabs
        dtau_sca = ds_gl * dens * ksca
        scatter_now = alive & (free_path < tau + dtau_sca)
        dx_gl = (free_path - tau) / jnp.maximum(ksca * dens, 1e-30)
        tau_abs_part = dx_gl * dens * kabs
        dx_local = jnp.maximum(
            0.0, dx_gl * jnp.exp2(b_level.astype(jnp.float32)) - 2.0 * PEPS)
        pos_scatter = b_pos + dx_local[..., None] * b_dir

        tau_abs = jnp.where(scatter_now, tau_abs_part, tau_abs_full)
        att = jnp.exp(-tau_abs)
        delta = jnp.where(tau_abs > TAULIM,
                          b_photons * (1.0 - att),
                          b_photons * tau_abs * (1.0 - 0.5 * tau_abs))
        if opt_matmul:
            # two-level one-hot deposit as a bf16 matmul: tabs [THI, TLO]
            dep = jnp.where(alive, delta * tw * ADHOC, 0.0)
            hi_i = (gidx // TLO).astype(jnp.int32)
            lo_i = (gidx % TLO).astype(jnp.int32)
            oh_hi = (hi_i[:, None] == jnp.arange(thi, dtype=jnp.int32)
                     [None, :])
            oh_lo = (lo_i[:, None] == jnp.arange(TLO, dtype=jnp.int32)
                     [None, :]).astype(jnp.bfloat16)
            lhs = jnp.where(oh_hi, dep[:, None], 0.0).astype(jnp.bfloat16)
            tabs = tabs + jax.lax.dot_general(
                lhs, oh_lo, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        elif variant != "no_tally":
            didx = jnp.where(alive, gidx, cells)
            tabs = tabs.at[didx].add(delta * tw * ADHOC, mode="drop")
        absd = absd + jnp.sum(jnp.where(alive, delta, 0.0))
        photons = jnp.where(alive, b_photons * att, b_photons)

        if variant == "opt_fusegather":
            u_fp, u_bin, u_phi = uf_fp, uf_bin, uf_phi
        elif variant == "bound":
            # stepping bound: no scatter sampling at all -- packets march,
            # deposit, attenuate; free_path never ends (physics floor)
            u_fp = jnp.full(nlanes, 0.5, jnp.float32)
            u_bin = u_fp
            u_phi = u_fp
        elif variant == "no_rng":
            # one 32-bit multiply hash instead of 13-round threefry
            h = (b_stream ^ b_counter) * jnp.uint32(2654435761)
            u_fp = (h >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
            u_bin = (h >> jnp.uint32(16)).astype(jnp.float32) * (1.0 / (1 << 16))
            u_phi = (h & jnp.uint32(0xFFFF)).astype(jnp.float32) * (1.0 / (1 << 16))
            u_fp = jnp.maximum(u_fp, 1e-7)
        else:
            u_fp, u_bin, u_phi = socrng.step_uniforms(
                seed, b_stream, b_counter, b_hi)
        if variant == "opt_fusegather":
            cos_theta = cos_fused
        elif variant == "bound":
            cos_theta = jnp.full(nlanes, 0.5, jnp.float32)
        elif variant == "no_csc":
            cos_theta = jnp.full(nlanes, 0.5, jnp.float32)
        elif opt_cflat:
            bin_idx = jnp.clip((u_bin * bins).astype(jnp.int32), 0,
                               bins - 1)
            cos_theta = csc_flat[b_coff + bin_idx]
        else:
            cos_theta = _csc_lookup(csc, b_ifreq, u_bin, bins)
        if variant in ("no_deflect", "bound"):
            new_dir = b_dir
        else:
            new_dir = _deflect(b_dir, cos_theta, (2.0 * jnp.pi) * u_phi)

        posx = jnp.where(alive[..., None], pos_boundary, b_pos)
        cross = alive & ~scatter_now
        npos, nlevel, nind = traverse.index_update(
            grid, posx, b_level, b_ind, cross)
        failed = cross & (nlevel == b_level) & (nind == b_ind)
        npos = jnp.where(failed[..., None], npos + PEPS * b_dir, npos)

        pos = jnp.where(scatter_now[..., None], pos_scatter, npos)
        level = jnp.where(scatter_now, b_level, nlevel)
        ind = jnp.where(scatter_now, b_ind, nind)
        dir = jnp.where(scatter_now[..., None], new_dir, b_dir)
        scat = b_scat + scatter_now.astype(jnp.int32)
        overscattered = scatter_now & (scat > MAX_SCATTERINGS)
        exhausted = alive & (photons < PHOTON_LIMIT)
        exited = cross & (nind < 0)
        esc_pending = esc_pending + jnp.where(
            (exited | overscattered) & alive, photons, 0.0)
        ind = jnp.where(overscattered | exhausted, jnp.int32(-1), ind)
        free_path = jnp.where(scatter_now, -jnp.log(u_fp), free_path)
        tau = jnp.where(scatter_now, 0.0,
                        jnp.where(cross, tau + dtau_sca, tau))
        return (pos, dir, level, ind, photons, b_ifreq, b_stream, b_hi,
                b_counter + jnp.uint32(1), scat, b_kabs, b_ksca, b_tw,
                b_coff, free_path, tau, tabs, esc_pending, absd)

    def body(state):
        (it, pos, dir, level, ind, photons, ifreq, stream, hi, counter,
         scat, kabs_l, ksca_l, tw_l, coff_l, free_path, tau, next_id, tabs,
         esc, esc_pending, absd) = state

        dead = ind < 0
        if variant != "no_escflush":
            flush = jnp.where(dead, esc_pending, 0.0)
            onehot = (ifreq[:, None]
                      == jnp.arange(esc_bins, dtype=jnp.int32)[None, :])
            esc = esc + jnp.einsum("n,nk->k", flush,
                                   onehot.astype(jnp.float32))
            esc_pending = jnp.where(dead, 0.0, esc_pending)

        if variant != "no_refill":
            deadi = dead.astype(jnp.int32)
            rank = jnp.cumsum(deadi) - deadi
            new_id = next_id + rank
            can = dead & (new_id < total_packets)
            ids_local = jnp.where(can, new_id, 0)
            nb = gen(grid, ids_local, seed, source_params)
            canl = can[..., None]
            pos = jnp.where(canl, nb.pos, pos)
            dir = jnp.where(canl, nb.dir, dir)
            level = jnp.where(can, nb.level, level)
            ind = jnp.where(can, nb.ind, ind)
            photons = jnp.where(can, nb.photons, photons)
            # tag round-robin frequencies to exercise the per-lane gathers
            ifreq = jnp.where(can, (nb.stream % NFREQ).astype(jnp.int32),
                              ifreq)
            if opt_const:
                kabs_l = jnp.where(can, kabs_t[ifreq], kabs_l)
                ksca_l = jnp.where(can, ksca_t[ifreq], ksca_l)
                tw_l = jnp.where(can, tw_t[ifreq], tw_l)
            if opt_cflat:
                coff_l = jnp.where(can, ifreq * bins, coff_l)
            stream = jnp.where(can, nb.stream, stream)
            hi = jnp.where(can, nb.hi, hi)
            counter = jnp.where(can, nb.counter, counter)
            scat = jnp.where(can, 0, scat)
            u = socrng.uniform1(seed, nb.stream,
                                jnp.full_like(nb.stream, 2), nb.hi)
            free_path = jnp.where(can, -jnp.log(u), free_path)
            tau = jnp.where(can, 0.0, tau)
            next_id = next_id + jnp.sum(can.astype(jnp.int32))

        st = (pos, dir, level, ind, photons, ifreq, stream, hi, counter,
              scat, kabs_l, ksca_l, tw_l, coff_l, free_path, tau, tabs,
              esc_pending, absd)
        st = lax.fori_loop(0, REFILL, lambda _, s: step(*s), st)
        (pos, dir, level, ind, photons, ifreq, stream, hi, counter, scat,
         kabs_l, ksca_l, tw_l, coff_l, free_path, tau, tabs, esc_pending,
         absd) = st
        return (it + 1, pos, dir, level, ind, photons, ifreq, stream, hi,
                counter, scat, kabs_l, ksca_l, tw_l, coff_l, free_path,
                tau, next_id, tabs, esc, esc_pending, absd)

    n = nlanes
    state = (jnp.int32(0),
             jnp.zeros((n, 3), jnp.float32),
             jnp.full((n, 3), 1.0 / np.sqrt(3.0), jnp.float32),
             jnp.zeros(n, jnp.int32),
             jnp.full(n, -1, jnp.int32),
             jnp.zeros(n, jnp.float32),
             jnp.zeros(n, jnp.int32),
             jnp.zeros(n, jnp.uint32),
             jnp.zeros(n, jnp.uint32),
             jnp.zeros(n, jnp.uint32),
             jnp.zeros(n, jnp.int32),
             jnp.ones(n, jnp.float32),        # kabs_l
             jnp.ones(n, jnp.float32),        # ksca_l
             jnp.ones(n, jnp.float32),        # tw_l
             jnp.zeros(n, jnp.int32),         # coff_l
             jnp.zeros(n, jnp.float32),
             jnp.zeros(n, jnp.float32),
             jnp.int32(0),
             (jnp.zeros((thi, TLO), jnp.float32) if opt_matmul
              else jnp.zeros(cells, jnp.float32)),
             jnp.zeros(esc_bins, jnp.float32),
             jnp.zeros(n, jnp.float32),
             jnp.float32(0.0))
    state = lax.while_loop(lambda s: s[0] < iters, body, state)
    tabs = state[18]
    if opt_matmul:
        tabs = tabs.reshape(-1)[:cells]
    return tabs, state[17]     # tabs, packets started


VARIANTS = ["full", "bound", "no_tally", "no_escflush", "no_rng", "no_csc",
            "no_deflect", "no_gatherk", "no_densgather", "no_refill",
            "opt_optconst", "opt_cscflat", "opt_matmul_tally", "opt_all",
            "opt_all_matmul", "opt_cscbf16", "opt_fusegather"]


def main():
    from soc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    grid, medium = load_workload()
    physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
                   tw=medium.tw)
    variants = sys.argv[1:] or VARIANTS
    lane_steps = ITERS * REFILL * LANES
    results = {}
    for v in variants:
        t0 = time.time()
        tabs, nid = ablate_run(grid, physics, jnp.float32(1.0), 7, variant=v)
        tabs.block_until_ready()
        compile_s = time.time() - t0
        best = None
        for _ in range(3):
            t0 = time.time()
            tabs, nid = ablate_run(grid, physics, jnp.float32(1.0), 7,
                                   variant=v)
            tabs.block_until_ready()
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        rate = lane_steps / best
        results[v] = (best, rate)
        print(f"{v:14s}  {best*1e3:8.1f} ms   {rate/1e6:8.1f} M lane-steps/s"
              f"   {int(nid)/best/1e3:7.1f} k pkt/s"
              f"   (compile {compile_s:.0f}s, started {int(nid)} pkts)",
              flush=True)
    if "full" in results:
        base = results["full"][0]
        print("\n--- attribution (time saved vs full) ---")
        for v, (t, _) in results.items():
            if v != "full":
                print(f"{v:14s}  {100.0 * (base - t) / base:6.1f} %")


if __name__ == "__main__":
    main()
