"""End-to-end emission radiative-transfer pipeline (the ASOC.py equivalent).

Phases (call stack mirrors SURVEY.md section 3.1, but as in-process function
calls over device arrays instead of kernel launches + host staging):
  1. constant sources: background + point sources, all frequencies batched
     into mixed-frequency packet chunks -> CTABS (+ per-frequency FABSORBED)
  2. iterations: dust re-emission packets (when cellpackets > 0), equilibrium
     temperature solve, thermal emission
  3. maps: frequency-fused orthographic LOS integration -> map_dir_XX.bin

Outputs keep the reference's binary formats so downstream tooling
(plot_results.py etc.) works unchanged.
"""

import os
import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..config import RunConfig
from ..constants import FACTOR, PARSEC, PLANCK
from ..grid import Grid
from ..io.cloud import read_cloud, write_cell_field
from ..io.dust import read_simple_dust, read_scattering_function
from ..io.fields import (read_background_intensity,
                         write_cell_frequency_array, write_map_file)
from ..solve import equilibrium
from ..transport.medium import medium_from_optics
from ..transport.propagate import transport_run
from ..render import mapping as render_mapping
from ..utils.cache import enable_compile_cache

DEFAULT_LANES = 1 << 17


@dataclass
class RunResult:
    grid: Grid = None
    freq: np.ndarray = None
    ctabs: np.ndarray = None            # integrated constant-source heating
    absorbed: np.ndarray = None         # [CELLS, NFREQ] (file scaling applied)
    temperature: np.ndarray = None      # [CELLS]
    emitted: np.ndarray = None          # [CELLS, NFREQ]
    maps: dict = field(default_factory=dict)       # idir -> [NF, NY, NX]
    tau_maps: dict = field(default_factory=dict)
    escaped: np.ndarray = None          # [NFREQ] photons that left the volume
    injected: np.ndarray = None         # [NFREQ] photons injected
    timings: dict = field(default_factory=dict)


def _pool_lanes(nlanes, per_freq):
    """Lane-pool size: at most the per-frequency budget, power-of-two,
    >= 1024 (static per run, so one compile covers all frequencies)."""
    n = min(nlanes, max(1024, per_freq))
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


def _run_over_freqs(grid, medium, kind, make_params, per_freq, tabs, intf,
                    seed, nlanes, per_freq_tally, phase=None, iteration=0,
                    mirror_mask=0, freq_mask=None, roi=None,
                    physics_extra=None, split_max=0, ckpt=None,
                    ckpt_key="", host_tally=None, ckpt_slot="tabs",
                    pool_cap=None):
    """Run one transport pass per frequency (uniform-frequency fast path:
    scalar cross sections, [BINS] CSC row -- all frequencies share one
    compiled executable).

    per_freq : packets per frequency -- an int, or a callable
        per_freq(ifreq) for allocation-dependent budgets (EMWEI); pass
        pool_cap (a static bound over all frequencies) alongside a
        callable so every frequency still hits ONE compiled executable.
    freq_mask : optional bool[NFREQ]; masked-out frequencies are skipped
        entirely (the reference's `simum` band / libabs FSELECT loops,
        ASOC.py:1126-1131).
    roi : optional dict(nside, mask, box, dim, tally[NFREQ, NELEM*NPIX]) --
        WITH_ROI_SAVE crossing histograms, updated in place per frequency.
    """
    import sys
    from ..transport.sources import stream_hi_base
    progress = os.environ.get("SOC_TPU_PROGRESS", "0") != "0"
    intf_dummy = intf
    nfreq = medium.nfreq
    hi_base = stream_hi_base(phase or kind, iteration)
    esc_list = [0.0] * nfreq
    abs_list = [0.0] * nfreq
    t_loop = time.time()
    for ifreq in range(nfreq):
        if freq_mask is not None and not bool(freq_mask[ifreq]):
            continue
        if ckpt is not None and ckpt.completed("%s/f%d" % (ckpt_key, ifreq)):
            esc_list[ifreq] = ckpt.esc_of("%s/f%d" % (ckpt_key, ifreq))
            continue
        if progress:
            print("  [%s] freq %d/%d  t=%.1fs" %
                  (kind, ifreq + 1, nfreq, time.time() - t_loop),
                  file=sys.stderr, flush=True)
        pf = int(per_freq(ifreq)) if callable(per_freq) else per_freq
        if pf <= 0:
            continue
        physics = dict(kabs=medium.abs_gl[ifreq], ksca=medium.sca_gl[ifreq],
                       csc=medium.csc[ifreq], tw=medium.tw[ifreq])
        if physics_extra is not None:
            physics.update(physics_extra(ifreq))
        params = make_params(ifreq)
        if host_tally is not None:
            # out-of-core tally (mmapabs): the device holds one [CELLS]
            # column; identity stays hi = hi_base + channel via the base
            # shift while the tally column index is 0
            params["ifreq"] = jnp.int32(0)
            params["hi_base"] = jnp.uint32(int(hi_base) + ifreq)
            intf = jnp.zeros((grid.cells, 1) + host_tally.shape[2:],
                             jnp.float32)
        else:
            params["ifreq"] = jnp.int32(ifreq)
            params["hi_base"] = jnp.uint32(hi_base)
        if "per_freq" not in params:
            params["per_freq"] = jnp.int32(pf)
        kwargs = {}
        if roi is not None:
            physics["roi_mask"] = roi["mask"]
            physics["roi_box"] = roi["box"]
            physics["roi_dim"] = roi["dim"]
            kwargs = dict(roi_nside=roi["nside"],
                          roi_tally=jnp.asarray(roi["tally"][ifreq]))
        out = transport_run(
            grid, physics, params, jnp.int32(pf), tabs, intf, seed,
            source_kind=kind,
            nlanes=_pool_lanes(nlanes,
                               pf if pool_cap is None else pool_cap),
            per_freq_tally=per_freq_tally,
            mirror_mask=mirror_mask, split_max=split_max, **kwargs)
        # extras appended in transport_run order: [xab] [roi_tally] [clones]
        tabs, intf, esc, absd = out[:4]
        rest = list(out[4:])
        if roi is not None:
            roi["tally"][ifreq] = np.asarray(rest.pop(0))
        esc_list[ifreq] = float(esc[0])
        abs_list[ifreq] = float(absd)
        if host_tally is not None:
            host_tally[:, ifreq] += np.asarray(intf)[:, 0]
            intf = intf_dummy          # restore the caller's carry
        if ckpt is not None:
            slots = {ckpt_slot: tabs,
                     "intf": intf if host_tally is None else host_tally}
            ckpt.record("%s/f%d" % (ckpt_key, ifreq), esc_list[ifreq],
                        roi=None if roi is None else roi["tally"], **slots)
    return tabs, intf, np.asarray(esc_list), np.asarray(abs_list)


def simulate_background(grid, medium, cfg, ibg, tabs, intf, seed,
                        lanes=DEFAULT_LANES, per_freq_tally=False,
                        mixed=True, chunk=4 << 20, freq_mask=None, roi=None,
                        physics_extra=None, ckpt=None, domain=None,
                        pmesh=None, host_tally=None):
    """Phase-1 isotropic background over all frequencies.

    Packet budget: the reference sends 8*AREA*BATCH packets per frequency
    (ASOC.py:1060-1063); we keep that exact normalization so tallies match.

    mixed=True runs one pool over ALL frequencies (packets tagged by
    channel): the drain tail is paid once instead of NFREQ times.
    Work is issued in calls of at most `chunk` packets (default 4M).
    Returns (tabs, intf, escaped[NF], injected[NF]).
    """
    area = int(grid.area)
    batch = max(1, int(round(cfg.bgpac / (8.0 * area))))
    per_freq = 8 * area * batch                 # packets per frequency
    wbg = np.pi / (PLANCK * 8.0 * batch)
    bg_photons = (np.asarray(ibg, np.float64) * wbg
                  / np.asarray(cfg.freq, np.float64)).astype(np.float32)

    split_max = split_max_of(cfg, grid)

    injected = np.float64(8 * area * batch) \
        * np.asarray(bg_photons, np.float64)
    if freq_mask is not None:
        injected = np.where(freq_mask, injected, 0.0)

    if pmesh is not None:
        # `devices N`: (dp x freq)-sharded product path, no exclusions
        from ..parallel import product

        def make_params(ifreq):
            return dict(photons=jnp.float32(bg_photons[ifreq]))

        tabs, intf, escaped, absorbed, _ = product.run_freqs(
            pmesh, grid, medium, "bg", make_params, per_freq, tabs, intf,
            seed, lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
            split_max=split_max, freq_mask=freq_mask, roi=roi,
            physics_extra=physics_extra, ckpt=ckpt, ckpt_key="bg")
        return tabs, intf, escaped, injected

    from ..transport.sources import stream_hi_base
    if domain is not None:
        # `domains N`: Z-slab decomposition, per-frequency uniform pools
        from ..parallel.domain import domain_background_run
        tabs, intf, escaped, _ = _domain_run_source(
            domain_background_run, domain, medium, lanes, freq_mask,
            lambda i: (jnp.float32(bg_photons[i]), per_freq),
            stream_hi_base("bg"), seed, grid, cfg, tabs, intf,
            per_freq_tally, physics_extra=physics_extra, split=True)
        injected = np.float64(per_freq) * np.asarray(bg_photons, np.float64)
        if freq_mask is not None:
            injected = np.where(freq_mask, injected, 0.0)
        return tabs, intf, escaped, injected
    if freq_mask is not None or roi is not None \
            or physics_extra is not None or ckpt is not None \
            or host_tally is not None:
        mixed = False    # mask/ROI/OPT/checkpoint/mmap handling is per-freq
    if mixed:
        nfreq = medium.nfreq
        physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl,
                       csc=medium.csc, tw=medium.tw)
        bg = jnp.asarray(bg_photons)
        total = per_freq * nfreq            # Python int: may exceed 2^31
        nlanes = _pool_lanes(lanes, total if total < (1 << 31) else chunk)
        escaped = jnp.zeros(nfreq, jnp.float32)
        for off in range(0, total, chunk):
            n = min(chunk, total - off)
            # chunk origin split host-side into (frequency, in-freq index):
            # all device id math stays 32-bit no matter how large `total` is
            params = dict(photons=bg, ifreq=None,
                          per_freq=jnp.int32(per_freq),
                          ifreq0=jnp.int32(off // per_freq),
                          k0=jnp.uint32(off % per_freq),
                          hi_base=jnp.uint32(stream_hi_base("bg")))
            out = transport_run(
                grid, physics, params, jnp.int32(n), tabs, intf, seed,
                source_kind="bg", nlanes=nlanes,
                per_freq_tally=per_freq_tally, esc_bins=nfreq,
                mirror_mask=mirror_mask_of(cfg), split_max=split_max)
            tabs, intf, esc, absd = out[:4]     # split adds a clones count
            escaped = escaped + esc
        escaped = np.asarray(escaped)
    else:
        def make_params(ifreq):
            return dict(photons=jnp.float32(bg_photons[ifreq]))

        tabs, intf, escaped, absorbed = _run_over_freqs(
            grid, medium, "bg", make_params, per_freq, tabs, intf, seed,
            lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
            freq_mask=freq_mask, roi=roi, physics_extra=physics_extra,
            split_max=split_max, ckpt=ckpt, ckpt_key="bg",
            host_tally=host_tally)
    # weighted injection total: with splitting the extra packets carry
    # 1/boost weight, so the expectation stays 8*AREA*batch per frequency
    injected = np.float64(8 * area * batch) \
        * np.asarray(bg_photons, np.float64)
    if freq_mask is not None:
        injected = np.where(freq_mask, injected, 0.0)
    return tabs, intf, escaped, injected


def simulate_hpbg(grid, medium, cfg, hpbg, tabs, intf, seed,
                  lanes=DEFAULT_LANES, per_freq_tally=False, weighted=False,
                  freq_mask=None, roi=None, physics_extra=None, ckpt=None,
                  domain=None, pmesh=None, host_tally=None):
    """Phase-1 Healpix-sky background (SimRAM_HP equivalent).

    hpbg : [NFREQ, NPIX] sky intensities; photons per packet =
    (pi*AREA/(PLANCK*BGPAC)) / freq * HPBG[pix] (ASOC.py:1050-1063), with
    optional per-pixel importance weighting (HPBG_WEIGHTED).
    Returns (tabs, intf, escaped[NF], injected[NF]).
    """
    area = grid.area
    per_freq = max(1, int(cfg.bgpac))
    wbg = np.pi * area / (PLANCK * per_freq)
    nfreq = medium.nfreq
    freq = np.asarray(cfg.freq, np.float64)
    injected = np.zeros(nfreq)

    def _channel(ifreq):
        """(params, expected mean injected weight per packet) for one
        channel -- injected is computed here, NOT as a make_params side
        effect, so checkpoint-resumed runs (which skip completed channels
        before building params) still report the full injected energy."""
        vals = np.asarray(hpbg[ifreq], np.float64) * (wbg / freq[ifreq])
        npx = len(vals)
        if weighted:
            p = vals / max(vals.mean(), 1e-300)
            p = np.clip(p, 1e-3, 1e4)
            p /= p.sum()
            w = (1.0 / npx) / p                  # packet weight correction
            cdf = np.cumsum(p)
            cdf[-1] = 1.00001
            return dict(hpbg=jnp.asarray((vals * w).astype(np.float32)),
                        cdf=jnp.asarray(cdf.astype(np.float32))), \
                np.sum(p * (vals * w))
        return dict(hpbg=jnp.asarray(vals.astype(np.float32)),
                    cdf=None), vals.mean()

    for i in range(nfreq):
        if freq_mask is None or bool(freq_mask[i]):
            injected[i] = _channel(i)[1] if weighted else \
                float(np.asarray(hpbg[i], np.float64).mean()
                      * (wbg / freq[i]))

    def make_params(ifreq):
        return _channel(ifreq)[0]

    if pmesh is not None:
        from ..parallel import product
        tabs, intf, escaped, absorbed, _ = product.run_freqs(
            pmesh, grid, medium, "hpbg", make_params, per_freq, tabs, intf,
            seed, lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
            split_max=split_max_of(cfg, grid), freq_mask=freq_mask,
            roi=roi, physics_extra=physics_extra, ckpt=ckpt,
            ckpt_key="hpbg")
        return tabs, intf, escaped, injected * per_freq

    if domain is not None:
        # `domains N`: healpix-sky packets through the generic Z-slab
        # generator runner (entry states are geometry-only)
        from ..parallel.domain import domain_generator_run
        from ..transport.sources import stream_hi_base
        tabs, intf, escaped, _ = _domain_run_source(
            domain_generator_run, domain, medium, lanes, freq_mask,
            lambda i: ("hpbg", make_params(i), per_freq),
            stream_hi_base("hpbg"), seed, grid, cfg, tabs, intf,
            per_freq_tally, physics_extra=physics_extra, split=True)
        return tabs, intf, escaped, injected * per_freq

    tabs, intf, escaped, absorbed = _run_over_freqs(
        grid, medium, "hpbg", make_params, per_freq, tabs, intf, seed,
        lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
        split_max=split_max_of(cfg, grid),
        freq_mask=freq_mask, roi=roi,
        physics_extra=physics_extra, ckpt=ckpt, ckpt_key="hpbg",
        host_tally=host_tally)
    return tabs, intf, escaped, injected * per_freq


def simulate_point_sources(grid, medium, cfg, lps, tabs, intf, seed,
                           lanes=DEFAULT_LANES, per_freq_tally=False,
                           freq_mask=None, roi=None, physics_extra=None,
                           ckpt=None, domain=None, pmesh=None,
                           host_tally=None):
    """Phase-1 point sources (internal positions)."""
    if cfg.no_ps < 1 or cfg.pspac < 1:
        return tabs, intf, np.zeros(medium.nfreq), 0.0
    pspac = max(1, cfg.pspac)
    wps = 1.0 / (PLANCK * pspac * (cfg.gl * PARSEC) ** 2)
    freq = np.asarray(cfg.freq, np.float64)
    ps_photons = (np.asarray(lps, np.float64) * wps
                  / freq[None, :]).astype(np.float32)    # [NO_PS, NFREQ]
    ps_pos = jnp.asarray(np.asarray(cfg.ps_pos, np.float32))
    per_freq = pspac * cfg.no_ps

    extra = {}
    if cfg.ps_method == 2:
        from ..transport.sources import analyse_external_point_sources
        nside, side, area = analyse_external_point_sources(grid, cfg.ps_pos)
        extra = dict(xps_nside=jnp.asarray(nside),
                     xps_side=jnp.asarray(side),
                     xps_area=jnp.asarray(area))
    elif cfg.ps_method == 3:
        from ..transport.sources import healpix_visibility
        bins3, prob3 = healpix_visibility(grid, cfg.ps_pos)
        extra = dict(ps3_pix=jnp.asarray(bins3), ps3_p=jnp.asarray(prob3))
    elif cfg.ps_method in (4, 5):
        from ..transport.sources import illumination_cones
        side, cone = illumination_cones(grid, cfg.ps_pos)
        extra = dict(cone_side=jnp.asarray(side),
                     cone_cos=jnp.asarray(cone))
    elif cfg.ps_method == 1:
        extra = dict(halfspace=jnp.int32(1))

    def make_params(ifreq):
        return dict(ps_pos=ps_pos,
                    photons=jnp.asarray(ps_photons[:, ifreq]), **extra)

    if pmesh is not None:
        from ..parallel import product
        tabs, intf, escaped, absorbed, _ = product.run_freqs(
            pmesh, grid, medium, "ps", make_params, per_freq, tabs, intf,
            seed, lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
            freq_mask=freq_mask, roi=roi, physics_extra=physics_extra,
            ckpt=ckpt, ckpt_key="ps")
        injected = np.sum(np.asarray(ps_photons, np.float64), axis=0) \
            * pspac
        if freq_mask is not None:
            injected = np.where(freq_mask, injected, 0.0)
        return tabs, intf, escaped, injected

    if domain is not None:
        # `domains N`: point-source packets (all PS_METHODs) through the
        # generic Z-slab generator runner
        from ..parallel.domain import domain_generator_run
        from ..transport.sources import stream_hi_base
        tabs, intf, escaped, _ = _domain_run_source(
            domain_generator_run, domain, medium, lanes, freq_mask,
            lambda i: ("ps", make_params(i), per_freq),
            stream_hi_base("ps"), seed, grid, cfg, tabs, intf,
            per_freq_tally, physics_extra=physics_extra)
        injected = np.sum(np.asarray(ps_photons, np.float64), axis=0) \
            * pspac
        if freq_mask is not None:
            injected = np.where(freq_mask, injected, 0.0)
        return tabs, intf, escaped, injected

    tabs, intf, escaped, absorbed = _run_over_freqs(
        grid, medium, "ps", make_params, per_freq, tabs, intf, seed,
        lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
        freq_mask=freq_mask, roi=roi,
        physics_extra=physics_extra, ckpt=ckpt, ckpt_key="ps",
        host_tally=host_tally)
    injected = np.sum(np.asarray(ps_photons, np.float64), axis=0) * pspac
    if freq_mask is not None:
        injected = np.where(freq_mask, injected, 0.0)
    return tabs, intf, escaped, injected


EMWEI2_STEP = 100      # mode-2 packet quantum (ASOC.py:79)


def emweight_allocation(emit_col, clpac, lims=(0.0, 1e10), rng=None,
                        mode=1):
    """Emission-weighted packets-per-cell (EMWEI). Returns (cell_of_id,
    weight[CELLS], total_packets).

    mode 1 (ASOC.py:1276-1298): packets ~ the cell's share of total
    emission, clipped to lims[:2]; cells below one packet survive
    Russian roulette with probability EMWEI and carry weight 1/EMWEI;
    lims[2] > 0 afterwards drops every cell whose (post-roulette) EMWEI
    falls below it (USER.EMWEIGHT_LIM[2], ASOC.py:1770-1772).

    mode 2 (USE_EMWEIGHT==2, ASOC.py:1773-1789): deterministic quotas --
    packets per cell = EMWEI2_STEP * round(share / EMWEI2_STEP) computed
    from the UNclipped share (the reference overwrites the clipped/
    rouletted EMWEI with 1/EMPAC), weight = 1/EMPAC. The reference's
    EMINDEX batching (the kernel simulating EMWEI2_STEP packets per call
    while the host loops) is GPU work-issue bookkeeping; the lane-refill
    pool consumes the same (cell, weight) multiset directly.
    """
    emit_col = np.asarray(emit_col, np.float64)
    cells = len(emit_col)
    raw = clpac * emit_col / max(emit_col.sum(), 1e-32)
    if mode == 2:
        counts = (EMWEI2_STEP
                  * np.round(raw / EMWEI2_STEP)).astype(np.int64)
        counts = np.maximum(counts, 0)
        weight = np.zeros(cells, np.float64)
        m = counts > 0
        weight[m] = 1.0 / counts[m]
        cell_of_id = np.repeat(np.arange(cells, dtype=np.int32), counts)
        return cell_of_id, weight.astype(np.float32), len(cell_of_id)
    wei = np.clip(raw, lims[0], lims[1])
    frac = wei < 1.0
    if rng is None:
        rng = np.random.default_rng(1234)
    survive = frac & (rng.random(cells) < wei)
    eff = np.where(frac, np.where(survive, wei, 0.0), wei)
    if len(lims) > 2 and lims[2] > 0.0:
        eff = np.where(eff < lims[2], 0.0, eff)
    counts = np.where(eff <= 0.0, 0,
                      np.where(eff < 1.0, 1,
                               np.floor(eff).astype(np.int64)))
    weight = np.zeros(cells, np.float64)
    m = counts > 0
    weight[m & (eff >= 1.0)] = 1.0 / counts[m & (eff >= 1.0)]
    weight[m & (eff < 1.0)] = 1.0 / np.maximum(eff[m & (eff < 1.0)], 1e-30)
    cell_of_id = np.repeat(np.arange(cells, dtype=np.int32), counts)
    return cell_of_id, weight.astype(np.float32), len(cell_of_id)


def _emweight_allocs(emitted_np, cfg, rng, nfreq):
    """Per-frequency EMWEI allocations with EMWEIGHT_SKIP reuse.

    The reference recomputes the weights only at every EMWEIGHT_SKIP-th
    frequency of each sweep (skip counter ASOC.py:1643,1750-1752); in
    between, the stale (cell, 1/count) multiset is reused with the
    current frequency's emission column. Allocation is a variance knob,
    not a bias knob: the per-packet photon weight EMIT_f[cell]/count
    keeps the estimator exact whichever column built the counts. All
    three execution paths (single-device, `devices N`, `domains N`) call
    this one helper so their allocations are identical."""
    allocs = {}
    last = None
    skipn = max(1, int(cfg.emweight_skip))
    for i in range(nfreq):
        if last is None or i % skipn == 0:
            last = emweight_allocation(emitted_np[:, i], int(cfg.clpac),
                                       lims=cfg.emweight_lim, rng=rng,
                                       mode=cfg.use_emweight)
        allocs[i] = last
    return allocs


def simulate_cell_emission(grid, medium, cfg, emitted, tabs, intf, seed,
                           lanes=DEFAULT_LANES, per_freq_tally=False,
                           iteration=0, physics_extra=None, domain=None,
                           pmesh=None, host_tally=None, ckpt=None):
    """Phase-2 dust re-emission (SimRAM_CL equivalent).

    emitted : [CELLS, NFREQ] photons/Hz/H per cell. Uniform allocation:
    packets per cell = max(1, CLPAC//CELLS), photon weight =
    EMIT[cell]/packets_per_cell. With cfg.use_emweight > 0 the per-cell
    packet count follows the cell's share of total emission (Russian
    roulette below one packet).
    """
    from ..transport.sources import stream_hi_base
    emitted_np = None          # host copy only when a path needs it
    if cfg.use_emweight > 0 or domain is not None:
        emitted_np = np.asarray(emitted)
    emitted = jnp.asarray(emitted)
    hi_base = stream_hi_base("cell", iteration)

    if pmesh is not None:
        # `devices N`: sharded re-emission, all allocation modes (uniform,
        # EMWEI + roulette, ALI self-absorption accounting)
        from ..parallel import product
        if cfg.use_emweight > 0:
            # the roulette RNG is consumed in ascending channel order, so
            # the allocations are IDENTICAL to the single-device run's
            rng = np.random.Generator(np.random.Philox(
                key=np.uint64([int(seed) & 0xFFFFFFFF, iteration])))
            allocs = _emweight_allocs(emitted_np, cfg, rng, medium.nfreq)
            pad = _pool_lanes(1 << 30,
                              max(1, *(a[2] for a in allocs.values())))

            def make_params(ifreq):
                cell_of_id, weight, total = allocs[ifreq]
                com = np.full(pad, grid.cells - 1, np.int32)
                com[:total] = cell_of_id
                return dict(emit=emitted[:, ifreq] * jnp.asarray(weight),
                            cell_of_id=jnp.asarray(com))

            tabs, intf, escaped, _, _ = product.run_freqs(
                pmesh, grid, medium, "cell", make_params,
                lambda i: allocs[i][2], tabs, intf, seed, lanes,
                per_freq_tally, iteration=iteration,
                mirror_mask=mirror_mask_of(cfg),
                physics_extra=physics_extra)
            return tabs, intf, escaped, None
        per_cell = max(1, int(cfg.clpac) // grid.cells)
        per_freq = per_cell * grid.cells

        def make_params(ifreq):
            return dict(emit=emitted[:, ifreq] / np.float32(per_cell),
                        per_cell=jnp.int32(per_cell))

        tabs, intf, escaped, _, xab = product.run_freqs(
            pmesh, grid, medium, "cell", make_params, per_freq, tabs,
            intf, seed, lanes, per_freq_tally, iteration=iteration,
            mirror_mask=mirror_mask_of(cfg), physics_extra=physics_extra,
            with_ali=bool(cfg.with_ali))
        return tabs, intf, escaped, \
            (np.asarray(xab) if cfg.with_ali else None)

    if domain is not None:
        # `domains N`: per-slab cell ownership + halo exchange; uniform
        # and EMWEI allocations, with ALI self-absorption when requested
        from ..parallel.domain import domain_cell_emission_run
        if cfg.use_emweight > 0:
            rng = np.random.Generator(np.random.Philox(
                key=np.uint64([int(seed) & 0xFFFFFFFF, iteration])))
            allocs = _emweight_allocs(emitted_np, cfg, rng, medium.nfreq)
            # static id->cell map shape so every channel hits ONE cached
            # executable (ids beyond the realized total are never drawn)
            pad = _pool_lanes(1 << 30,
                              max(1, *(a[2] for a in allocs.values())))

            def src_of_freq(i):
                cell_of_id, weight, total = allocs[i]
                if total == 0:
                    return None
                return (emitted_np[:, i] * weight, 1)

            def src_kw(i):
                com = np.full(pad, grid.cells - 1, np.int32)
                com[:allocs[i][2]] = allocs[i][0]
                return dict(cell_of_id=com, total_packets=allocs[i][2])
        else:
            per_cell = max(1, int(cfg.clpac) // grid.cells)

            def src_of_freq(i):
                return (emitted_np[:, i] / np.float32(per_cell), per_cell)

            src_kw = None
        tabs, intf, escaped, xab_np = _domain_run_source(
            domain_cell_emission_run, domain, medium, lanes, None,
            src_of_freq, hi_base, seed, grid, cfg, tabs, intf,
            per_freq_tally, physics_extra=physics_extra,
            with_ali=bool(cfg.with_ali), src_kw=src_kw)
        return tabs, intf, escaped, xab_np

    if cfg.use_emweight > 0:
        # allocation varies per frequency => per-frequency pools with a
        # host-built id->cell map. The roulette RNG is counter-based
        # (Philox keyed by (seed, iteration)) so allocations are
        # reproducible across runs; the lane-pool size is keyed to CLPAC
        # (not the realized total) so ONE executable covers all frequencies.
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64([int(seed) & 0xFFFFFFFF, iteration])))
        nlanes = _pool_lanes(lanes, int(cfg.clpac))
        escaped = np.zeros(medium.nfreq)
        allocs = _emweight_allocs(emitted_np, cfg, rng, medium.nfreq)
        for ifreq in range(medium.nfreq):
            cell_of_id, weight, total = allocs[ifreq]
            if total == 0:
                continue
            physics = dict(kabs=medium.abs_gl[ifreq],
                           ksca=medium.sca_gl[ifreq],
                           csc=medium.csc[ifreq], tw=medium.tw[ifreq])
            if physics_extra is not None:
                physics.update(physics_extra(ifreq))
            # pad the id->cell map to a static shape (extra ids are never
            # generated: total_packets caps the refill)
            pad = _pool_lanes(1 << 30, total)
            com = np.full(pad, grid.cells - 1, np.int32)
            com[:total] = cell_of_id
            col = jnp.int32(0) if host_tally is not None \
                else jnp.int32(ifreq)
            hib = jnp.uint32(int(hi_base) + ifreq) \
                if host_tally is not None else jnp.uint32(hi_base)
            intf_t = intf if host_tally is None else \
                jnp.zeros((grid.cells, 1) + host_tally.shape[2:],
                          jnp.float32)
            params = dict(emit=emitted[:, ifreq] * jnp.asarray(weight),
                          cell_of_id=jnp.asarray(com),
                          ifreq=col,
                          per_freq=jnp.int32(pad),
                          hi_base=hib)
            tabs, intf_t, esc, absd = transport_run(
                grid, physics, params, jnp.int32(total), tabs, intf_t,
                seed, source_kind="cell", nlanes=nlanes,
                per_freq_tally=per_freq_tally,
                mirror_mask=mirror_mask_of(cfg))
            if host_tally is not None:
                host_tally[:, ifreq] += np.asarray(intf_t)[:, 0]
            else:
                intf = intf_t
            escaped[ifreq] = float(esc[0])
        return tabs, intf, escaped, None

    per_cell = max(1, int(cfg.clpac) // grid.cells)
    per_freq = per_cell * grid.cells

    if cfg.with_ali:
        # per-frequency loop with XAB self-absorption tally (ALI)
        xab = jnp.zeros(grid.cells, jnp.float32)
        escaped = np.zeros(medium.nfreq)
        for ifreq in range(medium.nfreq):
            physics = dict(kabs=medium.abs_gl[ifreq],
                           ksca=medium.sca_gl[ifreq],
                           csc=medium.csc[ifreq], tw=medium.tw[ifreq])
            if physics_extra is not None:
                physics.update(physics_extra(ifreq))
            col = jnp.int32(0) if host_tally is not None \
                else jnp.int32(ifreq)
            hib = jnp.uint32(int(hi_base) + ifreq) \
                if host_tally is not None else jnp.uint32(hi_base)
            intf_t = intf if host_tally is None else \
                jnp.zeros((grid.cells, 1) + host_tally.shape[2:],
                          jnp.float32)
            params = dict(emit=emitted[:, ifreq] / np.float32(per_cell),
                          per_cell=jnp.int32(per_cell),
                          ifreq=col,
                          per_freq=jnp.int32(per_freq),
                          hi_base=hib)
            tabs, intf_t, esc, absd, xab = transport_run(
                grid, physics, params, jnp.int32(per_freq), tabs, intf_t,
                seed, source_kind="cell",
                nlanes=_pool_lanes(lanes, per_freq),
                per_freq_tally=per_freq_tally, with_ali=True, xab=xab,
                mirror_mask=mirror_mask_of(cfg))
            if host_tally is not None:
                host_tally[:, ifreq] += np.asarray(intf_t)[:, 0]
            else:
                intf = intf_t
            escaped[ifreq] = float(esc[0])
        return tabs, intf, escaped, np.asarray(xab)

    if physics_extra is None and host_tally is None and ckpt is None:
        # mixed-frequency pool over (cell, freq): like the background
        # source, the drain tail is paid once instead of NFREQ times and
        # the per-lane-constant fast path applies. Packet identity
        # (hi = hi_base + ifreq, k = in-frequency id) is the same as the
        # per-frequency loop's, so tallies agree up to summation order.
        nfreq = medium.nfreq
        physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl,
                       csc=medium.csc, tw=medium.tw)
        emitw = emitted * np.float32(1.0 / per_cell)     # [CELLS, NFREQ]
        total = per_freq * nfreq
        chunk = 4 << 20
        nlanes = _pool_lanes(lanes, total if total < (1 << 31) else chunk)
        escaped = jnp.zeros(nfreq, jnp.float32)
        for off in range(0, total, chunk):
            n = min(chunk, total - off)
            params = dict(emit=emitw, per_cell=jnp.int32(per_cell),
                          ifreq=None, per_freq=jnp.int32(per_freq),
                          ifreq0=jnp.int32(off // per_freq),
                          k0=jnp.uint32(off % per_freq),
                          hi_base=jnp.uint32(hi_base))
            tabs, intf, esc, absd = transport_run(
                grid, physics, params, jnp.int32(n), tabs, intf, seed,
                source_kind="cell", nlanes=nlanes,
                per_freq_tally=per_freq_tally, esc_bins=nfreq,
                mirror_mask=mirror_mask_of(cfg))
            escaped = escaped + esc
        return tabs, intf, np.asarray(escaped), None

    def make_params(ifreq):
        return dict(emit=emitted[:, ifreq] / np.float32(per_cell),
                    per_cell=jnp.int32(per_cell))

    tabs, intf, escaped, absorbed = _run_over_freqs(
        grid, medium, "cell", make_params, per_freq, tabs, intf, seed,
        lanes, per_freq_tally, iteration=iteration,
        mirror_mask=mirror_mask_of(cfg),
        physics_extra=physics_extra, host_tally=host_tally,
        ckpt=ckpt, ckpt_key="it%d" % iteration, ckpt_slot="p2_tabs")
    return tabs, intf, escaped, None


def read_diffuse_field(path, cells):
    """Read the diffuse-emission file: int32 [CELLS, NF'] header + float32
    payload, photons/Hz/cm^3 per cell (mmap_diffuserad, ASOC_aux.py:839-868).
    NF' may be smaller than NFREQ; the stored values are then the HIGHEST
    frequencies."""
    with open(path, "rb") as fp:
        c, nf = np.fromfile(fp, np.int32, 2)
        if c != cells:
            raise ValueError("%s: %d cells != model %d" % (path, c, cells))
        data = np.fromfile(fp, np.float32).reshape(int(c), int(nf))
    return data


def simulate_diffuse(grid, medium, cfg, diffuserad, tabs, intf, seed,
                     lanes=DEFAULT_LANES, per_freq_tally=False,
                     freq_mask=None, roi=None, physics_extra=None,
                     ckpt=None, domain=None, pmesh=None, host_tally=None):
    """Phase-1 diffuse volume emission (SimRAM_CL SOURCE==2, the reference's
    II==2 source block, ASOC.py:1250-1272).

    diffuserad : [CELLS, NF'] photons/Hz/cm^3. Per frequency, the per-cell
    photon load is DIFFUSERAD * K_DIFFUSE * GL*PARSEC / 8^level (cell-volume
    weighting); packets per cell = DFPAC // CELLS.
    Returns (tabs, intf, escaped[NF], injected[NF]).
    """
    from ..solve import equilibrium
    nfreq = medium.nfreq
    nf_d = diffuserad.shape[1]
    dfpac = cfg.dfpac if cfg.dfpac > 0 else cfg.clpac
    per_cell = max(1, int(dfpac) // grid.cells)
    per_freq = per_cell * grid.cells
    lev = np.asarray(equilibrium.cell_levels(grid))
    coeff = (cfg.k_diffuse * cfg.gl * PARSEC / 8.0 ** lev).astype(np.float64)
    injected = np.zeros(nfreq)
    use_ew = cfg.use_emweight > 0
    cols_np = {}               # float64 columns kept only for EMWEI
    emit_cols = {}
    for ifreq in range(nfreq):
        dr_ind = ifreq + (nf_d - nfreq)     # highest frequencies stored
        if dr_ind < 0:
            continue
        col = (np.asarray(diffuserad[:, dr_ind], np.float64) * coeff)
        if use_ew:
            cols_np[ifreq] = col
        emit_cols[ifreq] = jnp.asarray((col / per_cell).astype(np.float32))
        injected[ifreq] = col.sum()
    mask = np.zeros(nfreq, bool)
    mask[list(emit_cols.keys())] = True
    if freq_mask is not None:
        mask &= np.asarray(freq_mask, bool)
    injected[~mask] = 0.0

    # EMWEI on the diffuse source (the reference's phase-1 weighting
    # block, ASOC.py:1277-1292: clip + Russian roulette only -- no
    # LIM[2], no mode 2 there -- budget DFPAC, EMWEIGHT_SKIP reuse over
    # simulated frequencies)
    allocs = None
    if use_ew:
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64([int(seed) & 0xFFFFFFFF, 0xD1FF])))
        allocs = {}
        last = None
        skipn = max(1, int(cfg.emweight_skip))
        kth = 0
        zero_col = np.zeros(grid.cells)
        for i in range(nfreq):
            if not mask[i]:
                continue
            if last is None or kth % skipn == 0:
                last = emweight_allocation(
                    cols_np.get(i, zero_col), int(dfpac),
                    lims=cfg.emweight_lim[:2], rng=rng)
            kth += 1
            allocs[i] = last
        pad = _pool_lanes(1 << 30,
                          max(1, *(a[2] for a in allocs.values()))
                          if allocs else 1)

        def _ew_params(ifreq):
            cell_of_id, weight, total = allocs[ifreq]
            com = np.full(pad, grid.cells - 1, np.int32)
            com[:total] = cell_of_id
            emit = (cols_np[ifreq] * weight).astype(np.float32)
            return dict(emit=jnp.asarray(emit),
                        cell_of_id=jnp.asarray(com),
                        per_freq=jnp.int32(pad))

        def _ew_total(ifreq):
            return allocs[ifreq][2] if ifreq in allocs else 0

    if pmesh is not None:
        from ..parallel import product

        if allocs is not None:
            def make_params_p(ifreq):
                p = _ew_params(ifreq)
                p.pop("per_freq")          # run_freqs sets the budget
                return p
            pf_of = _ew_total
        else:
            def make_params_p(ifreq):
                return dict(emit=emit_cols[ifreq],
                            per_cell=jnp.int32(per_cell))
            pf_of = per_freq

        tabs, intf, escaped, _, _ = product.run_freqs(
            pmesh, grid, medium, "cell", make_params_p, pf_of, tabs,
            intf, seed, lanes, per_freq_tally, phase="diffuse",
            mirror_mask=mirror_mask_of(cfg), freq_mask=mask, roi=roi,
            physics_extra=physics_extra, ckpt=ckpt, ckpt_key="diffuse")
        return tabs, intf, escaped, injected

    if domain is not None:
        # `domains N`: the diffuse field uses the cell-emission generator,
        # so the per-slab ownership runner applies directly
        from ..parallel.domain import domain_cell_emission_run
        from ..transport.sources import stream_hi_base
        if allocs is not None:
            def src_of_freq(i):
                if i not in allocs or allocs[i][2] == 0:
                    return None
                return (cols_np[i] * allocs[i][1], 1)

            def src_kw(i):
                com = np.full(pad, grid.cells - 1, np.int32)
                com[:allocs[i][2]] = allocs[i][0]
                return dict(cell_of_id=com, total_packets=allocs[i][2])
        else:
            def src_of_freq(i):
                return ((np.asarray(emit_cols[i]), per_cell)
                        if i in emit_cols else None)
            src_kw = None
        tabs, intf, escaped, _ = _domain_run_source(
            domain_cell_emission_run, domain, medium, lanes, mask,
            src_of_freq,
            stream_hi_base("diffuse"), seed, grid, cfg, tabs, intf,
            per_freq_tally, physics_extra=physics_extra, src_kw=src_kw)
        return tabs, intf, escaped, injected

    if allocs is not None:
        make_params, pf_of, cap = _ew_params, _ew_total, pad
    else:
        def make_params(ifreq):
            return dict(emit=emit_cols[ifreq], per_cell=jnp.int32(per_cell))
        pf_of, cap = per_freq, None

    tabs, intf, escaped, absorbed = _run_over_freqs(
        grid, medium, "cell", make_params, pf_of, tabs, intf, seed,
        lanes, per_freq_tally, phase="diffuse",
        mirror_mask=mirror_mask_of(cfg), freq_mask=mask, roi=roi,
        physics_extra=physics_extra, ckpt=ckpt, ckpt_key="diffuse",
        host_tally=host_tally, pool_cap=cap)
    return tabs, intf, escaped, injected


def simulate_roi_load(grid, medium, cfg, tabs, intf, seed,
                      lanes=DEFAULT_LANES, per_freq_tally=False,
                      freq_mask=None, pmesh=None, host_tally=None):
    """Phase-1 ROI boundary source (SOURCE==3, kernel_ASOC.c:469-505):
    re-inject the (surface element x healpix direction) photon histograms
    recorded by a previous run's roisave into this (sub-)model.
    Returns (tabs, intf, escaped[NF], injected[NF])."""
    from ..transport.roi import read_roi_file
    rnx, rny, rnz, nside, data = read_roi_file(cfg.file_roi_load)
    nfreq = medium.nfreq
    if data.shape[0] != nfreq:
        raise ValueError("%s: %d freqs != model %d"
                         % (cfg.file_roi_load, data.shape[0], nfreq))
    npix = 12 * nside * nside
    nelem = data.shape[1] // npix
    reps = max(1, int(cfg.roipac) // (nelem * npix))
    per_freq = reps * nelem * npix
    scale = cfg.roi_load_scale
    injected = np.zeros(nfreq)

    def make_params(ifreq):
        load = (np.asarray(data[ifreq], np.float64)
                * scale).reshape(nelem, npix)
        injected[ifreq] = load.sum()
        return dict(roi_load=jnp.asarray(load.astype(np.float32)),
                    roi_dim=(rnx, rny, rnz),
                    reps=jnp.int32(reps))

    if pmesh is not None:
        from ..parallel import product
        tabs, intf, escaped, absorbed, _ = product.run_freqs(
            pmesh, grid, medium, "roi", make_params, per_freq, tabs, intf,
            seed, lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
            freq_mask=freq_mask)
        # injected is a make_params side effect: fill the masked-out rows
        for i in range(nfreq):
            if freq_mask is None or bool(freq_mask[i]):
                make_params(i)
        return tabs, intf, escaped, injected

    tabs, intf, escaped, absorbed = _run_over_freqs(
        grid, medium, "roi", make_params, per_freq, tabs, intf, seed,
        lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg),
        freq_mask=freq_mask, host_tally=host_tally)
    return tabs, intf, escaped, injected


def run(ini_path=None, cfg=None, lanes=DEFAULT_LANES, write_files=True,
        workdir=None):
    """Full pipeline; returns RunResult. workdir defaults to the ini dir."""
    enable_compile_cache()
    t_start = time.time()
    if cfg is None:
        cfg = RunConfig(ini_path)
    if workdir is None:
        workdir = os.path.dirname(os.path.abspath(ini_path)) if ini_path else "."
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        return _run_inner(cfg, lanes, write_files, t_start)
    finally:
        os.chdir(orig)


def mirror_mask_of(cfg):
    """'mirror xXyYzZ' keyword -> 6-bit mask (ASOC.py:321-324)."""
    m = 0
    for bit, ch in enumerate("xXyYzZ"):
        if ch in cfg.mirror:
            m |= 1 << bit
    return m


def split_max_of(cfg, grid):
    """In-flight splitting applies only on refined (multi-level) clouds
    (SimBgSplit/SimHpSplit, kernel_ASOC.c:2121-3554)."""
    return int(cfg.do_split) if grid.levels > 1 else 0


def _product_setup(cfg, nfreq):
    """`devices N` keyword: the multi-chip product path -- EVERY phase of
    the ordinary ini run sharded over a (dp x freq) mesh with no feature
    exclusions (parallel/product.py). Returns ProductMesh or None."""
    n = int(getattr(cfg, "n_devices", 0))
    if n == 0:
        return None
    import jax
    if n < 0:
        n = len(jax.devices())
    if n <= 1:
        return None
    if int(cfg.n_domains) > 1:
        raise ValueError("`devices` and `domains` are mutually exclusive: "
                         "pick packet/frequency sharding or Z-slab "
                         "decomposition")
    from ..parallel.product import ProductMesh
    return ProductMesh(n, nfreq)


def _domain_setup(cfg, grid, per_freq_tally):
    """`domains N` keyword: Z-slab spatial domain decomposition of the
    transport over N devices (parallel/domain.py) -- covers every source
    type: bg, healpix bg, point sources, diffuse field, cell emission.
    Returns (slabs, mesh) or None when disabled."""
    n = int(cfg.n_domains)
    if n <= 1:
        return None
    import jax
    from ..parallel.mesh import make_mesh
    from ..parallel.domain import split_grid_slabs
    if len(jax.devices()) < n:
        raise ValueError("domains %d: only %d devices visible"
                         % (n, len(jax.devices())))
    if grid.nz % n:
        raise ValueError("domains %d: NZ=%d not divisible" % (n, grid.nz))
    # the step physics under domains IS transport_run's StepKit, so the
    # round-2 exclusion list (per-frequency tallies, ALI, emweight, split,
    # mirror, stepweight, direweight, abundances) is gone. What remains
    # unsupported is orthogonal machinery that spans slabs on the host:
    for bad, name in ((cfg.roi, "roi (crossing histograms need global "
                       "root coordinates; use `devices`)"),
                      (cfg.has_key("SUBITERATIONS"), "SUBITERATIONS "
                       "(use `devices`)"),
                      (cfg.file_checkpoint, "checkpoint (use `devices`)")):
        if bad:
            raise ValueError("domains: `%s` is not supported under "
                             "domain decomposition" % name)
    mesh = make_mesh(jax.devices()[:n], freq_axis=1)
    return split_grid_slabs(grid, n), mesh


def _domain_run_source(runner, domain, medium, lanes, freq_mask,
                       src_of_freq, hi0, seed, grid, cfg, tabs, intf,
                       per_freq_tally, physics_extra=None, split=False,
                       with_ali=False, src_kw=None):
    """Common wrapper of the domain-decomposed source runners: builds the
    feature set from the ini (per-frequency tallies, ALI, mirror, split --
    the step physics is transport_run's own StepKit, so nothing is
    excluded), accumulates the per-channel aux tallies into the caller's
    intf, and returns (tabs, intf, escaped, xab|None)."""
    slabs, dmesh = domain
    icomps = intf.shape[2] if (per_freq_tally and intf.ndim == 3) else 0
    features = dict(per_freq_tally=per_freq_tally, icomps=icomps,
                    with_ali=with_ali, mirror_mask=mirror_mask_of(cfg),
                    split_max=split_max_of(cfg, grid) if split else 0)
    intf_host = np.zeros(intf.shape, np.float32) if per_freq_tally else None
    tabs_np, escaped, xab_np = _run_domain_freqs(
        runner, slabs, dmesh, medium, lanes, freq_mask, src_of_freq,
        hi0, seed, grid.cells, features=features,
        physics_extra=physics_extra, intf_host=intf_host, src_kw=src_kw)
    tabs = tabs + jnp.asarray(tabs_np)
    if intf_host is not None:
        intf = intf + jnp.asarray(intf_host)
    return tabs, intf, escaped, xab_np


def _run_domain_freqs(runner, slabs, dmesh, medium, lanes, freq_mask,
                      src_of_freq, hi0, seed, cells, features=None,
                      physics_extra=None, intf_host=None, src_kw=None):
    """Shared per-frequency loop of the domain-decomposed sources: one
    runner call per channel (all hit one cached executable). The runner's
    per-channel aux tallies (per-frequency absorption column, ALI xab) are
    accumulated into intf_host [CELLS, NFREQ(, 4)] / the returned xab."""
    from ..parallel.domain import assemble_slab_tallies
    feat = features or {}
    dn = max(256, lanes // slabs.n_slabs)
    escaped = np.zeros(medium.nfreq)
    # device-resident channel loop: raw per-slab tallies accumulate on
    # device and cross the link ONCE at the end (previously one
    # [CELLS]-sized host round-trip per channel serialized dispatch)
    tabs_acc = xab_acc = None
    intf_cols, chans = {}, []
    esc_dev, lost_dev = [], []
    for ifreq in range(medium.nfreq):
        if freq_mask is not None and not bool(freq_mask[ifreq]):
            continue
        src = src_of_freq(ifreq)
        if src is None:
            continue
        kw = {} if src_kw is None else dict(src_kw(ifreq))
        physics = dict(kabs=medium.abs_gl[ifreq],
                       ksca=medium.sca_gl[ifreq],
                       csc=medium.csc[ifreq], tw=medium.tw[ifreq])
        if physics_extra is not None:
            physics.update(physics_extra(ifreq))
        tabs_s, intf_s, xab_s, e, lost = runner(
            slabs, physics, *src, seed, dmesh, nlanes=dn,
            hi_base=hi0 + ifreq, features=features, raw=True, **kw)
        tabs_acc = tabs_s if tabs_acc is None else tabs_acc + tabs_s
        if feat.get("per_freq_tally") and intf_host is not None:
            intf_cols[ifreq] = intf_s
        if feat.get("with_ali"):
            xab_acc = xab_s if xab_acc is None else xab_acc + xab_s
        chans.append(ifreq)
        esc_dev.append(e)
        lost_dev.append(lost)
    if tabs_acc is None:
        return np.zeros(cells, np.float32), escaped, None
    lost_all = np.asarray(jnp.stack(lost_dev))
    for k, ifreq in enumerate(chans):
        if lost_all[k]:
            raise RuntimeError(
                "domains: pending-queue overflow destroyed %g photon "
                "weight at channel %d; raise `lanes`"
                % (float(lost_all[k]), ifreq))
    escaped[np.asarray(chans)] = np.asarray(jnp.stack(esc_dev))
    tabs_np = assemble_slab_tallies(slabs, tabs_acc)
    for ifreq, col in intf_cols.items():
        extra = (intf_host.shape[2],) if intf_host.ndim == 3 else ()
        intf_host[:, ifreq] += assemble_slab_tallies(slabs, col, extra)
    xab_np = (assemble_slab_tallies(slabs, xab_acc)
              if xab_acc is not None else None)
    return tabs_np, escaped, xab_np


def nearest_freq_mask(freq, values):
    """bool[NFREQ] with the channel nearest each value set (the FSELECT /
    mapum / wavelength 'nearest frequency' rule, shared by every caller)."""
    freq = np.asarray(freq)
    mask = np.zeros(len(freq), bool)
    for fv in values:
        mask[int(np.argmin(np.abs(freq - fv)))] = True
    return mask


def remit_mask_of(cfg, freq):
    """bool[NFREQ]: frequencies inside the `remit` re-emission band
    (reference REMIT_I1..REMIT_I2, ASOC.py:604-612)."""
    return (np.asarray(freq) >= cfg.remit_f[0]) \
        & (np.asarray(freq) <= cfg.remit_f[1])


def _apply_remit_band(cfg, freq, emitted):
    """Zero emission outside the remit band."""
    mask = remit_mask_of(cfg, freq)
    if not mask.all():
        emitted = emitted.copy()
        emitted[:, ~mask] = 0.0
    return emitted


def _apply_remit_band_dev(cfg, freq, emitted):
    """Device-side remit masking: the iteration loop would otherwise
    round-trip the [CELLS, NFREQ] emission through host NumPy every
    iteration (seconds per iteration on a slow host link)."""
    mask = remit_mask_of(cfg, freq)
    if mask.all():
        return emitted
    return emitted * jnp.asarray(mask.astype(np.float32))[None, :]


def _scaled_absorbed(grid, intf, gl_cm, nnn_limit=0.0):
    """Per-frequency tallies -> absorbed.data payload: scale by
    8^level*FACTOR/(GL*PARSEC)/DENS, mark parent cells -1e20; cells with
    DENS <= nnn_limit are excluded the same way (`nnnlimit` keyword,
    ASOC.py:2782-2837, 2808-2825)."""
    from ..solve import equilibrium
    lev = np.asarray(equilibrium.cell_levels(grid))
    dens = np.asarray(grid.dens)
    fabs = np.asarray(intf)
    coeff = (8.0 ** lev) * (FACTOR / gl_cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        fabs = fabs * (coeff / np.maximum(dens, 1e-35))[:, None]
    fabs[dens <= max(0.0, nnn_limit)] = -1.0e20
    return fabs


def _scale_absorbed_inplace(grid, tally, gl_cm, nnn_limit=0.0,
                            block=1 << 20):
    """_scaled_absorbed semantics applied IN PLACE over row blocks: used
    for the out-of-core host tally (mmapabs), where materializing a scaled
    copy of [CELLS, NFREQ] would defeat the point."""
    from ..solve import equilibrium
    lev = np.asarray(equilibrium.cell_levels(grid))
    dens = np.asarray(grid.dens)
    coeff = (8.0 ** lev) * (FACTOR / gl_cm)
    bad = dens <= max(0.0, nnn_limit)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = coeff / np.maximum(dens, 1e-35)
    # link/parent rows are overwritten with -1e20 below; zeroing their
    # scale first keeps the float32 cast finite (no transient inf)
    scale[bad] = 0.0
    scale = scale.astype(np.float32)
    for i0 in range(0, tally.shape[0], block):
        i1 = min(i0 + block, tally.shape[0])
        tally[i0:i1] *= scale[i0:i1, None]
        tally[i0:i1][bad[i0:i1]] = -1.0e20
    return tally


def _write_cell_frequency_array_chunked(path, arr, block=1 << 20):
    """absorbed.data ABI writer that never materializes a copy."""
    with open(path, "wb") as fp:
        np.asarray(arr.shape[:2], np.int32).tofile(fp)
        for i0 in range(0, arr.shape[0], block):
            np.ascontiguousarray(arr[i0:i0 + block],
                                 dtype=np.float32).tofile(fp)


def _write_emitted_file(cfg, freq, emitted):
    """Write emitted.data with the reference ABI: only the REMIT-band
    columns are stored (ASOC.py:3972-3977 EMITTED[REMIT_NFREQ])."""
    mask = remit_mask_of(cfg, freq)
    write_cell_frequency_array(cfg.file_emitted,
                               np.asarray(emitted)[:, mask])


def _run_inner(cfg, lanes, write_files, t_start):
    cfg.validate()
    res = RunResult()
    timings = res.timings

    # ---- model input
    t0 = time.time()
    grid = read_cloud(cfg.file_cloud, cfg.kdensity, cfg.max_levels)
    optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
    freq = optics[0].freq
    cfg.freq = freq
    cfg.nfreq = len(freq)
    nfreq = len(freq)
    bins = cfg.dsc_bins if cfg.dsc_bins > 0 else 2500
    dscs, cscs = [], []
    for path in cfg.file_scafunc:
        d, c = read_scattering_function(path, nfreq, bins)
        dscs.append(d)
        cscs.append(c)
    medium = medium_from_optics(optics, dscs[0], cscs[0], freq)
    res.grid, res.freq = grid, freq
    seed = np.uint32(max(0.0, cfg.seed) * 2**31) + np.uint32(12345)

    # ---- WITH_ABU / WITH_MSF: spatially varying abundances build per-cell
    # cross sections per frequency (the reference's OPT array,
    # ASOC.py:1146-1175), and one scattering function per dust species
    # drives per-species CSC sampling (kernel_ASOC.c:786-795)
    ndust = len(optics)
    abu = None
    if ndust > 1 and cfg.file_abundance:
        abu = np.ones((grid.cells, ndust), np.float32)
        for d, path in enumerate(cfg.file_abundance[:ndust]):
            if path and not path.startswith("#"):
                abu[:, d] = np.fromfile(path, np.float32, grid.cells)
    abu_extra = None
    if abu is not None:
        abs_d = np.stack([np.asarray(o.abs_gl) for o in optics])  # [D, NF]
        sca_d = np.stack([np.asarray(o.sca_gl) for o in optics])
        abu_j = jnp.asarray(abu)
        msf = (len(cscs) == ndust)
        msf_csc = jnp.asarray(np.stack(cscs)) if msf else None
        # optishalf: store the per-cell OPT arrays in bfloat16 (reference
        # fp16 OPT, ASOC_aux.py:266-267)
        opt_dtype = jnp.bfloat16 if cfg.optishalf else jnp.float32

        def cross_section(k):
            return jnp.dot(abu_j, jnp.asarray(k),
                           precision=jax.lax.Precision.HIGHEST)

        def abu_extra(ifreq):
            extra = dict(
                opt_abs=cross_section(abs_d[:, ifreq]).astype(opt_dtype),
                opt_sca=cross_section(sca_d[:, ifreq]).astype(opt_dtype))
            if msf:
                extra.update(msf_csc=msf_csc[:, ifreq], msf_abu=abu_j,
                             msf_sca=jnp.asarray(sca_d[:, ifreq]))
            return extra

    # step/direction weighting (STEP_WEIGHT 1, DIR_WEIGHT; per-frequency
    # transport path because physics gains run-specific entries)
    sw_on = cfg.step_weight[0] in (1, 2) and cfg.step_weight[1] > 0
    dw_on = cfg.dir_weight[0] >= 0 and abs(cfg.dir_weight[1]) > 1e-6 \
        and abu is None
    physics_extra = None
    if abu_extra is not None or sw_on or dw_on:
        def physics_extra(ifreq):
            d = abu_extra(ifreq) if abu_extra is not None else {}
            if sw_on:
                d["sw_a"] = jnp.float32(cfg.step_weight[1])
                if cfg.step_weight[0] == 2:
                    # two-exponential mixture (kernel_ASOC.c:529-541);
                    # B must be < 1 or the quadratic degenerates (the
                    # reference divides by 2-2B just the same)
                    d["sw_b"] = jnp.float32(cfg.step_weight[2])
            if dw_on:
                d["dw_a"] = jnp.float32(cfg.dir_weight[1])
                d["dsc"] = medium.dsc[ifreq]
            return d
    timings["input"] = time.time() - t0

    # ---- packet.info run-metadata drop file (ASOC.py:251)
    if write_files:
        np.asarray([cfg.bgpac, cfg.pspac, cfg.dfpac, cfg.clpac],
                   np.int32).tofile("packet.info")

    # ---- loadtemp mode (reference ASOC.py:744-769): recompute EMITTED
    # from a stored temperature file (equilibrium dust) and render maps
    if cfg.load_temperature and cfg.iterations < 1:
        from ..io.cloud import read_hierarchy
        _, _, _, _, vals = read_hierarchy(cfg.file_temperature)
        temperature = np.concatenate(vals)
        res.temperature = temperature
        emitted = np.asarray(equilibrium.emission(
            freq, optics[0].abs_gl, jnp.asarray(temperature),
            cfg.gl * PARSEC))
        emitted = _apply_remit_band(cfg, freq, emitted)
        res.emitted = emitted
        res.ctabs = np.zeros(grid.cells, np.float32)
        res.escaped = np.zeros(nfreq)
        res.injected = np.zeros(nfreq)
        if write_files and cfg.file_emitted:
            _write_emitted_file(cfg, freq, res.emitted)
        _render_phase(cfg, grid, medium, res, freq, res.emitted,
                      write_files, timings)
        timings["total"] = time.time() - t_start
        return res

    # ---- map-only mode (reference: iterations 0 + existing emitted file):
    # skip simulation/solve, render maps from the file
    if cfg.iterations < 1 and os.path.exists(cfg.file_emitted):
        from ..io.fields import read_cell_frequency_array
        emitted = read_cell_frequency_array(cfg.file_emitted)
        if emitted.shape[1] != nfreq:
            # remit-band (or libmaps) file: embed into the full grid
            mask = remit_mask_of(cfg, freq)
            if cfg.lib_maps and cfg.fselect:
                mask = nearest_freq_mask(freq, cfg.fselect)
            if mask.sum() != emitted.shape[1]:
                raise ValueError(
                    "emitted file has %d freqs; remit/libmaps selection "
                    "has %d" % (emitted.shape[1], int(mask.sum())))
            full = np.zeros((emitted.shape[0], nfreq), np.float32)
            full[:, mask] = emitted
            emitted = full
        res.emitted = emitted
        res.ctabs = np.zeros(grid.cells, np.float32)
        res.escaped = np.zeros(nfreq)
        res.injected = np.zeros(nfreq)
        _render_phase(cfg, grid, medium, res, freq, res.emitted,
                      write_files, timings)
        timings["total"] = time.time() - t_start
        return res

    # ---- simulated-frequency mask: `simum` band and/or libabs FSELECT
    # reference frequencies (ASOC.py:63-65, 1126-1131)
    freq_mask = None
    sim_mask = (freq >= cfg.sim_f[0]) & (freq <= cfg.sim_f[1])
    if not sim_mask.all():
        freq_mask = sim_mask
    if cfg.lib_abs and cfg.fselect:
        sel = nearest_freq_mask(freq, cfg.fselect)
        freq_mask = sel if freq_mask is None else (freq_mask & sel)

    # ---- WITH_ROI_SAVE: histogram packets crossing into the ROI box
    roi = None
    if cfg.roi is not None and cfg.file_roi_save:
        from ..transport.roi import roi_cell_mask, roi_nelem
        step = cfg.roi_step
        x0, x1, y0, y1, z0, z1 = cfg.roi
        rnx = (x1 - x0 + 1) * step
        rny = (y1 - y0 + 1) * step
        rnz = (z1 - z0 + 1) * step
        nelem = roi_nelem(rnx, rny, rnz)
        roi = dict(nside=int(cfg.roi_nside),
                   mask=jnp.asarray(roi_cell_mask(grid, cfg.roi)),
                   box=tuple(float(v) for v in cfg.roi),
                   dim=(rnx, rny, rnz, float(step)),
                   tally=np.zeros(
                       (nfreq, nelem * 12 * cfg.roi_nside ** 2),
                       np.float32))

    # ---- phase 1: constant sources
    t0 = time.time()
    per_freq_tally = (not cfg.noabsorbed) or cfg.save_intensity > 0
    domain = _domain_setup(cfg, grid, per_freq_tally)
    pmesh = _product_setup(cfg, nfreq)
    if cfg.save_intensity == 2:
        tally_shape = (grid.cells, nfreq, 4)      # (I, Ix, Iy, Iz)
    elif per_freq_tally:
        tally_shape = (grid.cells, nfreq)
    else:
        tally_shape = (1, 1)
    tabs = jnp.zeros(grid.cells, jnp.float32)
    host_tally = None
    if pmesh is not None and per_freq_tally:
        # dp-partial per-frequency tallies, frequency-sharded: the
        # [CELLS, NFREQ] absorption array never lives on one chip
        intf = pmesh.zeros_intf(grid.cells,
                                comps=4 if cfg.save_intensity == 2 else 0)
    else:
        if per_freq_tally:
            # out-of-core tally (`mmapabs`, or automatically when the
            # array exceeds SOC_TPU_TALLY_BYTES): the reference mmaps
            # FABSORBED on the host for exactly this reason
            # (ASOC.py:39-42, 623-638) -- the device then holds ONE
            # [CELLS] column at a time and columns stream back per channel
            need = int(grid.cells) * nfreq * 4 \
                * (4 if cfg.save_intensity == 2 else 1)
            budget = int(float(os.environ.get("SOC_TPU_TALLY_BYTES",
                                              "0") or 0))
            if cfg.mmap_absorbed or (budget and need > budget):
                if domain is not None:
                    raise ValueError("mmapabs under `domains` is not "
                                     "supported; use `devices` (the "
                                     "freq-sharded tally)")
                import tempfile
                tf = tempfile.NamedTemporaryFile(
                    prefix=".fabsorbed.", suffix=".tally", dir=".",
                    delete=False)
                host_tally = np.memmap(tf.name, dtype=np.float32,
                                       mode="w+", shape=tally_shape)
                os.unlink(tf.name)     # scratch: vanishes with the mmap
                host_tally[:] = 0.0
                intf = jnp.zeros((1, 1), jnp.float32)
        if host_tally is None:
            intf = jnp.zeros(tally_shape, jnp.float32)
    injected = np.zeros(nfreq)
    escaped = np.zeros(nfreq)
    ckpt = None
    if cfg.file_checkpoint:
        from ..utils.checkpoint import RunCheckpoint
        # fingerprint = hash of every ini keyword except the checkpoint
        # line itself: a checkpoint written under different inputs (other
        # seed, packet counts, model files...) must not be resumed
        import hashlib
        items = sorted((k, tuple(map(tuple, v)))
                       for k, v in cfg.keys.items()
                       if not k.startswith(("checkpoint", "verbose")))
        fp = hashlib.sha256(repr(items).encode()).hexdigest()[:16]
        ckpt = RunCheckpoint(cfg.file_checkpoint, cfg.checkpoint_every,
                             fingerprint=fp)
        if pmesh is not None and per_freq_tally:
            # the checkpoint stores the REDUCED [CELLS, NFREQ] tally;
            # resume loads it into dp slab 0 (partial sums stay correct)
            tabs, intf0 = ckpt.restore(tabs,
                                       np.zeros(tally_shape, np.float32))
            intf = pmesh.scatter_intf(np.asarray(intf0))
        elif host_tally is not None:
            tabs, _ = ckpt.restore(tabs, jnp.zeros((1, 1), jnp.float32))
            if ckpt.arrays is not None:
                host_tally[:] = np.asarray(ckpt.arrays["intf"])
        else:
            tabs, intf = ckpt.restore(tabs, intf)
        if roi is not None:
            roi["tally"] = ckpt.restore_roi(roi["tally"])
    if cfg.file_constant_load:
        # CLOAD: constant sources not simulated, integrated heating read
        # from a previous run's csave file (ASOC.py:1013-1020)
        tabs = jnp.asarray(np.fromfile(cfg.file_constant_load, np.float32,
                                       grid.cells))
    else:
        if cfg.bgpac > 0 and cfg.file_background:
            ibg = read_background_intensity(cfg.file_background, nfreq)
            ibg = ibg * cfg.scale_background
            tabs, intf, esc, inj = simulate_background(
                grid, medium, cfg, ibg, tabs, intf, seed, lanes,
                per_freq_tally, freq_mask=freq_mask, roi=roi,
                physics_extra=physics_extra, ckpt=ckpt, domain=domain,
                pmesh=pmesh, host_tally=host_tally)
            escaped += np.asarray(esc)
            injected += inj
        if cfg.bgpac > 0 and cfg.file_hpbg:
            hpbg = np.fromfile(cfg.file_hpbg, np.float32).reshape(nfreq, -1)
            hpbg = hpbg * cfg.scale_background
            tabs, intf, esc, inj = simulate_hpbg(
                grid, medium, cfg, hpbg, tabs, intf, seed + 3, lanes,
                per_freq_tally, weighted=cfg.has_key("hpbgw"),
                freq_mask=freq_mask, roi=roi,
                physics_extra=physics_extra, ckpt=ckpt, domain=domain,
                pmesh=pmesh, host_tally=host_tally)
            escaped += np.asarray(esc)
            injected += inj
        if cfg.no_ps > 0 and cfg.pspac > 0:
            lps = np.zeros((cfg.no_ps, nfreq), np.float32)
            for i, f in enumerate(cfg.file_pointsource):
                lps[i] = np.fromfile(f, np.float32, nfreq) * cfg.ps_scale[i]
            tabs, intf, esc, inj = simulate_point_sources(
                grid, medium, cfg, lps, tabs, intf, seed, lanes,
                per_freq_tally, freq_mask=freq_mask, roi=roi,
                physics_extra=physics_extra, ckpt=ckpt, domain=domain,
                pmesh=pmesh, host_tally=host_tally)
            escaped += np.asarray(esc)
            injected += inj
        if cfg.file_diffuse and (cfg.dfpac > 0 or cfg.clpac > 0):
            diffuserad = read_diffuse_field(cfg.file_diffuse, grid.cells)
            tabs, intf, esc, inj = simulate_diffuse(
                grid, medium, cfg, diffuserad, tabs, intf, seed + 5, lanes,
                per_freq_tally, freq_mask=freq_mask, roi=roi,
                physics_extra=physics_extra, ckpt=ckpt, domain=domain,
                pmesh=pmesh, host_tally=host_tally)
            escaped += np.asarray(esc)
            injected += inj
        if cfg.file_roi_load and cfg.roipac > 0:
            tabs, intf, esc, inj = simulate_roi_load(
                grid, medium, cfg, tabs, intf, seed + 9, lanes,
                per_freq_tally, freq_mask=freq_mask, pmesh=pmesh,
                host_tally=host_tally)
            escaped += np.asarray(esc)
            injected += inj
    ctabs = tabs
    if ckpt is not None:
        if pmesh is not None and per_freq_tally:
            intf_ck = np.asarray(pmesh.reduce_intf(intf))
        elif host_tally is not None:
            intf_ck = host_tally
        else:
            intf_ck = intf
        ckpt.flush(tabs, intf_ck,
                   roi=None if roi is None else roi["tally"])
    res.ctabs = np.asarray(ctabs)
    res.escaped = escaped
    res.injected = injected
    if write_files and cfg.file_constant_save:
        # CSAVE: bare float32 [CELLS] integrated constant heating
        # (ASOC.py:1547-1549)
        res.ctabs.astype(np.float32).tofile(cfg.file_constant_save)
    if write_files and roi is not None:
        from ..transport.roi import write_roi_file
        rnx, rny, rnz, _ = roi["dim"]
        write_roi_file(cfg.file_roi_save, rnx, rny, rnz, roi["nside"],
                       roi["tally"])
    timings["constant_sources"] = time.time() - t0

    # ---- libabs: write absorptions for the FSELECT frequencies only and
    # stop -- the library build (A2E_LIB) takes over from the file
    # (ASOC.py:63-65)
    if cfg.lib_abs:
        if per_freq_tally:
            if pmesh is not None:
                intf = pmesh.reduce_intf(intf)
            elif host_tally is not None:
                intf = host_tally
            fabs = _scaled_absorbed(grid, intf, cfg.gl * PARSEC,
                                    cfg.nnn_limit)
            res.absorbed = fabs
            if write_files and cfg.file_absorbed:
                sel = nearest_freq_mask(freq, cfg.fselect)
                write_cell_frequency_array(cfg.file_absorbed, fabs[:, sel])
        timings["total"] = time.time() - t_start
        return res

    # ---- phase 2: iterations (T solve + emission, optional self-heating)
    t0 = time.time()
    gl_cm = cfg.gl * PARSEC
    temperature = None
    emitted = None
    if not cfg.nosolve:
        table = equilibrium.build_temperature_table(freq, optics[0].abs_gl,
                                                    cfg.gl)
    # WITH_REFERENCE control variate: simulate only the CHANGE in emission
    # between iterations and carry the previous tally, with the reference
    # ramp k and .save continuation files (ASOC.py:1599-1633, 2251-2257).
    # WITH_REFERENCE == 1: plain ramp k = iteration/ITERATIONS within this
    # run. Values > 1 encode AABB: AA = total iterations over ALL runs,
    # BB = first iteration of THIS run -> k = (iteration+BB)/AA, and
    # OEMITTED/OTABS persist in OEMITTED.save / OTABS.save.
    wr = int(cfg.with_reference)
    wr_fir, wr_tot = 0, max(1, cfg.iterations)
    oemitted = None
    otabs = None
    if wr > 1:
        wr_fir = wr % 100
        wr_tot = max(1, wr // 100)
        if os.path.exists("OEMITTED.save") and os.path.exists("OTABS.save"):
            oemitted = jnp.asarray(np.fromfile(
                "OEMITTED.save", np.float32).reshape(grid.cells, nfreq))
            otabs = jnp.asarray(np.fromfile("OTABS.save", np.float32,
                                            grid.cells))
    oxab = None
    if cfg.with_ali and wr % 100 > 0 and os.path.exists("OXAB.save"):
        # continuation of the ALI accounting from a previous run
        oxab = np.fromfile("OXAB.save", np.float32, grid.cells)
    if not cfg.nosolve and cfg.has_key("SUBITERATIONS"):
        temperature, emitted, intf = _subiterations(
            cfg, grid, medium, optics, table, ctabs, intf, seed, lanes,
            per_freq_tally, physics_extra, freq, gl_cm, write_files,
            pmesh=pmesh, host_tally=host_tally)
    elif not cfg.nosolve:
        emit_total = ctabs
        xab = None
        it0 = 0
        if ckpt is not None:
            # phase-2 resume: jump past the last completed iteration
            # (counter-based RNG makes the continuation bit-identical)
            for kk in range(max(1, cfg.iterations) - 1, -1, -1):
                if ckpt.completed("iter%d" % kk) \
                        and ckpt.saved("it_emitted") is not None:
                    emitted = jnp.asarray(ckpt.saved("it_emitted"))
                    temperature = jnp.asarray(
                        ckpt.saved("it_temperature"))
                    emit_total = jnp.asarray(ckpt.saved("it_emit_total"))
                    if ckpt.saved("it_oemitted") is not None:
                        oemitted = jnp.asarray(ckpt.saved("it_oemitted"))
                        otabs = jnp.asarray(ckpt.saved("it_otabs"))
                    if ckpt.saved("it_oxab") is not None:
                        oxab = np.asarray(ckpt.saved("it_oxab"))
                    it0 = kk + 1
                    break
        for iteration in range(it0, max(1, cfg.iterations)):
            beta = 1.0
            # WITH_REFERENCE ramp (also scales the OXAB carry below)
            k = ((iteration + wr_fir) / float(wr_tot)) if wr > 1 \
                else (iteration / float(max(1, cfg.iterations)))
            if cfg.clpac > 0 and emitted is not None:
                # delta_sim: this iteration simulates only the CHANGE in
                # emission (captured BEFORE oemitted is reassigned below --
                # the OXAB carry must see the same condition as OTABS)
                delta_sim = bool(wr) and oemitted is not None
                if delta_sim:
                    oemitted = oemitted * np.float32(k)
                    otabs = otabs * np.float32(k)
                    sim_emit = jnp.asarray(emitted) - oemitted
                else:
                    sim_emit = emitted
                tabs_it = jnp.zeros(grid.cells, jnp.float32)
                if ckpt is not None \
                        and ckpt.saved("p2_tabs") is not None \
                        and any(d.startswith("it%d/" % iteration)
                                for d in ckpt.done):
                    # mid-sweep resume: the partial re-emission tally of
                    # THIS iteration's completed channels
                    tabs_it = jnp.asarray(ckpt.saved("p2_tabs"))
                tabs_it, intf, _, xab = simulate_cell_emission(
                    grid, medium, cfg, sim_emit, tabs_it, intf,
                    seed, lanes, per_freq_tally, iteration=iteration,
                    physics_extra=physics_extra, domain=domain,
                    pmesh=pmesh, host_tally=host_tally,
                    ckpt=None if pmesh is not None else ckpt)
                if delta_sim:
                    tabs_it = tabs_it + otabs
                if wr:
                    otabs = tabs_it
                    oemitted = jnp.asarray(emitted)
                emit_total = tabs_it + ctabs
                if cfg.with_ali and xab is not None:
                    # escape probability beta = (XEM - XAB)/XEM per cell.
                    # Under WITH_REFERENCE the simulation covered only the
                    # delta emission field, so restore the full-field XAB
                    # with the same k-ramped carry as OTABS above
                    # (ASOC.py:2251-2257 symmetry).
                    tw = np.asarray(medium.tw, np.float64)
                    xem = (np.asarray(emitted, np.float64) @ tw)
                    if oxab is not None and delta_sim:
                        oxab = oxab * np.float32(k)
                        xab = np.asarray(xab) + oxab
                    if wr:
                        oxab = np.asarray(xab)
                    beta_np = np.clip(
                        (xem - xab) / np.maximum(xem, 1e-30), 1e-2, 1.0)
                    beta_np[xem <= 0] = 1.0
                    beta = jnp.asarray(beta_np.astype(np.float32))
            t_prev = temperature         # previous iteration's field
            if pmesh is not None:
                from ..parallel import product
                temperature = product.solve_temperature(
                    pmesh, grid, table, emit_total, gl_cm, beta=beta,
                    cr_heating=cfg.cr_heating)
            else:
                temperature = equilibrium.solve_temperature(
                    grid, table, emit_total, gl_cm, beta=beta,
                    cr_heating=cfg.cr_heating)
            if cfg.has_key("alibeta") and cfg.with_ali \
                    and temperature is not None and t_prev is not None \
                    and not np.isscalar(beta):
                # optional beta(T, tau) spline refinement of the escape
                # probability (ASOC_aux.py:1446-1502; the reference builds
                # the interpolator but ships the refinement disabled):
                # beta *= beta(T_new, tau)/beta(T_old, tau) with T_old the
                # PREVIOUS iteration's temperature -- passing t_old=T_new
                # would make the correction identically 1
                from ..solve.ali import refine_beta
                beta2 = refine_beta(np.asarray(beta), np.asarray(temperature),
                                    freq, np.asarray(medium.abs_gl),
                                    np.asarray(grid.dens),
                                    t_old=np.asarray(t_prev))
                temperature = equilibrium.solve_temperature(
                    grid, table, emit_total, gl_cm,
                    beta=jnp.asarray(beta2), cr_heating=cfg.cr_heating)
            if pmesh is not None:
                from ..parallel import product
                emitted = product.emission(pmesh, freq, optics[0].abs_gl,
                                           temperature, gl_cm)
            else:
                emitted = equilibrium.emission(freq, optics[0].abs_gl,
                                               temperature, gl_cm)
            emitted = _apply_remit_band_dev(cfg, freq,
                                            jnp.asarray(emitted))
            if ckpt is not None and cfg.clpac > 0:
                # iteration-boundary snapshot: everything the next
                # iteration's body reads (SURVEY 5.4 -- phase 2 is as
                # long as phase 1 on big models; without cell packets
                # nothing iterates, so no snapshot)
                if pmesh is not None and per_freq_tally:
                    intf_ck = np.asarray(pmesh.reduce_intf(intf))
                elif host_tally is not None:
                    intf_ck = host_tally
                else:
                    intf_ck = np.asarray(intf)
                ckpt.record(
                    "iter%d" % iteration, 0.0, intf=intf_ck,
                    it_emitted=np.asarray(emitted),
                    it_temperature=np.asarray(temperature),
                    it_emit_total=np.asarray(emit_total),
                    it_oemitted=(np.asarray(oemitted)
                                 if oemitted is not None else None),
                    it_otabs=(np.asarray(otabs)
                              if otabs is not None else None),
                    it_oxab=(np.asarray(oxab)
                             if oxab is not None else None))
            if cfg.clpac <= 0:
                break   # nothing changes between iterations without CLPAC
        if write_files and wr > 1 and oemitted is not None:
            np.asarray(oemitted, np.float32).tofile("OEMITTED.save")
            np.asarray(otabs, np.float32).tofile("OTABS.save")
        if write_files and cfg.with_ali and xab is not None \
                and emitted is not None:
            tw = np.asarray(medium.tw, np.float64)
            np.asarray(xab, np.float32).tofile("OXAB.save")
            (np.asarray(emitted, np.float64) @ tw).astype(
                np.float32).tofile("OXEM.save")
    if temperature is not None:
        res.temperature = np.asarray(temperature)
        res.emitted = np.asarray(emitted)
    if pmesh is not None and per_freq_tally:
        # collapse the dp-partial frequency-sharded tallies for the
        # host-side intensity/absorbed outputs below
        intf = pmesh.reduce_intf(intf)
    elif host_tally is not None:
        intf = host_tally          # outputs below read host NumPy
    timings["solve"] = time.time() - t0
    t0 = time.time()

    # ---- intensity output for DustEM coupling (SAVE_INTENSITY modes,
    # ASOC.py:1496-1505, 2733-2760): I[cell,f] =
    # (PLANCK*FREQ/ABS_f)*8^level*INT/DENS; mode 2 additionally stores the
    # direction moments (Ix, Iy, Iz), normalized by the total intensity
    if per_freq_tally and cfg.save_intensity > 0:
        lev = np.asarray(equilibrium.cell_levels(grid))
        dens = np.asarray(grid.dens)
        absf = np.asarray(medium.abs_gl, np.float64)
        coeff = (PLANCK * np.asarray(freq, np.float64)[None, :]
                 / np.maximum(absf, 1e-300)[None, :]
                 * (8.0 ** lev)[:, None])
        raw = np.asarray(intf)
        if cfg.save_intensity == 2:
            with np.errstate(divide="ignore", invalid="ignore"):
                intensity = (coeff[:, :, None] * raw
                             / np.maximum(dens, 1e-35)[:, None, None])
            intensity[dens <= 0.0] = 0.0
            # IX/IY/IZ normalized with total intensity (ASOC.py:2735-2738)
            for k in (1, 2, 3):
                intensity[:, :, k] /= intensity[:, :, 0] + 1e-33
            if write_files:
                with open(cfg.file_intensity, "wb") as fp:
                    np.asarray([grid.cells, nfreq, 4], np.int32).tofile(fp)
                    intensity.astype(np.float32).tofile(fp)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                intensity = (coeff * raw
                             / np.maximum(dens, 1e-35)[:, None])
            intensity[dens <= 0.0] = 0.0
            if write_files:
                write_cell_frequency_array(cfg.file_intensity,
                                           intensity.astype(np.float32))

    # ---- absorbed-file output (reference end-of-run scaling)
    if per_freq_tally and not cfg.noabsorbed:
        if host_tally is not None:
            raw = intf[:, :, 0] if cfg.save_intensity == 2 else intf
            fabs = _scale_absorbed_inplace(grid, raw, gl_cm,
                                           cfg.nnn_limit)
            res.absorbed = fabs
            if write_files and cfg.file_absorbed:
                _write_cell_frequency_array_chunked(cfg.file_absorbed,
                                                    fabs)
        else:
            fabs = _scaled_absorbed(
                grid, intf[:, :, 0] if cfg.save_intensity == 2 else intf,
                gl_cm, cfg.nnn_limit)
            res.absorbed = fabs
            if write_files and cfg.file_absorbed:
                write_cell_frequency_array(cfg.file_absorbed, fabs)

    if write_files and temperature is not None and cfg.file_temperature:
        write_cell_field(cfg.file_temperature, grid, res.temperature)
    if write_files and emitted is not None and cfg.file_emitted:
        _write_emitted_file(cfg, freq, res.emitted)

    ext_cells = None
    if abu is not None:
        ext_cells = (abu @ (abs_d + sca_d)).astype(np.float32)
    timings["outputs"] = time.time() - t0
    # render from the DEVICE-resident emission field when phase 2 left
    # one (res.emitted is its host copy; re-uploading that would move
    # CELLS x NFREQ floats back over the host link for nothing)
    _render_phase(cfg, grid, medium, res, freq,
                  emitted if emitted is not None else res.emitted,
                  write_files, timings, ext_cells=ext_cells, pmesh=pmesh)
    timings["total"] = time.time() - t_start
    return res


def _subiterations(cfg, grid, medium, optics, table, ctabs, intf, seed,
                   lanes, per_freq_tally, physics_extra, freq, gl_cm,
                   write_files, pmesh=None, host_tally=None):
    """SUBITERATIONS: hot/cold cell splitting with the reference field
    (ASOC.py:2261-2420).

    Schedule over ITERATIONS rounds:
      0            : full simulation (all cells), no reference
      1            : COLD cells only, half budget -> PTABS (T not solved)
      2..N-2       : HOT cells only + reference field ramp
                     k = (it-2)/(N-3); total heating = TABS + OTABS + PTABS
      N-1          : full again (reference keeps only hot-cell emission)
    Cells are 'hot' when T >= 30 K (HOT_LIMIT), or per the user's
    external mask file (1 = emitting cell).
    """
    hot_limit = 30.0
    iters = max(4, cfg.iterations)
    external = None
    if cfg.file_external_mask:
        external = np.fromfile(cfg.file_external_mask, np.int32,
                               grid.cells) > 0
    oemitted = jnp.zeros((grid.cells, len(freq)), jnp.float32)
    otabs = jnp.zeros(grid.cells, jnp.float32)
    ptabs = jnp.zeros(grid.cells, jnp.float32)
    temperature = None
    emitted = None
    told = np.zeros(grid.cells, np.float32)
    cfg_it = cfg
    for iteration in range(iters):
        k = np.float32(np.clip((iteration - 2.0) / max(1.0, iters - 3.0),
                               0.0, 1.0))
        solve_t = True
        use_ptabs = False
        if iteration == 0:
            ignore = np.zeros(grid.cells, bool)
            oemitted = oemitted * 0
            otabs = otabs * 0
        elif iteration == 1:
            # simulate the COLD cells once -> PTABS; skip the T update
            ignore = (external if external is not None
                      else (told >= hot_limit))
            oemitted = oemitted * 0
            otabs = otabs * 0
            solve_t = False
        elif iteration == 2:
            ignore = (~external if external is not None
                      else (told < hot_limit))
            oemitted = oemitted * 0
            otabs = otabs * 0
            use_ptabs = True
        elif iteration == iters - 1:
            # final full iteration: drop cold cells from the reference
            cold = (~external if external is not None
                    else (told < hot_limit))
            oemitted = jnp.asarray(np.where(cold[:, None],
                                            0.0, np.asarray(oemitted)))
            ignore = np.zeros(grid.cells, bool)
        else:
            ignore = (~external if external is not None
                      else (told < hot_limit))
            use_ptabs = True
        oemitted = oemitted * k
        otabs = otabs * k

        if emitted is not None:
            sim_emit = jnp.asarray(emitted) - oemitted
            sim_emit = jnp.where(jnp.asarray(ignore)[:, None], 0.0,
                                 sim_emit)
            tabs_it = jnp.zeros(grid.cells, jnp.float32)
            tabs_it, intf, _, _ = simulate_cell_emission(
                grid, medium, cfg_it, sim_emit, tabs_it, intf, seed,
                lanes, per_freq_tally, iteration=iteration,
                physics_extra=physics_extra, pmesh=pmesh,
                host_tally=host_tally)
            if iteration == 1:
                ptabs = tabs_it
            else:
                tabs_it = tabs_it + otabs
                otabs = tabs_it
                oemitted = jnp.asarray(emitted)
                if iteration == iters - 1:
                    emit_total = tabs_it + ctabs      # no PTABS on the last
                elif use_ptabs:
                    emit_total = tabs_it + ptabs + ctabs
                else:
                    emit_total = tabs_it + ctabs
        else:
            emit_total = ctabs
        if solve_t:
            temperature = equilibrium.solve_temperature(
                grid, table, emit_total, gl_cm, cr_heating=cfg.cr_heating)
            told = np.asarray(temperature)
            emitted = equilibrium.emission(freq, optics[0].abs_gl,
                                           temperature, gl_cm)
            emitted = _apply_remit_band_dev(cfg, freq,
                                            jnp.asarray(emitted))
    return temperature, emitted, intf


def _write_polmap_fits(cfg, freq, stack, idir):
    """The reference's polmap product: one FITS per map-band frequency,
    'polmap_%.1f_%02d.fits' (um, direction) holding the [4, NY, NX]
    (I, Q, U, N) cube (ASOC.py:3798-3800). `stack` is [4, NF, NY, NX]."""
    from ..constants import f2um
    from ..io.fits import write_fits_image
    pix_deg = None
    if cfg.distance > 0:
        pix_deg = np.degrees(cfg.gl * cfg.map_dx / cfg.distance)
    band = map_freq_mask(cfg, freq)
    for ifq in np.nonzero(band)[0]:
        write_fits_image(
            "polmap_%.1f_%02d.fits" % (f2um(freq[ifq]), idir),
            stack[:, ifq], pix_deg=pix_deg)


def map_freq_mask(cfg, freq):
    """Map-frequency selection: the `wavelength` band, `mapum` single
    frequencies, or libmaps FSELECT (ASOC.py:3003-3075 selection logic)."""
    freq = np.asarray(freq)
    if cfg.lib_maps and cfg.fselect:
        return nearest_freq_mask(freq, cfg.fselect)
    if cfg.single_map_freq:
        return nearest_freq_mask(freq, cfg.single_map_freq)
    return (freq >= cfg.map_freq[0]) & (freq <= cfg.map_freq[1])


def _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                  timings, ext_cells=None, pmesh=None):
    """Phase 3: orthographic frequency-fused maps + polarization maps +
    tau/column-density/PSTau/POLSTAT outputs.

    ext_cells : optional [CELLS, NFREQ] per-cell extinction (WITH_ABU)."""
    t0 = time.time()
    gl_cm = cfg.gl * PARSEC
    thr_cell_w = None        # per-cell 0/1 weight for POLSTAT rho family
    if cfg.level_threshold > 0 and emitted is not None:
        # `threshold L` (LEVEL_THRESHOLD): maps exclude emission from
        # hierarchy levels < L -- low-resolution regions contribute
        # extinction along the LOS but no surface brightness
        # (kernel_ASOC_map.c:825-839, 1102-1116, 1262-1266). Masking the
        # emission field here applies the rule to every renderer below
        # (ortho / healpix / perspective / hierarchy / polarization).
        from ..solve import equilibrium
        lev = np.asarray(equilibrium.cell_levels(grid))
        emitted = np.asarray(emitted).copy()
        emitted[lev < cfg.level_threshold] = 0.0
        thr_cell_w = jnp.asarray(
            (lev >= cfg.level_threshold).astype(np.float32))
    fsel = map_freq_mask(cfg, freq) if emitted is not None else None

    # savetau frequencies must be rendered even if outside the map band --
    # but must NOT leak extra planes into map_dir_XX.bin / res.maps, so the
    # user's map selection is remembered separately (map_of_sel below).
    # savetau belongs to the orthographic Mapping path (ASOC.py:3010-3075);
    # the healpix / perspective / MAP_HIER branches must not have their
    # frequency selection widened by it.
    ortho_maps = (cfg.fast_map < 999 and cfg.npix[1] > 0
                  and cfg.intobs[0] <= -1e7)
    savetau_idx = []
    map_sel = None if fsel is None else fsel.copy()
    if ortho_maps and cfg.file_savetau and cfg.savetau_freq \
            and fsel is not None:
        for fv in cfg.savetau_freq:
            if fv > 0:
                i = int(np.argmin(np.abs(np.asarray(freq) - fv)))
                fsel[i] = True
                savetau_idx.append(i)
            else:
                savetau_idx.append(-1)          # column density
    sel_of_full = {}
    if fsel is not None:
        for k, i in enumerate(np.nonzero(fsel)[0]):
            sel_of_full[int(i)] = k
    # selected-column indices belonging to the user's map band
    map_of_sel = None
    if fsel is not None and not np.array_equal(fsel, map_sel):
        map_of_sel = np.asarray([sel_of_full[int(i)]
                                 for i in np.nonzero(map_sel)[0]], int)

    if not cfg.nomap and emitted is not None and fsel.any():
        centre = cfg.mapcentre
        if centre[0] < -1e7:
            centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
        kk = render_mapping.map_scale_kk(cfg.gl)
        freq_s = np.asarray(freq)[fsel]
        roi_gate = (cfg.roi_map and cfg.roi is not None
                    and cfg.fast_map < 999)
        # ROI_MAP (`roimap`): the Mapping/HealpixMapping kernels add
        # emission only from cells whose root ancestor lies in the
        # ROI box; extinction still comes from everything on the LOS
        # (kernel_ASOC_map.c:515-961 InRoi gate -- emission masking
        # is exactly that, since tau uses dens not emit). The hier
        # kernels have no ROI gate in the reference, hence the
        # fast_map<999 condition.
        if isinstance(emitted, jax.Array) and len(emitted.devices()) == 1:
            # device-resident emission field: select + scale per channel
            # ON DEVICE. The old host detour (float64 cast, host product,
            # float32 re-upload) moved 2 x CELLS x NFREQ floats over the
            # host link -- ~6 GB and most of the maps-phase wall time at
            # 16.8M cells
            scale = jnp.asarray((kk * freq_s).astype(np.float32))
            if bool(fsel.all()):
                emit_map = emitted.astype(jnp.float32) * scale[None, :]
            else:
                sel_idx = jnp.asarray(np.nonzero(fsel)[0], jnp.int32)
                emit_map = (jnp.take(emitted, sel_idx, axis=1)
                            .astype(jnp.float32) * scale[None, :])
            if roi_gate:
                from ..transport.roi import roi_cell_mask
                emit_map = emit_map * jnp.asarray(
                    roi_cell_mask(grid, cfg.roi)
                    .astype(np.float32))[:, None]
        else:
            map_emitted = np.asarray(emitted, np.float64)
            if roi_gate:
                from ..transport.roi import roi_cell_mask
                map_emitted = map_emitted.copy()
                map_emitted[~roi_cell_mask(grid, cfg.roi)] = 0.0
            emit_map = jnp.asarray(
                (map_emitted[:, fsel]
                 * (kk * freq_s)[None, :]).astype(np.float32))
        if ext_cells is not None:
            ext_gl = jnp.asarray(ext_cells[:, fsel])
        else:
            ext_gl = jnp.asarray((np.asarray(medium.abs_gl)
                                  + np.asarray(medium.sca_gl))[fsel])
        if cfg.fast_map >= 999 and cfg.npix[1] <= 0:
            # MAP_HIER + healpix (`mapping NSIDE -1 dx` with
            # FAST_MAP>=999): per-level all-sky maps from the internal
            # observer (ASOC.py:3332 selects map_H.c HealpixMapping;
            # NDIR is the ini's direction count but every direction
            # writes the same all-sky product, so one file per idir
            # like the reference). Header [NSIDE, NPIX.y] + [NF, LEVELS]
            # then float32 [NF, LEVELS, 12 NSIDE^2].
            nside_h = int(cfg.npix[0])
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            phot, _, _ = render_mapping.render_healpix_hier(
                grid, emit_map, ext_gl, intobs, nside_h)
            hier = np.transpose(np.asarray(phot), (1, 0, 2))
            for idir in range(len(cfg.obs_theta)):
                res.maps[("hier_hp", idir)] = hier
                if write_files:
                    with open("map_dir_%02d_H.bin" % idir, "wb") as fp:
                        np.asarray(cfg.npix, np.int32).tofile(fp)
                        np.asarray([hier.shape[0], grid.levels],
                                   np.int32).tofile(fp)
                        hier.astype(np.float32).tofile(fp)
        elif cfg.fast_map >= 999:
            # MAP_HIER: per-hierarchy-level maps, map_dir_XX_H.bin
            # (ASOC.py:3323-3438): [NX, NY] + [NF, LEVELS] int32 headers,
            # then float32 [NF, LEVELS, NY, NX]
            for idir in range(len(cfg.obs_theta)):
                odir, ra, de = render_mapping.observer_basis(
                    cfg.obs_theta[idir], cfg.obs_phi[idir])
                phot = render_mapping.render_ortho_hier(
                    grid, emit_map, ext_gl, jnp.asarray(odir),
                    jnp.asarray(ra), jnp.asarray(de), centre, cfg.map_dx,
                    tuple(cfg.npix))
                hier = np.transpose(np.asarray(phot), (1, 0, 2, 3))
                res.maps[("hier", idir)] = hier
                if write_files:
                    with open("map_dir_%02d_H.bin" % idir, "wb") as fp:
                        np.asarray(cfg.npix, np.int32).tofile(fp)
                        np.asarray([hier.shape[0], grid.levels],
                                   np.int32).tofile(fp)
                        hier.astype(np.float32).tofile(fp)
        elif cfg.npix[1] <= 0:
            # all-sky Healpix map around the internal observer
            # (NPIX.x == NSIDE; reference writes headerless map.healpix)
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            phot, tau, colden = render_mapping.render_healpix(
                grid, emit_map, ext_gl, intobs, int(cfg.npix[0]),
                interpolate=int(cfg.interpolate))
            res.maps[0] = np.asarray(phot)
            res.tau_maps[0] = np.asarray(tau)
            if write_files:
                res.maps[0].astype(np.float32).tofile("map.healpix")
        elif cfg.intobs[0] > -1e7:
            # perspective panorama from inside the model
            phot, tau, colden = render_mapping.render_perspective(
                grid, emit_map, ext_gl, cfg.intobs, tuple(cfg.npix))
            res.maps[0] = np.asarray(phot)
            res.tau_maps[0] = np.asarray(tau)
            if write_files:
                write_map_file("map_dir_00.bin", res.maps[0])
        else:
            # `devices N`: pixel rows shard over dp and channels over freq
            # for the plain orthographic case (shear/interpolation modes
            # fall back to the replicated render -- identical output)
            import jax as _jax
            shard_maps = (
                pmesh is not None and cfg.y_shear == 0.0
                and int(cfg.map_interpolation) == 0 and ext_cells is None
                and cfg.maxlos >= 1e9 and _jax.process_count() == 1
                and cfg.npix[1] % pmesh.n_dp == 0
                and int(np.sum(fsel)) % pmesh.n_freq == 0)
            # sub-phase attribution: prep = emit_map assembly etc.,
            # render = the per-direction render + map downloads
            timings["maps_prep"] = time.time() - t0
            for idir in range(len(cfg.obs_theta)):
                t_dir = time.time()
                odir, ra, de = render_mapping.observer_basis(
                    cfg.obs_theta[idir], cfg.obs_phi[idir])
                if shard_maps:
                    from ..parallel.mesh import sharded_render_ortho
                    phot, tau, colden = sharded_render_ortho(
                        grid, emit_map, ext_gl, jnp.asarray(odir),
                        jnp.asarray(ra), jnp.asarray(de),
                        jnp.asarray(centre, jnp.float32), cfg.map_dx,
                        tuple(cfg.npix), pmesh.mesh)
                else:
                    phot, tau, colden = render_mapping.render_ortho(
                        grid, emit_map, ext_gl, jnp.asarray(odir),
                        jnp.asarray(ra), jnp.asarray(de), centre, cfg.map_dx,
                        tuple(cfg.npix),
                        use_shear=cfg.y_shear != 0.0, y_shear=cfg.y_shear,
                        maxlos=cfg.maxlos,
                        map_interp=int(cfg.map_interpolation))
                phot_np, tau_np = np.asarray(phot), np.asarray(tau)
                timings["maps_render"] = (timings.get("maps_render", 0.0)
                                          + time.time() - t_dir)
                res.maps[idir] = (phot_np if map_of_sel is None
                                  else phot_np[map_of_sel])
                res.tau_maps[idir] = tau_np
                res.maps[("colden", idir)] = np.asarray(colden)
                if write_files:
                    write_map_file("map_dir_%02d.bin" % idir, res.maps[idir])
                    if cfg.fits > 0:
                        # reference FITS mode (ASOC.py:3142-3147): ONE
                        # file per frequency, '<prefix>_<um>[_NNN].fits',
                        # WCS centred at (FITS_RA, FITS_DE) with pixel
                        # scale GL*MAP_DX/distance (1 kpc fallback)
                        from ..io.fits import write_fits_image
                        from ..constants import f2um
                        dist = cfg.distance if cfg.distance > 0 else 1000.0
                        pix_deg = np.degrees(cfg.gl * cfg.map_dx / dist)
                        fmaps = (freq_s if map_of_sel is None
                                 else freq_s[map_of_sel])
                        ndir = len(cfg.obs_theta)
                        for k, f0 in enumerate(np.atleast_1d(fmaps)):
                            um = f2um(f0)
                            ums = ("%.0f" % um if um > 20.0 else
                                   "%.1f" % um if um > 2.0 else
                                   "%.2f" % um)
                            name = ("%s_%s.fits" % (cfg.fits_prefix, ums)
                                    if ndir == 1 else
                                    "%s_%s_%03d.fits"
                                    % (cfg.fits_prefix, ums, idir))
                            write_fits_image(
                                name, res.maps[idir][k],
                                ra_deg=cfg.fits_ra, de_deg=cfg.fits_de,
                                pix_deg=pix_deg)
                if cfg.file_savetau and savetau_idx:
                    # savetau: tau map at the requested frequency, or
                    # column density [cm^-2] for negative um arguments;
                    # file "%s.%d" % (file_savetau, idir)
                    # (ASOC.py:3010-3075, 3420-3434)
                    for k, idx in enumerate(savetau_idx):
                        if idx < 0:
                            payload = np.asarray(colden) * gl_cm
                        else:
                            payload = res.tau_maps[idir][sel_of_full[idx]]
                        suffix = ("" if len(savetau_idx) == 1
                                  else "_%d" % k)
                        name = "%s%s.%d" % (cfg.file_savetau, suffix, idir)
                        res.maps[("savetau", idir, k)] = payload
                        if write_files:
                            with open(name, "wb") as fp:
                                np.asarray(cfg.npix,
                                           np.int32).tofile(fp)
                                payload.astype(np.float32).tofile(fp)
                        if write_files and cfg.fits > 0:
                            # FITS-mode companions with the reference's
                            # names: '<savetau>_colden[_dirN][_NNN].fits'
                            # / '<savetau>_tau_<um>[_dirN][_NNN].fits'
                            # (ASOC.py:3123-3124,3157-3170 -- NDIR>1
                            # carries BOTH the _dirN tag and the _NNN
                            # index, a reference quirk kept verbatim)
                            from ..io.fits import write_fits_image
                            from ..constants import f2um
                            ndir = len(cfg.obs_theta)
                            dtag = "" if ndir == 1 else "_dir%d" % idir
                            if idx < 0:
                                base = "%s_colden%s" % (cfg.file_savetau,
                                                        dtag)
                                unit = "cm-2"
                            else:
                                um = f2um(freq[idx])
                                ums = ("%.0f" % um if um > 20.0 else
                                       "%.1f" % um if um > 2.0 else
                                       "%.2f" % um)
                                base = "%s_tau_%s%s" % (cfg.file_savetau,
                                                        ums, dtag)
                                unit = "tau"
                            fname = ("%s.fits" % base if ndir == 1
                                     else "%s_%03d.fits" % (base, idir))
                            dist = (cfg.distance if cfg.distance > 0
                                    else 1000.0)
                            write_fits_image(
                                fname, payload, ra_deg=cfg.fits_ra,
                                de_deg=cfg.fits_de,
                                pix_deg=np.degrees(cfg.gl * cfg.map_dx
                                                   / dist),
                                bunit=unit)

    # ---- PSTau: column density + optical depth from each point source
    # toward the observer (ASOC.py:3631-3650, text output "%s_%d.dat")
    if cfg.file_pssavetau and cfg.no_ps > 0:
        # per-cell WITH_ABU extinction when abundances vary
        ext_all = jnp.asarray(ext_cells) if ext_cells is not None \
            else jnp.asarray(np.asarray(medium.abs_gl)
                             + np.asarray(medium.sca_gl))
        itau = int(np.argmin(np.abs(np.asarray(freq)
                                    - max(cfg.pssavetau_freq, 0.0))))
        for idir in range(len(cfg.obs_theta)):
            odir, _, _ = render_mapping.observer_basis(
                cfg.obs_theta[idir], cfg.obs_phi[idir])
            tau, colden = render_mapping.render_pstau(
                grid, ext_all, jnp.asarray(cfg.ps_pos, jnp.float32),
                jnp.asarray(odir))
            tau = np.asarray(tau)
            colden_cm = np.asarray(colden) * gl_cm
            res.maps[("pstau", idir)] = (colden_cm, tau[:, itau])
            if write_files:
                with open("%s_%d.dat" % (cfg.file_pssavetau, idir),
                          "w") as fp:
                    for i in range(cfg.no_ps):
                        fp.write("%6d  %12.4e  %12.4e\n"
                                 % (i, colden_cm[i], tau[i, itau]))

    # ---- polarization maps: Stokes I/Q/U (POLSTAT 0) or LOS statistics
    # (POLSTAT 1/3), reference PolMapping variants
    if cfg.polmap > 0 and emitted is not None and len(cfg.b_files) == 3:
        from ..io.cloud import read_hierarchy
        from ..render.polarization import render_pol, render_polstat
        bvec = []
        for bf in cfg.b_files:
            _, _, _, _, vals = read_hierarchy(bf)
            bvec.append(np.concatenate(vals))
        bfield = jnp.asarray(np.stack(bvec, -1).astype(np.float32))
        centre = cfg.mapcentre
        if centre[0] < -1e7:
            centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
        kk = render_mapping.map_scale_kk(cfg.gl)
        emit_map = jnp.asarray((np.asarray(emitted, np.float64)
                                * (kk * freq)[None, :]).astype(np.float32))
        # per-cell WITH_ABU extinction when abundances vary (the
        # reference's pol kernels read the same GOPT arrays as Mapping)
        ext_gl = jnp.asarray(ext_cells) if ext_cells is not None \
            else jnp.asarray(np.asarray(medium.abs_gl)
                             + np.asarray(medium.sca_gl))
        polred = len(cfg.file_polred) > 0
        if (cfg.polstat > 0
                and (cfg.intobs[0] > -1e7 or cfg.npix[1] <= 0)):
            # healpix POLSTAT statistics maps: polmap + polstat>0 +
            # NPIX.y<0 (ASOC.py:3807-3894, kernel_ASOC_map_H.c:867) --
            # all-sky rhoTheta/rhoGamma/jTheta/jGamma planes
            from ..render.polarization import render_polstat_healpix
            nside_p = int(cfg.npix[0])
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            stats = render_polstat_healpix(
                grid, emit_map, ext_gl, bfield,
                jnp.asarray(intobs, jnp.float32), nside_p, polred=polred,
                maxlos=cfg.maxlos,
                use_shear=cfg.y_shear != 0.0, y_shear=cfg.y_shear)
            nf = len(freq)
            npx = 12 * nside_p * nside_p
            stack = np.stack([
                np.broadcast_to(np.asarray(stats["rT"])[None], (nf, npx)),
                np.broadcast_to(np.asarray(stats["rI"])[None], (nf, npx)),
                np.asarray(stats["jT"]), np.asarray(stats["jI"])])
            res.maps[("polstat_hp", 0)] = stack
            if write_files:
                with open("pol_healpix.bin", "wb") as fp:
                    np.asarray([nside_p, nf], np.int32).tofile(fp)
                    stack.astype(np.float32).tofile(fp)
                from ..io.fits import write_healpix_map
                band = map_freq_mask(cfg, freq)
                for ifq in np.nonzero(band)[0]:
                    write_healpix_map(
                        "pol_healpix.fits.%d" % ifq,
                        tuple(stack[k, ifq] for k in range(4)), nside_p,
                        column_names=("rhoTheta", "rhoGamma", "jTheta",
                                      "jGamma"))
            timings["maps"] = time.time() - t0
            return
        if cfg.intobs[0] > -1e7 or cfg.npix[1] <= 0:
            # internal observer: all-sky polarization healpix maps
            # (PolHealpixMapping, kernel_ASOC_map_H.c:576-867); written as
            # pol_healpix.bin = int32 [NSIDE, NF] + float32 [4, NF, NPIX]
            # (I, Q, U, N) -- the binary stand-in for the reference's
            # healpy.write_map FITS series (ASOC.py:3948-3958)
            from ..render.polarization import render_pol_healpix
            nside_p = int(cfg.npix[0])
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            s_i, s_q, s_u, colden = render_pol_healpix(
                grid, emit_map, ext_gl, bfield, cfg.p0,
                jnp.asarray(intobs, jnp.float32), nside_p, polred=polred,
                maxlos=cfg.maxlos, minlos=cfg.minlos,
                interpolate=int(cfg.interpolate))
            res.maps[("pol_hp", 0)] = (np.asarray(s_i), np.asarray(s_q),
                                       np.asarray(s_u), np.asarray(colden))
            if write_files:
                nf = len(freq)
                npx = 12 * nside_p * nside_p
                colden_cm = np.asarray(colden) * gl_cm
                stack = np.stack([np.asarray(s_i), np.asarray(s_q),
                                  np.asarray(s_u),
                                  np.broadcast_to(colden_cm[None],
                                                  (nf, npx))])
                with open("pol_healpix.bin", "wb") as fp:
                    np.asarray([nside_p, nf], np.int32).tofile(fp)
                    stack.astype(np.float32).tofile(fp)
                # the reference's product: one healpy FITS per frequency,
                # 'pol_healpix.fits.%d' with I/Q/U/N columns
                # (ASOC.py:3948-3958); written for the map-band channels
                from ..io.fits import write_healpix_map
                band = map_freq_mask(cfg, freq)
                for ifq in np.nonzero(band)[0]:
                    write_healpix_map(
                        "pol_healpix.fits.%d" % ifq,
                        (stack[0, ifq], stack[1, ifq], stack[2, ifq],
                         stack[3, ifq]), nside_p)
            timings["maps"] = time.time() - t0
            return
        for idir in range(len(cfg.obs_theta)):
            odir, ra, de = render_mapping.observer_basis(
                cfg.obs_theta[idir], cfg.obs_phi[idir])
            if cfg.polstat == 2:
                # POLSTAT 2: I,Q,U,N with periodic cube replication and
                # LOS capped at maxlos (ASOC.py:3662; polmap ... maxlos)
                s_i, s_q, s_u, colden = render_pol(
                    grid, emit_map, ext_gl, bfield, cfg.p0,
                    jnp.asarray(odir), jnp.asarray(ra), jnp.asarray(de),
                    centre, cfg.map_dx, tuple(cfg.npix), polred=polred,
                    rho_weight=cfg.pol_rho_weight, use_shear=True,
                    y_shear=cfg.y_shear, maxlos=cfg.maxlos,
                    minlos=cfg.minlos)
                res.maps[("pol", idir)] = (np.asarray(s_i),
                                           np.asarray(s_q),
                                           np.asarray(s_u),
                                           np.asarray(colden))
                if write_files:
                    nf = len(freq)
                    colden_cm = np.asarray(colden) * gl_cm
                    stack = np.stack(
                        [np.asarray(s_i), np.asarray(s_q), np.asarray(s_u),
                         np.broadcast_to(colden_cm[None],
                                         (nf,) + colden.shape)])
                    stack.astype(np.float32).tofile(
                        "polmap_dir_%02d.bin" % idir)
                    _write_polmap_fits(cfg, freq, stack, idir)
                continue
            if cfg.polstat > 0:
                # POLSTAT 1: rT, rI, jT, jI -- BOTH weighting families
                # (density- and emission-weighted angle dispersion /
                # inclination) in one run, written per map-band frequency
                # as the reference's polmap FITS planes (ASOC.py:3659,
                # kernel_ASOC_map.c:1164-1384). POLSTAT 3: <B>, <B_LOS>,
                # <B_POS>, tau from the same march (:1594-1693); the
                # legacy polstat_dir_XX.bin keeps [7, NY, NX] =
                # rT, rI, B, B_LOS, B_POS, tau, N.
                stats = render_polstat(
                    grid, emit_map, ext_gl, bfield, jnp.asarray(odir),
                    jnp.asarray(ra), jnp.asarray(de), centre, cfg.map_dx,
                    tuple(cfg.npix), polred=polred, cell_w=thr_cell_w)
                order = ("rT", "rI", "B", "B_LOS", "B_POS", "tau",
                         "colden")
                stack = np.stack([np.asarray(stats[k]) for k in order])
                stack[6] *= gl_cm
                res.maps[("polstat", idir)] = stack
                four = np.stack([
                    np.broadcast_to(np.asarray(stats["rT"])[None],
                                    np.asarray(stats["jT"]).shape),
                    np.broadcast_to(np.asarray(stats["rI"])[None],
                                    np.asarray(stats["jI"]).shape),
                    np.asarray(stats["jT"]), np.asarray(stats["jI"])])
                res.maps[("polstat4", idir)] = four
                if write_files:
                    with open("polstat_dir_%02d.bin" % idir, "wb") as fp:
                        np.asarray(cfg.npix, np.int32).tofile(fp)
                        stack.astype(np.float32).tofile(fp)
                    if cfg.polstat == 1:
                        _write_polmap_fits(cfg, freq, four, idir)
                continue
            s_i, s_q, s_u, colden = render_pol(
                grid, emit_map, ext_gl, bfield, cfg.p0, jnp.asarray(odir),
                jnp.asarray(ra), jnp.asarray(de), centre, cfg.map_dx,
                tuple(cfg.npix), polred=polred,
                rho_weight=cfg.pol_rho_weight, maxlos=cfg.maxlos,
                minlos=cfg.minlos)
            res.maps[("pol", idir)] = (np.asarray(s_i), np.asarray(s_q),
                                       np.asarray(s_u), np.asarray(colden))
            if write_files:
                # binary fallback of the reference's polmap FITS output:
                # [4, NF, NY, NX] float32 = I, Q, U, N(broadcast)
                nf = len(freq)
                colden_cm = np.asarray(colden) * gl_cm
                stack = np.stack([np.asarray(s_i), np.asarray(s_q),
                                  np.asarray(s_u),
                                  np.broadcast_to(colden_cm[None],
                                                  (nf,) + colden.shape)])
                stack.astype(np.float32).tofile("polmap_dir_%02d.bin" % idir)
                _write_polmap_fits(cfg, freq, stack, idir)
    timings["maps"] = time.time() - t0

