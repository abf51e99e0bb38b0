"""Stochastically-heated grain emission: the A2E solve on the device.

The reference's DoSolve kernel (kernel_A2E.c:2-104) builds, per cell and per
grain size, a lower-triangular heating-rate matrix from sparse integration
weights, folds it, and runs a forward substitution for the steady-state
energy-bin populations. Here the same math is recast into dense batched ops:

  1. heating matrix  A[b, u, l] = sum_f W[u, l, f] * (ABS[b, f] * AF[f])
     -- one dense [batch, NFREQ] x [NFREQ, NE*NE] matmul (W densified once
     per size at load; NE*NE*NFREQ floats ~ 12 MB)
  2. fold            B[b, j, l] = sum_{u=j}^{NE-2} A[b, u, l]  (j <= NE-2)
                     B[b, NE-1, l] = A[b, NE-1, l]
     -- a reversed cumulative sum (kernel_A2E.c:72-77 semantics: the bottom
     row is never folded into the others)
  3. forward substitution with progressive overflow rescale
     (kernel_A2E.c:80-89) -- lax.fori_loop over NE rows, vectorized over the
     cell batch
  4. emission        EMIT[b, f] = sum_i EA'[f, i] * X[b, i]
     -- one [batch, NE] x [NE, NFREQ] matmul; EA' has bins below Ibeg zeroed

Throughput target: >> the reference's ~7e3 cells/s (A2E.py:88-92).
"""

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .solver_file import densify_weights


def prepare_size_arrays(solver, isize):
    """Host-side per-size preprocessing -> device arrays for solve_batch.

    Results are cached on the solver object: the densify pass is a Python
    loop over NE^2 bands (~0.1 s per size) that would otherwise rerun on
    every iteration of the thermal solve."""
    cache = getattr(solver, "_prep_cache", None)
    if cache is None:
        cache = solver._prep_cache = {}
    if isize in cache:
        return cache[isize]
    sd = solver.sizes[isize]
    ne, nfreq = solver.ne, solver.nfreq
    w = densify_weights(sd, ne, nfreq)              # [NE, NE, NFREQ]
    # absorption fraction of this size (A2E.py:346-349)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = (np.asarray(solver.sk_abs[isize], np.float64)
              / np.asarray(solver.k_abs, np.float64))
        af = af / (solver.s_frac[isize] * solver.grain_density)
    af = np.clip(np.nan_to_num(af, nan=1e-32), 1e-32, 1e100).astype(np.float32)
    # fold AF into the weight matrix (same per-frequency product)
    w = w * af[None, None, :]
    # emission array with Ibeg masking folded in (kernel_A2E.c:96-100)
    ea = np.asarray(sd.ea, np.float32).copy()       # [NFREQ, NE]
    for f in range(nfreq):
        ea[f, : sd.ibeg[f]] = 0.0
    out = (jnp.asarray(w.reshape(ne * ne, nfreq)),
           jnp.asarray(sd.tdown),
           jnp.asarray(ea))
    cache[isize] = out
    return out


@partial(jax.jit, static_argnames=("ne",))
def solve_batch(w_flat, tdown, ea, absorbed, ne):
    """Steady-state emission for a batch of cells, one grain size.

    w_flat   : [NE*NE, NFREQ] dense heating weights (AF included)
    tdown    : [NE] cooling rates
    ea       : [NFREQ, NE] emission array (Ibeg-masked)
    absorbed : [batch, NFREQ] absorbed photons per cell
    Returns EMIT [batch, NFREQ].
    """
    batch, nfreq = absorbed.shape
    # 1. heating matrices
    a = jnp.maximum(
        jnp.dot(absorbed, w_flat.T,
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST), 0.0)
    a = a.reshape(batch, ne, ne)                    # [b, u, l]

    # 2. fold: reversed cumsum over u, excluding the bottom row for j<=NE-2
    s = jnp.cumsum(a[:, ::-1, :], axis=1)[:, ::-1, :]   # s[j] = sum_{u>=j} a
    b_mat = s - a[:, ne - 1: ne, :]                     # exclude bottom row
    b_mat = b_mat.at[:, ne - 1, :].set(a[:, ne - 1, :])

    # 3. forward substitution with overflow rescale
    tri_mask = (jax.lax.broadcasted_iota(jnp.int32, (ne, ne), 1)
                < jax.lax.broadcasted_iota(jnp.int32, (ne, ne), 0))
    b_mat = b_mat * tri_mask[None, :, :]            # keep i < j only
    x = jnp.zeros((batch, ne), jnp.float32).at[:, 0].set(1.0e-20)

    def row_step(j, x):
        s_j = jnp.einsum("bi,bi->b", b_mat[:, j, :], x,
                         precision=lax.Precision.HIGHEST)
        # clamp below float32 inf so the rescale can always recover
        x_j = jnp.clip(s_j / (tdown[j] + 1.0e-30), 0.0, 3.0e37)
        scale = jnp.where(x_j > 1.0e20, 1.0e-20, 1.0)
        x = x * scale[:, None]
        return x.at[:, j].set(x_j * scale)

    x = lax.fori_loop(1, ne, row_step, x)

    # 4. normalize + emission (sum floored: a fully-underflowed population
    # vector yields zero emission instead of NaN)
    x = x / jnp.maximum(jnp.sum(x, axis=1, keepdims=True), 1e-35)
    emit = jnp.dot(x, ea.T, preferred_element_type=jnp.float32,
                   precision=lax.Precision.HIGHEST)
    return emit


def solve_equilibrium_size(solver, isize, absorbed, gl=None, nip=5000):
    """Large grains above the stochastic cutoff: equilibrium treatment
    (A2E.py NSTOCH split; kernel_A2E.c:110-154 EqTemperature).

    absorbed : [cells, NFREQ]; returns EMIT [cells, NFREQ] for this size
    (already scaled by S_FRAC*GRAIN_DENSITY like the stochastic path).
    """
    from ..constants import EMIT_COEFF, FACTOR, H_K, PLANCK, planck_intensity
    if solver.s_frac[isize] <= 0.0:
        # a size bin with zero number fraction carries no grains: emission
        # is identically zero (dividing by s_frac would poison the Eout
        # integral with inf/NaN under the errstate suppression below)
        return np.zeros_like(np.asarray(absorbed, np.float32))
    freq = np.asarray(solver.freq, np.float64)
    # per-grain cross section
    with np.errstate(divide="ignore", invalid="ignore"):
        kabs = (np.asarray(solver.sk_abs[isize], np.float64)
                / (solver.grain_density * solver.s_frac[isize]))
        af = (np.asarray(solver.sk_abs[isize], np.float64)
              / np.asarray(solver.k_abs, np.float64))
        af = np.nan_to_num(af / (solver.s_frac[isize]
                                 * solver.grain_density), nan=1e-32)
    af = np.clip(af, 1e-32, 1e100)
    # E(T) lookup  (A2E.py equilibrium branch math)
    tgrid = np.logspace(np.log10(1.0), np.log10(2500.0), nip)
    # Eout(T) = FACTOR * 4 pi integral kabs B_nu(T) dnu  (trapezoid)
    bnu = planck_intensity(freq[None, :], tgrid[:, None])
    eout = FACTOR * 4.0 * np.pi * np.trapezoid(kabs[None, :] * bnu,
                                               freq, axis=1)

    absf = np.asarray(absorbed, np.float64) * af[None, :]
    # Ein = trapezoid of  ABS * h nu  (photons -> energy)
    ein = np.trapezoid(absf * (PLANCK * freq)[None, :], freq, axis=1)
    t = np.interp(ein, eout, tgrid)
    # emission per grain, scaled back up by S_FRAC*GRAIN_DENSITY
    coeff = EMIT_COEFF * FACTOR * solver.grain_density * \
        solver.s_frac[isize]
    x = np.clip(H_K * freq[None, :] / np.maximum(t[:, None], 1e-3), 1e-10, 500)
    emit = coeff * kabs[None, :] * freq[None, :] ** 2 / np.expm1(x)
    return emit.astype(np.float32)


def alignment_weights(solver, isize, aalg):
    """Per-cell fraction of this size's emission that is polarized: grains
    with a >= a_alg are aligned; between consecutive size bins a log-size
    interpolation applies (A2E.py:408-425 AALG handling)."""
    a = solver.size_a
    w = np.zeros(len(aalg), np.float32)
    w[a[isize] >= aalg] = 1.0
    if isize < solver.nsize - 1:
        m = (a[isize] < aalg) & (a[isize + 1] > aalg)
        w[m] = ((np.log10(aalg[m]) - np.log10(a[isize]))
                / (np.log10(a[isize + 1]) - np.log10(a[isize])))
    return w


def size_stacks(solver, n_stoch):
    """Device-resident prepare_size_arrays outputs of the first n_stoch
    sizes, stacked on a leading size axis: (w [S, NE*NE, NFREQ],
    tdown [S, NE], ea [S, NFREQ, NE]). Cached on the solver."""
    cache = getattr(solver, "_prep_cache", None)
    if cache is None:
        cache = solver._prep_cache = {}
    key = ("stack", n_stoch)
    if key not in cache:
        preps = [prepare_size_arrays(solver, i) for i in range(n_stoch)]
        cache[key] = tuple(jnp.stack([p[k] for p in preps])
                           for k in range(3))
    return cache[key]


@partial(jax.jit, static_argnames=("ne",))
def solve_all_chunks(w_stack, td_stack, ea_stack, chunks, align, ne):
    """Solve a superbatch of cell chunks for every stochastic size in one
    dispatch: lax.map over chunks, lax.scan over sizes, solve_batch in the
    body, so the working set is one chunk of one size.

    chunks : [nchunk, batch, NFREQ] absorbed photons
    align  : [nchunk, NSIZE, batch] per-size aligned fraction, or None to
             skip the polarized accumulator
    Returns (EMIT, PEMIT) of shape [nchunk, batch, NFREQ]; PEMIT is None
    when align is None.
    """
    def one(xs):
        chunk, al = xs

        def body(carry, size):
            tot, ptot = carry
            w, td, ea, a = size
            em = solve_batch(w, td, ea, chunk, ne)
            if a is not None:
                ptot = ptot + em * a[:, None]
            return (tot + em, ptot), None

        zero = jnp.zeros_like(chunk)
        (tot, ptot), _ = lax.scan(
            body, (zero, None if al is None else zero),
            (w_stack, td_stack, ea_stack, al))
        return tot, ptot

    return lax.map(one, (chunks, align))


@lru_cache(maxsize=None)
def _sharded_solver(devices, ne, with_align):
    from jax.sharding import Mesh, PartitionSpec as P
    cells = P("cells")
    al = cells if with_align else None
    return jax.jit(jax.shard_map(
        partial(solve_all_chunks, ne=ne),
        mesh=Mesh(np.asarray(devices), ("cells",)),
        in_specs=(P(), P(), P(), cells, al), out_specs=(cells, al),
        check_vma=False))


def solve_all_chunks_sharded(w_stack, td_stack, ea_stack, chunks, align,
                             ne):
    """solve_all_chunks with the chunk axis sharded over the local devices
    (under multi-host jax.distributed the inputs here are host-local, so
    every process solves on its own). Cells are independent, so the
    per-size arrays are replicated and no collective runs. nchunk must be
    a multiple of the device count."""
    devices = tuple(jax.local_devices())
    if chunks.shape[0] % len(devices):
        raise ValueError("nchunk %d is not a multiple of %d devices"
                         % (chunks.shape[0], len(devices)))
    return _sharded_solver(devices, ne, align is not None)(
        w_stack, td_stack, ea_stack, chunks, align)


def solve_emission(solver, absorbed, nstoch=999, batch=16384, clip_last=True,
                   aalg=None):
    """Full A2E solve: sum emission over all grain sizes.

    absorbed : [CELLS, NFREQ] (the absorbed.data payload)
    nstoch   : sizes >= nstoch are treated at equilibrium (A2E.py NSTOCH)
    batch    : cells per device chunk (smaller when there are fewer cells)
    aalg     : optional [CELLS] minimum aligned grain size (RAT alignment);
               when given, also returns the polarized emission PEMITTED
               (sizes >= a_alg per cell, the reference's emitted.data.P)
    Returns EMITTED [CELLS, NFREQ] float32 (, PEMITTED if aalg given).

    The stochastic sizes run on the device in superbatches of two chunks
    per local device (solve_all_chunks); the next superbatch is dispatched
    before the previous one is copied back.
    """
    cells, nfreq = absorbed.shape
    absorbed = np.asarray(absorbed, np.float32).copy()
    if clip_last and nfreq >= 2:
        # guard against spurious weight on the topmost channel (A2E.py:184)
        absorbed[:, -1] = np.clip(absorbed[:, -1], 0.0,
                                  0.2 * absorbed[:, -2])
    emitted = np.zeros((cells, nfreq), np.float32)
    pemitted = None if aalg is None else np.zeros((cells, nfreq), np.float32)
    n_stoch = min(nstoch, solver.nsize)
    if n_stoch > 0 and cells > 0:
        stacks = size_stacks(solver, n_stoch)
        align = None
        if aalg is not None:
            align = np.stack([alignment_weights(solver, i, np.asarray(aalg))
                              for i in range(n_stoch)])
        n_dev = len(jax.local_devices())
        # fewer cells than chunks: shrink the chunk (power of two, so the
        # number of compiled shapes stays small)
        per_dev = -(-cells // n_dev)
        batch = min(batch, 1 << max(3, (per_dev - 1).bit_length()))
        step = 2 * n_dev * batch

        def dispatch(s0, s1):
            nchunk = -(-(s1 - s0) // (n_dev * batch)) * n_dev
            pad = nchunk * batch - (s1 - s0)
            blk = np.pad(absorbed[s0:s1], ((0, pad), (0, 0)))
            al = None
            if align is not None:
                al = np.pad(align[:, s0:s1], ((0, 0), (0, pad)))
                al = jnp.asarray(np.ascontiguousarray(
                    al.reshape(n_stoch, nchunk, batch).swapaxes(0, 1)))
            blk = jnp.asarray(blk.reshape(nchunk, batch, nfreq))
            if n_dev > 1:
                return solve_all_chunks_sharded(*stacks, blk, al, solver.ne)
            return solve_all_chunks(*stacks, blk, al, solver.ne)

        def store(s0, s1, out):
            tot, ptot = out
            emitted[s0:s1] = np.asarray(tot).reshape(-1, nfreq)[: s1 - s0]
            if pemitted is not None:
                pemitted[s0:s1] = (np.asarray(ptot)
                                   .reshape(-1, nfreq)[: s1 - s0])

        pending = None
        for s0 in range(0, cells, step):
            s1 = min(s0 + step, cells)
            out = dispatch(s0, s1)
            if pending is not None:
                store(*pending)
            pending = (s0, s1, out)
        store(*pending)
    for isize in range(n_stoch, solver.nsize):
        emit_size = solve_equilibrium_size(solver, isize, absorbed)
        emitted += emit_size
        if pemitted is not None:
            w = alignment_weights(solver, isize, np.asarray(aalg))
            pemitted += emit_size * w[:, None]
    if pemitted is not None:
        return emitted, pemitted
    return emitted


def solve_emission_streaming(solver, absorbed_path, emitted_path,
                             nstoch=999, batch=None, aalg=None,
                             pemitted_path=None, ifreq=None):
    """Out-of-core A2E solve: stream absorbed.data through the device in
    prefetched chunks and write emitted.data in the background.

    The reference keeps both [CELLS, NFREQ] arrays memory-mapped
    (A2E.py:117-190); here neither file ever has to fit in host memory --
    the native double-buffered reader (soc_tpu.native) overlaps disk IO
    with the device solve. Results are identical to the in-memory
    solve_emission on the same chunks.

    ifreq : optional int -- write emission at this single frequency only
        (the reference A2E.py IFREQ argument, A2E.py:96-193: the emitted
        file gets ONE column).
    """
    from ..native import StreamReader, StreamWriter
    ncols = solver.nfreq if ifreq is None else 1
    if batch is None:
        # each solve_emission call waits for its last superbatch, so the
        # wait is amortized by making each stream chunk many superbatches
        # long: ~64 MB of rows per prefetch buffer, in whole 16384-row
        # solve chunks, >= 64k rows
        batch = max(1 << 16,
                    (64 << 20) // (solver.nfreq * 4) // 16384 * 16384)

    def sel(emit):
        return emit if ifreq is None else \
            np.ascontiguousarray(emit[:, ifreq:ifreq + 1])

    with StreamReader(absorbed_path, batch) as rd:
        # writers open inside the try: a failure opening the second one
        # must still close (flush) the first
        wr = wp = None
        row0 = 0
        try:
            wr = StreamWriter(emitted_path, rd.rows, ncols)
            if aalg is not None and pemitted_path:
                wp = StreamWriter(pemitted_path, rd.rows, ncols)
            for chunk in rd:
                if aalg is not None:
                    a_chunk = np.asarray(aalg)[row0: row0 + len(chunk)]
                    emit, pem = solve_emission(solver, chunk,
                                               nstoch=nstoch, aalg=a_chunk)
                    wr.put(sel(emit))
                    if wp is not None:
                        wp.put(sel(pem))
                else:
                    wr.put(sel(solve_emission(solver, chunk,
                                              nstoch=nstoch)))
                row0 += len(chunk)
        finally:
            if wr is not None:
                wr.close()
            if wp is not None:
                wp.close()
    return row0
