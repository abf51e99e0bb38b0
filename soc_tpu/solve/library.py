"""Library-accelerated emission: binned lookup over reference absorptions.

The reference's A2E_LIB (create_library_2 / solve_with_library_2 +
kernel_tree3.c) bins cells by their log-absorptions at three reference
frequencies into a 3-level tree of emission vectors, then answers subsequent
emission solves with an O(1) per-cell lookup. The "tree" is a sparse encoding
of a 3-D binning; here the binning is materialized as a dense
[NB, NB, NB, NFREQ] grid (a few hundred MB at most) with
nearest-occupied-bin hole filling (the role of kernel_tree3's Interpolate /
Fill), which maps onto the device as pure gathers.

Workflow (reference ASOC.py libabs/libmaps + A2E_LIB):
  1. full A2E solve once -> (absorbed, emitted) training pairs
  2. build_library() bins them
  3. later runs simulate only the reference frequencies (libabs) and call
     solve_with_library() for the full emission spectra.
"""

import pickle

import numpy as np


def choose_reference_frequencies(freq, um=(0.55, 2.2, 25.0)):
    """Default reference wavelengths (um) -> nearest frequency indices."""
    from ..constants import um2f
    return [int(np.argmin(np.abs(freq - um2f(u)))) for u in um]


def build_library(absorbed, emitted, ref_indices, nbins=64, eps=1e-33):
    """Bin cells by log10 absorptions at the reference frequencies.

    absorbed : [CELLS, NFREQ_ABS]; emitted : [CELLS, NFREQ]
    Returns a library dict.
    """
    ref = np.log10(np.maximum(
        np.asarray(absorbed, np.float64)[:, ref_indices], eps))
    lo = ref.min(axis=0)
    hi = ref.max(axis=0)
    span = np.maximum(hi - lo, 1e-10)
    idx = np.clip(((ref - lo) / span * (nbins - 1)).round().astype(np.int64),
                  0, nbins - 1)
    flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
    nf = emitted.shape[1]
    sums = np.zeros((nbins ** 3, nf), np.float64)
    counts = np.zeros(nbins ** 3, np.int64)
    np.add.at(sums, flat, np.asarray(emitted, np.float64))
    np.add.at(counts, flat, 1)
    occupied = counts > 0
    mean = np.zeros_like(sums)
    mean[occupied] = sums[occupied] / counts[occupied, None]

    # hole filling: assign every empty bin its nearest occupied bin
    # (kernel_tree3 Interpolate/Fill role), via iterative 6-neighbour
    # dilation over the 3-D bin grid
    src = np.arange(nbins ** 3, dtype=np.int64)
    src[~occupied] = -1
    src3 = src.reshape(nbins, nbins, nbins)
    filled = occupied.reshape(nbins, nbins, nbins).copy()
    for _ in range(3 * nbins):
        if filled.all():
            break
        for axis in range(3):
            for shift in (1, -1):
                cand = np.roll(src3, shift, axis=axis)
                edge = [slice(None)] * 3
                edge[axis] = 0 if shift == 1 else nbins - 1
                cand[tuple(edge)] = -1
                take = (~filled) & (cand >= 0)
                src3[take] = cand[take]
                filled |= take
    lookup = src3.reshape(-1)
    lookup[lookup < 0] = np.nonzero(occupied)[0][0] if occupied.any() else 0

    return dict(ref_indices=list(ref_indices), nbins=int(nbins),
                lo=lo, span=span, mean=mean.astype(np.float32),
                lookup=lookup.astype(np.int64),
                occupancy=float(occupied.mean()))


def _device_table(lib):
    """Cached device arrays for the jitted lookup: the hole-filled
    emission table (mean pre-gathered through `lookup`, so the device
    does ONE gather per cell) + the bin transform constants."""
    dev = lib.get("_dev")
    if dev is None:
        import jax.numpy as jnp
        dev = lib["_dev"] = (
            jnp.asarray(lib["mean"][lib["lookup"]]),          # [NB^3, NF]
            jnp.asarray(lib["lo"].astype(np.float32)),
            jnp.asarray(lib["span"].astype(np.float32)))
    return dev


_LOOKUP_JIT = None


def _lookup_device(table, lo, span, absorbed_ref, nbins, eps):
    # module-level jit: a closure-local jax.jit would key its cache on a
    # fresh function object every call and re-trace each invocation
    global _LOOKUP_JIT
    if _LOOKUP_JIT is None:
        import jax
        import jax.numpy as jnp
        from functools import partial

        @partial(jax.jit, static_argnames=("nbins",))
        def run(table, lo, span, aref, nbins, eps):
            ref = jnp.log10(jnp.maximum(aref, eps))
            idx = jnp.clip(jnp.round((ref - lo) / span
                                     * (nbins - 1)).astype(jnp.int32),
                           0, nbins - 1)
            flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
            return jnp.take(table, flat, axis=0)

        _LOOKUP_JIT = run
    import jax.numpy as jnp
    return _LOOKUP_JIT(table, lo, span, absorbed_ref, nbins,
                       jnp.float32(eps))


def solve_with_library(lib, absorbed, eps=1e-33, device=None):
    """Emission for [CELLS, NFREQ_ABS] absorptions via the binned lookup.

    device : None = auto (jitted on-device gather for large cell counts --
    the reference runs this as a kernel for ALL cells, kernel_SOC_lookup.c:4
    -- NumPy for tiny models where the dispatch would dominate); True/False
    forces a path. Both paths share the same bin transform; the device one
    computes it in float32 (an edge cell within float32 epsilon of a bin
    boundary may round to the neighbouring bin -- the hole-filled table
    makes both answers valid emission vectors).
    """
    nbins = lib["nbins"]
    cells = np.asarray(absorbed).shape[0]
    if device is None:
        device = cells >= (1 << 15)
    if device:
        import jax.numpy as jnp
        table, lo, span = _device_table(lib)
        aref = jnp.asarray(np.ascontiguousarray(
            np.asarray(absorbed, np.float32)[:, lib["ref_indices"]]))
        return _lookup_device(table, lo, span, aref, nbins, eps)
    ref = np.log10(np.maximum(
        np.asarray(absorbed, np.float64)[:, lib["ref_indices"]], eps))
    idx = np.clip(((ref - lib["lo"]) / lib["span"]
                   * (nbins - 1)).round().astype(np.int64), 0, nbins - 1)
    flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
    return lib["mean"][lib["lookup"][flat]]


def save_library(path, lib):
    with open(path, "wb") as fp:
        # "_"-prefixed keys are runtime caches (device arrays): not picklable
        pickle.dump({k: v for k, v in lib.items()
                     if not k.startswith("_")}, fp)


def load_library(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)
