"""Float64 reference of the A2E stochastic-heating solve.

A direct port of the reference's per-cell DoSolve loops (kernel_A2E.c:2-104):
the sparse integration weights are consumed band by band in file order, the
heating matrix is folded row by row and the populations come from the
forward substitution with its 1e-20 overflow rescale. Only the cell axis is
vectorised. It is independent of ``stochastic.solve_batch`` (no dense
weights, no cumulative sums) and is the oracle the device solve is
compared with.
"""

import numpy as np


def dosolve(solver, isize, absorbed):
    """Emission [cells, NFREQ] (float64) of one stochastic size for
    absorbed [cells, NFREQ]."""
    sd = solver.sizes[isize]
    ne, nfreq = solver.ne, solver.nfreq
    af = solver.sk_abs[isize].astype(np.float64) / solver.k_abs
    af = np.clip(af / (solver.s_frac[isize] * solver.grain_density),
                 1e-32, 1e100)
    absf = np.atleast_2d(np.asarray(absorbed, np.float64)) * af
    cells = absf.shape[0]
    L = np.zeros((cells, ne, ne))
    iw = np.asarray(sd.iw, np.float64)
    idx = 0
    for l in range(ne - 1):
        for u in range(l + 1, ne):
            a, b = sd.l1[l, u], sd.l2[l, u]
            if b < a or a < 0:
                continue
            acc = absf[:, a:b + 1] @ iw[idx:idx + b - a + 1]
            idx += b - a + 1
            L[:, u, l] = np.maximum(acc, 0.0)
    # fold: the bottom row is never added into the others
    for j in range(ne - 3, 0, -1):
        L[:, j, :j] += L[:, j + 1, :j]
    x = np.zeros((cells, ne))
    x[:, 0] = 1e-20
    for j in range(1, ne):
        s = np.einsum("ci,ci->c", L[:, j, :j], x[:, :j])
        x[:, j] = np.maximum(s / (sd.tdown[j] + 1e-30), 0.0)
        big = x[:, j] > 1e20
        x[big, : j + 1] *= 1e-20
    x /= x.sum(axis=1, keepdims=True)
    emit = np.zeros((cells, nfreq))
    for f in range(nfreq):
        i0 = sd.ibeg[f]
        emit[:, f] = x[:, i0:] @ np.asarray(sd.ea[f, i0:], np.float64)
    return emit


def solve_emission(solver, absorbed, aalg=None):
    """Sum of dosolve over every size (all treated as stochastic), and the
    alignment-weighted sum when aalg [cells] is given."""
    from .stochastic import alignment_weights
    emitted = 0.0
    pemitted = 0.0
    for isize in range(solver.nsize):
        em = dosolve(solver, isize, absorbed)
        emitted = emitted + em
        if aalg is not None:
            w = alignment_weights(solver, isize, np.asarray(aalg))
            pemitted = pemitted + em * w[:, None]
    if aalg is not None:
        return emitted, pemitted
    return emitted
