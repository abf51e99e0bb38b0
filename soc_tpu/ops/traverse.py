"""Jittable octree traversal: the geometric core of the transport engine.

A re-design of the reference's per-work-item traversal routines for XLA
(kernel_ASOC_aux.c: IndexG:131, Index:198, GetStep:282). Differences from the
OpenCL original:

* All functions are *vectorized over a lane axis* (N packets/rays at once);
  data-dependent while-loops become statically unrolled masked loops over the
  (small, static) number of hierarchy levels, so the whole step fuses into one
  XLA computation with gathers instead of divergent control flow.
* The hierarchy metadata (nx, ny, nz, levels) is Python-static, so jit
  specializes per model exactly like the reference's -D macro recompilation.
* Cell coordinates: a cell is identified by (level, ind) with ``ind`` local to
  the level; position is in level-local units (root: [0,NX]x[0,NY]x[0,NZ];
  deeper: octet coordinates in [0,2]^3). Parent cells store bit-cast child
  links in the density array; PEPS over-stepping keeps positions strictly
  inside the entered cell (float32 epsilon discipline of the reference).
"""

import jax.numpy as jnp
from jax import lax

from ..constants import PEPS

# plain numpy scalar: must not touch the backend at import time
import numpy as np

INVALID = np.int32(-1)


def _decode_link(dens_val):
    """Negated bit-cast float32 link -> int32 first-child (level-local) index."""
    return lax.bitcast_convert_type(-dens_val, jnp.int32)


def _suboct(pos):
    """Octet sub-cell id 0..7 from octet coordinates in [0,2]^3."""
    ix = jnp.floor(pos[..., 0]).astype(jnp.int32)
    iy = jnp.floor(pos[..., 1]).astype(jnp.int32)
    iz = jnp.floor(pos[..., 2]).astype(jnp.int32)
    return (4 * jnp.clip(iz, 0, 1) + 2 * jnp.clip(iy, 0, 1)
            + jnp.clip(ix, 0, 1))


def _root_index(pos, nx, ny, nz):
    ix = jnp.floor(pos[..., 0]).astype(jnp.int32)
    iy = jnp.floor(pos[..., 1]).astype(jnp.int32)
    iz = jnp.floor(pos[..., 2]).astype(jnp.int32)
    return iz * (nx * ny) + iy * nx + ix


def _outside_root(pos, nx, ny, nz):
    return ((pos[..., 0] <= 0.0) | (pos[..., 0] >= nx)
            | (pos[..., 1] <= 0.0) | (pos[..., 1] >= ny)
            | (pos[..., 2] <= 0.0) | (pos[..., 2] >= nz))


def _descend(grid, pos, level, ind, active):
    """Shared down-traversal: walk from a (possibly refined) cell to its leaf.

    pos is local to ``level``; cells whose density value is a link get their
    position rescaled into the child octet. Unrolled (levels-1) times.
    """
    for _ in range(grid.levels - 1):
        gidx = grid.off[level] + ind
        dval = grid.dens[jnp.clip(gidx, 0, grid.cells - 1)]
        go = active & (ind >= 0) & (dval <= 0.0)
        child = _decode_link(dval)
        new_pos = 2.0 * jnp.mod(pos, 1.0)
        new_ind = child + _suboct(new_pos)
        pos = jnp.where(go[..., None], new_pos, pos)
        ind = jnp.where(go, new_ind, ind)
        level = jnp.where(go, level + 1, level)
    return pos, level, ind


def index_global(grid, pos):
    """Global root-grid position -> (pos_local, level, ind). IndexG analog."""
    outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    ind = jnp.where(outside, INVALID, _root_index(pos, grid.nx, grid.ny, grid.nz))
    level = jnp.zeros_like(ind)
    pos, level, ind = _descend(grid, pos, level, ind, ~outside)
    return pos, level, ind


def index_update(grid, pos, level, ind, active):
    """Neighbor lookup after a boundary step. Index() analog.

    (level, ind) identify the cell the ray *was* in; pos has been moved just
    across its boundary (still in that level's local coordinates). Walk up the
    hierarchy until pos falls inside the current octet/root, then descend to
    the leaf. Returns (pos, level, ind) with ind == -1 for exited rays.
    """
    if grid.levels == 1:
        outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
        new_ind = jnp.where(outside, INVALID,
                            _root_index(pos, grid.nx, grid.ny, grid.nz))
        ind = jnp.where(active, new_ind, ind)
        return pos, level, ind

    # --- root-level lanes: direct handling
    at_root = active & (level == 0)
    outside0 = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    root_ind = _root_index(pos, grid.nx, grid.ny, grid.nz)
    ind = jnp.where(at_root, jnp.where(outside0, INVALID, root_ind), ind)
    # lanes done: exited, or landed in a root leaf (descend handles non-leaf)
    settled = at_root

    # --- up-walk for lanes at level > 0 (unrolled; masked)
    up = active & (level > 0)
    for _ in range(grid.levels - 1):
        gidx = grid.off[level] + ind
        parent = grid.par[jnp.clip(gidx, 0, grid.cells - 1)]
        plevel = level - 1
        # case A: parent is at root
        posA = 0.5 * pos
        posA = posA.at[..., 0].add((parent % grid.nx).astype(pos.dtype))
        posA = posA.at[..., 1].add(((parent // grid.nx) % grid.ny).astype(pos.dtype))
        posA = posA.at[..., 2].add((parent // (grid.nx * grid.ny)).astype(pos.dtype))
        outsideA = _outside_root(posA, grid.nx, grid.ny, grid.nz)
        indA = jnp.where(outsideA, INVALID,
                         _root_index(posA, grid.nx, grid.ny, grid.nz))
        # case B: parent is inside an octet at plevel > 0
        sid = parent % 8
        posB = 0.5 * pos
        posB = posB.at[..., 0].add((sid % 2).astype(pos.dtype))
        posB = posB.at[..., 1].add(((sid // 2) % 2).astype(pos.dtype))
        posB = posB.at[..., 2].add((sid // 4).astype(pos.dtype))
        insideB = ((posB[..., 0] >= 0.0) & (posB[..., 0] <= 2.0)
                   & (posB[..., 1] >= 0.0) & (posB[..., 1] <= 2.0)
                   & (posB[..., 2] >= 0.0) & (posB[..., 2] <= 2.0))
        indB = parent - sid + _suboct(posB)

        rootcase = up & (plevel == 0)
        octcase = up & (plevel > 0)
        pos = jnp.where(rootcase[..., None], posA,
                        jnp.where(octcase[..., None], posB, pos))
        ind = jnp.where(rootcase, indA,
                        jnp.where(octcase,
                                  jnp.where(insideB, indB, parent), ind))
        level = jnp.where(up, plevel, level)
        # settle: root lanes always settle; octet lanes settle if inside octet
        nowdone = rootcase | (octcase & insideB)
        settled = settled | nowdone
        up = up & ~nowdone & (level > 0)

    # --- descend to leaf for all lanes still pointing at refined cells
    pos, level, ind = _descend(grid, pos, level, ind, active & (ind >= 0))
    return pos, level, ind


# ---------------------------------------------------------------------------
# Ancestor-stack traversal: the hot-loop variant.
#
# index_update's up-walk reads the PAR array once per level -- on a 3-level
# grid that makes every transport step a chain of 5 serialized device-memory gathers
# (dens + 2x par + 2x descend), and the par gathers are pure latency: the
# parent's level-local index is fully determined by the lane's own descent
# history. Carrying that history -- anc[k] = the lane's ancestor index at
# level k -- turns the up-walk into ALU-only work (sub-octet ids come from
# ind % 8, positions from the stacked indices), leaving only the dens
# gathers of the down-walk.
#
# The stack is (levels-1) int32 per lane, maintained by the *_stack
# functions below; entries at k >= level are stale by construction.
# Lanes arriving without a history (source refill, domain exchange, split
# clones) rebuild it with stack_from_par -- par gathers there are amortized
# over a whole refill period.
# ---------------------------------------------------------------------------


def _anc_read(anc, level):
    """anc[lane, level] via one-hot contraction (levels is tiny/static)."""
    k = anc.shape[-1]
    onehot = (jnp.arange(k, dtype=jnp.int32)[None, :] == level[..., None])
    return jnp.sum(jnp.where(onehot, anc, 0), axis=-1)


def _anc_write(anc, level, value, mask):
    k = anc.shape[-1]
    onehot = (jnp.arange(k, dtype=jnp.int32)[None, :] == level[..., None])
    sel = onehot & mask[..., None]
    return jnp.where(sel, value[..., None], anc)


def stack_from_par(grid, level, ind):
    """Rebuild the ancestor stack of (level, ind) cells from the PAR array
    (used for lanes that arrive without a descent history)."""
    n = ind.shape[0]
    anc = jnp.zeros((n, max(grid.levels - 1, 1)), jnp.int32)
    lvl = level
    cur = ind
    for _ in range(grid.levels - 1):
        up = lvl > 0
        gidx = jnp.clip(grid.off[jnp.clip(lvl, 0, grid.levels - 1)] + cur,
                        0, grid.cells - 1)
        parent = grid.par[gidx]
        plevel = jnp.maximum(lvl - 1, 0)
        anc = _anc_write(anc, plevel, parent, up)
        cur = jnp.where(up, parent, cur)
        lvl = jnp.where(up, plevel, lvl)
    return anc


def _descend_stack(grid, pos, level, ind, anc, active):
    """_descend that also records the path: returns (pos, level, ind, anc)."""
    for _ in range(grid.levels - 1):
        gidx = grid.off[level] + ind
        dval = grid.dens[jnp.clip(gidx, 0, grid.cells - 1)]
        go = active & (ind >= 0) & (dval <= 0.0)
        child = _decode_link(dval)
        new_pos = 2.0 * jnp.mod(pos, 1.0)
        new_ind = child + _suboct(new_pos)
        anc = _anc_write(anc, level, ind, go)
        pos = jnp.where(go[..., None], new_pos, pos)
        ind = jnp.where(go, new_ind, ind)
        level = jnp.where(go, level + 1, level)
    return pos, level, ind, anc


def index_global_stack(grid, pos):
    """index_global that also returns the ancestor stack of the leaf."""
    outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    ind = jnp.where(outside, INVALID,
                    _root_index(pos, grid.nx, grid.ny, grid.nz))
    level = jnp.zeros_like(ind)
    anc = jnp.zeros(pos.shape[:-1] + (max(grid.levels - 1, 1),), jnp.int32)
    pos, level, ind, anc = _descend_stack(grid, pos, level, ind, anc,
                                          ~outside)
    return pos, level, ind, anc


def index_update_stack(grid, pos, level, ind, anc, active, descend=True):
    """index_update with an ALU-only up-walk driven by the ancestor stack.

    Semantics identical to index_update given a consistent stack; no PAR
    reads. Returns (pos, level, ind, anc).

    descend=False skips the final leaf descent: the returned cell may be a
    refined (link) cell. Callers using this DEFERRED-DESCENT protocol must
    test the cell's density value each step and descend one level at a
    time themselves (see transport.propagate: the already-needed density
    gather doubles as the link test, so a march step costs exactly one
    hierarchy gather instead of the levels-1 unrolled descent chain).
    """
    if grid.levels == 1:
        pos, level, ind = index_update(grid, pos, level, ind, active)
        return pos, level, ind, anc

    at_root = active & (level == 0)
    outside0 = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    root_ind = _root_index(pos, grid.nx, grid.ny, grid.nz)
    ind = jnp.where(at_root, jnp.where(outside0, INVALID, root_ind), ind)

    up = active & (level > 0)
    for _ in range(grid.levels - 1):
        plevel = level - 1
        parent = _anc_read(anc, jnp.maximum(plevel, 0))
        rootcase = plevel == 0
        # integer parent-cell coordinates in the parent frame, selected
        # BEFORE the float work (root: decoded root index; octet: sub-id
        # bits) -- one position update instead of the posA/posB pair
        sid = parent % 8
        px = jnp.where(rootcase, parent % grid.nx, sid % 2)
        py = jnp.where(rootcase, (parent // grid.nx) % grid.ny,
                       (sid // 2) % 2)
        pz = jnp.where(rootcase, parent // (grid.nx * grid.ny), sid // 4)
        coords = jnp.stack([px, py, pz], -1).astype(pos.dtype)
        npos = 0.5 * pos + coords
        hi = jnp.where(rootcase[..., None],
                       jnp.asarray([grid.nx, grid.ny, grid.nz],
                                   pos.dtype)[None, :],
                       jnp.asarray(2.0, pos.dtype))
        # bit-exact bounds of the two original tests: the root test is
        # exclusive (outside at == 0 / == n), the octet test inclusive
        ge = jnp.where(rootcase[..., None], npos > 0.0, npos >= 0.0)
        le = jnp.where(rootcase[..., None], npos < hi, npos <= hi)
        inside = jnp.all(ge & le, axis=-1)
        nind = jnp.where(rootcase,
                         jnp.where(inside,
                                   _root_index(npos, grid.nx, grid.ny,
                                               grid.nz), INVALID),
                         jnp.where(inside,
                                   parent - sid + _suboct(npos), parent))
        pos = jnp.where(up[..., None], npos, pos)
        ind = jnp.where(up, nind, ind)
        level = jnp.where(up, plevel, level)
        nowdone = up & (rootcase | inside)
        up = up & ~nowdone & (level > 0)

    if descend:
        pos, level, ind, anc = _descend_stack(grid, pos, level, ind, anc,
                                              active & (ind >= 0))
    return pos, level, ind, anc


def descend_one(grid, pos, level, ind, anc, dval, is_link):
    """One deferred-descent level: move lanes sitting on a link cell (their
    gathered density value ``dval`` <= 0) one level down. ALU-only -- the
    link test reuses the density gather the caller already paid for."""
    child = _decode_link(dval)
    dpos = 2.0 * jnp.mod(pos, 1.0)
    dind = child + _suboct(dpos)
    anc = _anc_write(anc, level, ind, is_link)
    pos = jnp.where(is_link[..., None], dpos, pos)
    ind = jnp.where(is_link, dind, ind)
    level = jnp.where(is_link, level + 1, level)
    return pos, level, ind, anc


def get_step_stack(grid, pos, dir, level, ind, anc, active):
    """get_step over the ancestor-stack state: no PAR gathers."""
    ds_local, new_pos = boundary_step(pos, dir)
    ds_gl = ds_local * jnp.exp2(-level.astype(ds_local.dtype))
    pos = jnp.where(active[..., None], new_pos, pos)
    pos, level, ind, anc = index_update_stack(grid, pos, level, ind, anc,
                                              active)
    return ds_gl, pos, level, ind, anc


def failed_step_nudge(npos, dir, failed):
    """Push failed boundary crossings forward by a distance guaranteed to
    change the stored float32 position.

    A crossing "fails" (same cell after the step) when rounding eats the
    PEPS over-step. For |coordinate| >~ 1700 the half-ulp exceeds PEPS
    itself: a negative-direction crossing computes floor - PEPS, which
    rounds back UP to the boundary, and the plain PEPS nudge rounds away
    too -- a permanently stuck lane (demonstrated on a 4096-wide root
    grid). The reference dodges this by recompiling the whole walk in
    double precision above NX > DIMLIM (kernel_ASOC_aux.c:27-46, DIMLIM
    100-399); scaling the nudge to >= 2-4 ulp of the largest coordinate
    keeps float32 everywhere at any root-grid size. Below coordinate
    ~210 (= PEPS * 2^21) the scale clamps to PEPS, i.e. bit-identical to
    the original nudge there; between ~210 and the stuck regime the
    nudge is merely a few float32 ulps larger than the reference's.
    """
    s = jnp.maximum(jnp.float32(PEPS),
                    jnp.max(jnp.abs(npos), axis=-1)
                    * jnp.float32(2.0 ** -21))
    return jnp.where(failed[..., None], npos + s[..., None] * dir, npos)


def boundary_step(pos, dir):
    """Distance (level-local units) to the next cell boundary, PEPS over-step.

    GetStep's step computation (kernel_ASOC_aux.c:282-300): per axis the step
    to the next integer plane plus PEPS; returns (ds_local, new_pos).

    The over-step epsilon is ulp-aware: exactly PEPS while |coordinate| <
    ~210 (= PEPS * 2^21; bit-identical to the fixed-epsilon form there),
    scaling to >= 2-4 ulp of the coordinate beyond -- a few-ulp larger
    over-step than the reference's fixed PEPS in the 210-1700 range,
    physically negligible and still float32-exactly representable. With fixed PEPS, a negative-
    direction crossing at |coordinate| >~ 1700 computes floor - PEPS,
    which rounds back UP onto the representable boundary -- the step
    "fails" (same cell), and since the reference deposits before its
    failed-step check (kernel_ASOC.c:570-660) every such crossing would
    double-deposit; at ~4000 the lane sticks permanently. The reference
    escapes by recompiling the walk in double precision above NX > DIMLIM
    (kernel_ASOC_aux.c:27-46); the scaled epsilon keeps float32 at any
    root-grid size with failures as rare as on small grids.
    """
    frac = jnp.mod(pos, 1.0)
    eps = jnp.maximum(jnp.float32(PEPS),
                      jnp.abs(pos) * jnp.float32(2.0 ** -21))
    step_pos = (1.0 + eps - frac) / dir
    step_neg = (-eps - frac) / dir
    per_axis = jnp.where(dir > 0.0, step_pos, step_neg)
    ds = jnp.min(per_axis, axis=-1)
    new_pos = pos + ds[..., None] * dir
    return ds, new_pos


def march_path_lengths(grid, pos0, dir, max_steps=10000):
    """March rays from global positions to exit; return total path per ray.

    Pure-traversal loop with no physics: the "speed-of-light" upper bound for
    packet stepping (BASELINE.md target) and the geometric test harness.
    Vectorized over rays; single fused lax.while_loop.
    """
    import jax

    pos, level, ind = index_global(grid, pos0)

    def cond(state):
        _, _, ind, _, it = state
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        pos, level, ind, total, it = state
        active = ind >= 0
        ds, npos, nlevel, nind = get_step(grid, pos, dir, level, ind, active)
        total = total + jnp.where(active, ds, 0.0)
        pos = jnp.where(active[..., None], npos, pos)
        level = jnp.where(active, nlevel, level)
        ind = jnp.where(active, nind, ind)
        return pos, level, ind, total, it + 1

    total = jnp.zeros(pos.shape[:-1], jnp.float32)
    state = (pos, level, ind, total, jnp.int32(0))
    _, _, _, total, _ = jax.lax.while_loop(cond, body, state)
    return total


def get_step(grid, pos, dir, level, ind, active):
    """Full GetStep: advance to next cell, update (level, ind).

    Returns (ds_gl, pos, level, ind) where ds_gl is the step in root-grid
    (GL) units: ds_local * 2**-level.
    """
    ds_local, new_pos = boundary_step(pos, dir)
    ds_gl = ds_local * jnp.exp2(-level.astype(ds_local.dtype))
    pos = jnp.where(active[..., None], new_pos, pos)
    pos, level, ind = index_update(grid, pos, level, ind, active)
    return ds_gl, pos, level, ind


def root_pos(grid, pos, level, ind):
    """Convert level-local positions to root-grid coordinates (RootPos,
    kernel_ASOC_aux.c:169-196). Vectorized, statically unrolled."""
    if grid.levels == 1:
        return pos
    for _ in range(grid.levels - 1):
        up = level > 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)] + ind,
                        0, grid.cells - 1)
        parent = grid.par[gidx]
        plevel = level - 1
        # parent at root: sub-octet [0,2] -> [0,1] + root cell offset
        posA = 0.5 * pos
        posA = posA.at[..., 0].add((parent % grid.nx).astype(pos.dtype))
        posA = posA.at[..., 1].add(((parent // grid.nx)
                                    % grid.ny).astype(pos.dtype))
        posA = posA.at[..., 2].add((parent
                                    // (grid.nx * grid.ny)).astype(pos.dtype))
        # parent inside an octet
        sid = parent % 8
        posB = 0.5 * pos
        posB = posB.at[..., 0].add((sid % 2).astype(pos.dtype))
        posB = posB.at[..., 1].add(((sid // 2) % 2).astype(pos.dtype))
        posB = posB.at[..., 2].add((sid // 4).astype(pos.dtype))
        rootcase = up & (plevel == 0)
        octcase = up & (plevel > 0)
        pos = jnp.where(rootcase[..., None], posA,
                        jnp.where(octcase[..., None], posB, pos))
        ind = jnp.where(up, parent, ind)
        level = jnp.where(up, plevel, level)
    return pos
