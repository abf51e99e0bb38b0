"""Octree grid representation.

The model geometry is a regular NX*NY*NZ root grid whose cells may be refined
into 2x2x2 octets, stored exactly like the reference's proven flat layout
(ASOC_aux.py:716-803): one float32 density array ``dens[CELLS]`` concatenating
all hierarchy levels; a leaf stores density > 0, a refined cell stores the
*negated bit pattern* of the int32 index of its first child on the next level.
``off[level]`` is the offset of the level inside ``dens``; ``par`` maps each
non-root cell to its parent's level-local index.

This layout is gather-friendly (single int32 index per lookup) and is kept
verbatim so model files round-trip bit-exactly. All arrays live on device; the
static shape metadata (nx, ny, nz, levels) is Python-side so ``jax.jit``
specializes the traversal code per model -- the analog of the reference's
``-D NX=.. -D LEVELS=..`` kernel recompilation.
"""

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp


def decode_link_np(dens_values):
    """Bit-cast negated float32 link values back to int32 child indices."""
    return (-np.asarray(dens_values, np.float32)).view(np.int32)


def encode_link_np(child_index):
    """Int32 first-child indices -> negated float32 link values."""
    return -np.asarray(child_index, np.int32).view(np.float32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Grid:
    """Device-resident octree grid (pytree; static metadata as aux data)."""

    dens: jax.Array       # [CELLS] float32; >0 leaf density, <=0 child link
    lcells: jax.Array     # [LEVELS] int32 cells per level
    off: jax.Array        # [LEVELS] int32 first cell of each level
    par: jax.Array        # [CELLS] int32 parent level-local index (-1 for root)
    nx: int = field(metadata=dict(static=True))
    ny: int = field(metadata=dict(static=True))
    nz: int = field(metadata=dict(static=True))
    levels: int = field(metadata=dict(static=True))
    cells: int = field(metadata=dict(static=True))

    @property
    def root_cells(self):
        return self.nx * self.ny * self.nz

    @property
    def area(self):
        """Total surface area of the model volume [GL^2]."""
        return 2.0 * (self.nx * self.ny + self.nx * self.nz + self.ny * self.nz)


def build_parents(dens, lcells, off, nx, ny, nz):
    """Host-side construction of the parent-link array.

    Equivalent to the reference's on-device ``Parents`` kernel
    (kernel_ASOC_aux.c:688-721) but vectorized in NumPy at model load.
    """
    levels = len(lcells)
    cells = int(np.sum(lcells))
    par = np.full(cells, -1, np.int32)
    for level in range(levels - 1):
        lo, hi = off[level], off[level] + lcells[level]
        vals = dens[lo:hi]
        parents = np.nonzero(vals <= 0.0)[0]          # level-local parent ids
        if len(parents) == 0:
            continue
        first_child = decode_link_np(vals[parents])   # level-local on level+1
        for i in range(8):
            par[off[level + 1] + first_child + i] = parents
    return par


def grid_from_arrays(nx, ny, nz, lcells, level_values):
    """Assemble a Grid from per-level float32 value arrays (host side)."""
    lcells = np.asarray(lcells, np.int32)
    off = np.zeros(len(lcells), np.int32)
    off[1:] = np.cumsum(lcells)[:-1]
    dens = np.concatenate([np.asarray(v, np.float32) for v in level_values])
    cells = int(np.sum(lcells))
    par = build_parents(dens, lcells, off, nx, ny, nz)
    return Grid(
        dens=jnp.asarray(dens),
        lcells=jnp.asarray(lcells),
        off=jnp.asarray(off),
        par=jnp.asarray(par),
        nx=int(nx), ny=int(ny), nz=int(nz),
        levels=int(len(lcells)), cells=cells,
    )


def uniform_grid(nx, ny, nz, density=1.0):
    """Single-level test helper: a uniform-density regular grid."""
    vals = np.full(nx * ny * nz, density, np.float32)
    return grid_from_arrays(nx, ny, nz, [nx * ny * nz], [vals])
