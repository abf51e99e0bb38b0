"""Map rendering: LOS integration of dust emission onto observer maps.

Reimplements the reference Mapping kernel (kernel_ASOC_map.c:496-888) with a
different shape: instead of one kernel launch per frequency (reference loops
IFREQ and re-stages EMIT, ASOC.py:3100-3130), every ray integrates *all
frequencies at once* -- the per-step work becomes a [PIXELS, NFREQ] vector
update, which vectorises over the spectrum, and the
geometry (the serial part) is amortized over the whole spectrum.

Radiative transfer along the ray (stepping *away* from the observer):
  I += exp(-tau) * (1 - exp(-dtau))/dtau * ds * emit * dens,  tau += dtau
with the reference's Taylor fallback for dtau < 1e-3.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..constants import EPS, FACTOR, PARSEC, PLANCK
from ..ops import traverse


def observer_basis(theta, phi):
    """(theta, phi) -> (ODIR, RA, DE) orthonormal triad.

    Same convention as the reference (ASOC_aux.py:1129-1183): the observer
    lies in direction ODIR; RA increases to the right in the map, DE up.
    """
    b = 0.5 * np.pi - theta          # latitude
    a = phi
    rot = np.asarray([
        [np.cos(a) * np.cos(b), -np.sin(a), -np.cos(a) * np.sin(b)],
        [np.sin(a) * np.cos(b), np.cos(a), -np.sin(a) * np.sin(b)],
        [np.sin(b), 0.0, np.cos(b)]])
    odir = rot @ np.asarray([1.0, 0.0, 0.0])
    ra = rot @ np.asarray([0.0, 1.0, 0.0])
    de = rot @ np.asarray([0.0, 0.0, 1.0])
    odir = np.where(np.abs(odir) < 1e-5, 1e-5, odir)
    return (odir.astype(np.float32), ra.astype(np.float32),
            de.astype(np.float32))


def map_scale_kk(gl_pc):
    """Jy/sr conversion applied to EMITTED before LOS integration
    (ASOC.py:3000-3001): KK = (1e23/FACTOR) * PLANCK/(4 pi) * GL * PARSEC."""
    return (1.0e23 / FACTOR) * PLANCK / (4.0 * np.pi) * gl_pc * PARSEC


def _front_surface(pos, odir, nx, ny, nz):
    """Clamp ray start positions to the model's front surface
    (kernel_ASOC_map.c:570-640, NX<200 branch)."""
    # step away from the observer until inside the volume
    bound = jnp.where(odir >= 0.0,
                      jnp.asarray([nx, ny, nz], jnp.float32),
                      jnp.zeros(3, jnp.float32))
    s = (bound - pos) / (-odir) + EPS                  # [P, 3]
    trial = pos[:, None, :] - s[..., None] * odir      # [P, 3axis, 3]
    ok = ((trial[..., 0] >= 0) & (trial[..., 0] <= nx)
          & (trial[..., 1] >= 0) & (trial[..., 1] <= ny)
          & (trial[..., 2] >= 0) & (trial[..., 2] <= nz))
    s = jnp.where(ok, s, 1e10)
    smin = jnp.min(s, axis=-1)
    return pos - smin[:, None] * odir


@partial(jax.jit, static_argnames=("npix", "max_steps", "nrows",
                                   "use_shear", "map_interp"))
def render_ortho(grid, emit_map, ext_gl, odir, ra, de, centre, map_dx,
                 npix, max_steps=100000, row0=0, nrows=None,
                 use_shear=False, y_shear=0.0, maxlos=1e10, map_interp=0):
    """Orthographic multi-frequency map.

    emit_map : [CELLS, NF] emission pre-scaled by KK*freq (Jy/sr units out)
    ext_gl   : [NF] extinction (abs+sca) / unit density / GL
    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]).
    colden is in GL units (caller multiplies by GL*PARSEC).

    row0/nrows render only map rows [row0, row0+nrows) -- the pixel-sharding
    hook for multi-chip map rendering (NY := nrows in the outputs).

    use_shear: shearing-box continuation (kernel_ASOC_map_H.c:800-830,
    YSHEAR keyword): rays exiting through the X faces re-enter on the
    opposite side with y shifted -/+ y_shear root cells (Y faces wrap
    periodically), until the accumulated LOS exceeds maxlos [GL].

    map_interp > 0: cross-ray interpolation (MAP_INTERPOLATION,
    kernel_ASOC_map.c:656-760): per step, sample the two cells
    perpendicular to the ray at mid-step and blend
    dens/emit = (0.5-a)*A + (0.5-b)*B + (a+b)*C (triangle weights).
    """
    nxp, nyp = npix
    if nrows is None:
        nrows = nyp
    nf = emit_map.shape[1]
    i = jnp.arange(nxp, dtype=jnp.float32)
    j = jnp.arange(nrows, dtype=jnp.float32) \
        + jnp.asarray(row0, jnp.float32)
    ii, jj = jnp.meshgrid(i, j, indexing="xy")          # [NROWS, NX]
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    centre = jnp.asarray(centre, jnp.float32)
    pos = (centre[None, :]
           + ((ii - 0.5 * (nxp - 1)) * map_dx)[:, None] * ra[None, :]
           + ((jj - 0.5 * (nyp - 1)) * map_dx)[:, None] * de[None, :])
    nyp = nrows          # outputs cover only the rendered rows
    pos = pos + (grid.nx + grid.ny + grid.nz) * odir[None, :]
    pos = _front_surface(pos, odir, grid.nx, grid.ny, grid.nz)

    step_dir = -odir
    step_dir = jnp.where(jnp.abs(step_dir) < 1e-5, 1e-5, step_dir)
    step_dir = jnp.broadcast_to(step_dir, pos.shape)

    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    npixels = pos.shape[0]
    tau = jnp.zeros((npixels, nf), jnp.float32)
    phot = jnp.zeros((npixels, nf), jnp.float32)
    colden = jnp.zeros(npixels, jnp.float32)
    los = jnp.zeros(npixels, jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, phot, colden, los = state
        active = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        emit = emit_map[gidx, :]                       # [P, NF]
        ds, npos, nlevel, nind, nanc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        # failed-step recovery
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)

        if map_interp > 0:
            # cross-ray triangle interpolation: neighbors along the
            # (ra, de) axes at the step midpoint (kernel_ASOC_map.c
            # MAP_INTERPOLATION==2 weights)
            k = jnp.exp2(-level.astype(jnp.float32))
            mid = pos + (0.5 * ds / k)[:, None] * step_dir

            def neighbor(adir):
                d = jnp.broadcast_to(adir, pos.shape)
                sa, _, sl, si, _ = traverse.get_step_stack(
                    grid, mid, d, level, ind, anc, active)
                sa = sa / k
                ok = (sa <= 0.52) & (si >= 0)
                # try the opposite direction when no near neighbor
                sb, _, sl2, si2, _ = traverse.get_step_stack(
                    grid, mid, -d, level, ind, anc, active)
                sb = sb / k
                ok2 = ~ok & (sb <= 0.52) & (si2 >= 0)
                sl = jnp.where(ok, sl, sl2)
                si = jnp.where(ok, si, si2)
                dist = jnp.where(ok, sa, jnp.where(ok2, sb, 0.5))
                any_ok = ok | ok2
                gi = jnp.clip(grid.off[jnp.clip(sl, 0, grid.levels - 1)]
                              + jnp.maximum(si, 0), 0, grid.cells - 1)
                nd = jnp.where(any_ok, grid.dens[gi], 0.0)
                nemit = jnp.where(any_ok[:, None], emit_map[gi, :], 0.0)
                return jnp.clip(dist, 0.0, 0.51), nd, nemit

            a, adens, aemit = neighbor(ra)
            bdist, bdens, bemit = neighbor(de)
            dens = ((0.5 - a) * adens + (0.5 - bdist) * bdens
                    + (a + bdist) * dens)
            emit = ((0.5 - a)[:, None] * aemit
                    + (0.5 - bdist)[:, None] * bemit
                    + (a + bdist)[:, None] * emit)

        w = jnp.where(active, ds, 0.0)
        # ext_gl [NF] (constant abundances) or [CELLS, NF] (WITH_ABU OPT)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        dtau = (w * dens)[:, None] * ext_row
        attw = jnp.where(dtau < 1.0e-3,
                         1.0 - 0.5 * dtau,
                         (1.0 - jnp.exp(-dtau)) / jnp.maximum(dtau, 1e-30))
        phot = phot + jnp.exp(-tau) * attw * (w * dens)[:, None] * emit
        tau = tau + dtau
        colden = colden + w * dens
        los = los + w

        if use_shear:
            # shearing-box continuation through the X/Y faces
            nx_, ny_, nz_ = (jnp.float32(grid.nx), jnp.float32(grid.ny),
                             jnp.float32(grid.nz))
            exited = active & (nind < 0)
            zin = (npos[:, 2] > 0.0) & (npos[:, 2] < nz_)
            cont = exited & zin & (los < maxlos)
            xlo = npos[:, 0] <= 0.0
            xhi = npos[:, 0] >= nx_
            newx = jnp.where(xlo, nx_ - 2.0 * EPS,
                             jnp.where(xhi, 2.0 * EPS, npos[:, 0]))
            yshift = jnp.where(xlo, -jnp.float32(y_shear),
                               jnp.where(xhi, jnp.float32(y_shear), 0.0))
            newy = jnp.mod(npos[:, 1] + ny_ + yshift, ny_)
            newy = jnp.clip(newy, 2.0 * EPS, ny_ - 2.0 * EPS)
            wpos = jnp.stack([newx, newy, npos[:, 2]], axis=1)
            wp, wl, wi, wa = traverse.index_global_stack(grid, wpos)
            npos = jnp.where(cont[:, None], wp, npos)
            nlevel = jnp.where(cont, wl, nlevel)
            nind = jnp.where(cont, wi, nind)
            nanc = jnp.where(cont[:, None], wa, nanc)

        return it + 1, npos, nlevel, nind, nanc, tau, phot, colden, los

    state = (jnp.int32(0), pos, level, ind, anc, tau, phot, colden, los)
    _, _, _, _, _, tau, phot, colden, _ = lax.while_loop(cond, body, state)
    phot = phot.T.reshape(nf, nyp, nxp)
    tau = tau.T.reshape(nf, nyp, nxp)
    colden = colden.reshape(nyp, nxp)
    return phot, tau, colden


def _interp_density(grid, mid, dens0, olevel, mode):
    """LOS density smoothing for all-sky maps (`interpolation` keyword,
    kernel_ASOC_map_H.c:654-733): density at the global step midpoint
    `mid` instead of the cell value `dens0`.

    mode 1: 4-point linear blend with one axis neighbor per dimension
            (regular root grid only, like the reference).
    mode 2: 3x3x3 inverse-distance weighting (regular root grid only).
    mode 3: 3x3x3 IDW with full hierarchy lookups at +-one-cell-size
            offsets (works on refined grids).
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    if mode == 1:
        i0 = jnp.clip(jnp.floor(mid[:, 0]).astype(jnp.int32), 0, nx - 1)
        j0 = jnp.clip(jnp.floor(mid[:, 1]).astype(jnp.int32), 0, ny - 1)
        k0 = jnp.clip(jnp.floor(mid[:, 2]).astype(jnp.int32), 0, nz - 1)
        m = jnp.mod(mid, 1.0) - 0.5
        s = (3.0 - jnp.abs(m).sum(-1)) * dens0

        def leafd(gi):
            # refined root cells store bit-cast child links (<= 0):
            # substitute the ray's own leaf density rather than blending
            # link garbage (the reference restricts modes 1/2 to regular
            # grids by convention only)
            v = grid.dens[gi]
            return jnp.where(v > 0.0, v, dens0)

        ix = jnp.where(m[:, 0] > 0, jnp.maximum(i0 - 1, 0),
                       jnp.minimum(i0 + 1, nx - 1))
        s = s + jnp.abs(m[:, 0]) * leafd(k0 * nx * ny + j0 * nx + ix)
        iy = jnp.where(m[:, 1] > 0, jnp.maximum(j0 - 1, 0),
                       jnp.minimum(j0 + 1, ny - 1))
        s = s + jnp.abs(m[:, 1]) * leafd(k0 * nx * ny + iy * nx + i0)
        iz = jnp.where(m[:, 2] > 0, jnp.maximum(k0 - 1, 0),
                       jnp.minimum(k0 + 1, nz - 1))
        s = s + jnp.abs(m[:, 2]) * leafd(iz * nx * ny + j0 * nx + i0)
        return s / 3.0
    if mode == 2:
        i0 = jnp.floor(mid[:, 0]).astype(jnp.int32)
        j0 = jnp.floor(mid[:, 1]).astype(jnp.int32)
        k0 = jnp.floor(mid[:, 2]).astype(jnp.int32)
        tot = jnp.zeros_like(dens0)
        wtot = jnp.zeros_like(dens0)
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    i, j, k = i0 + di, j0 + dj, k0 + dk
                    gi = jnp.clip(k, 0, nz - 1) * nx * ny \
                        + jnp.clip(j, 0, ny - 1) * nx + jnp.clip(i, 0, nx - 1)
                    v = grid.dens[gi]
                    # skip out-of-bounds neighbors AND refined cells whose
                    # slot holds a bit-cast child link instead of a density
                    ok = ((i >= 0) & (i < nx) & (j >= 0) & (j < ny)
                          & (k >= 0) & (k < nz) & (v > 0.0))
                    d = mid - jnp.stack([i + 0.5, j + 0.5, k + 0.5],
                                        -1).astype(mid.dtype)
                    w = jnp.where(
                        ok, 1.0 / (0.1 + jnp.linalg.norm(d, axis=-1)), 0.0)
                    tot = tot + w * v
                    wtot = wtot + w
        return jnp.where(wtot > 0.0, tot / jnp.maximum(wtot, 1e-30), dens0)
    # mode 3
    delta = jnp.exp2(-olevel.astype(mid.dtype))[:, None]
    tot = jnp.zeros_like(dens0)
    wtot = jnp.zeros_like(dens0)
    for dk in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                off3 = jnp.asarray([di, dj, dk], mid.dtype)
                _, lvl, ind = traverse.index_global(grid, mid + delta * off3)
                ok = ind >= 0
                gi = jnp.clip(grid.off[jnp.clip(lvl, 0, grid.levels - 1)]
                              + jnp.maximum(ind, 0), 0, grid.cells - 1)
                w = jnp.where(
                    ok, 1.0 / np.sqrt(0.2 + di * di + dj * dj + dk * dk), 0.0)
                tot = tot + w * grid.dens[gi]
                wtot = wtot + w
    return tot / jnp.maximum(wtot, 1e-30)


@partial(jax.jit, static_argnames=("nside", "max_steps", "interpolate"))
def render_healpix(grid, emit_map, ext_gl, intobs, nside, max_steps=100000,
                   interpolate=0):
    """All-sky map around an internal observer (HealpixMapping,
    kernel_ASOC_map.c:890-965): one ray per RING pixel stepping away from
    INTOBS; (lon,lat)=(0,0) looks along -X. `interpolate` selects the LOS
    density smoothing of the `interpolation` keyword (_interp_density).

    Returns (photons [NF, NPIX], tau [NF, NPIX], colden [NPIX]).
    """
    from . import healpix as hp
    npix = 12 * nside * nside
    nf = emit_map.shape[1]
    theta, phi = hp.pix2ang_ring(nside, jnp.arange(npix))
    step_dir = jnp.stack([-jnp.sin(theta) * jnp.cos(phi),
                          -jnp.sin(theta) * jnp.sin(phi),
                          jnp.cos(theta)], -1)
    step_dir = jnp.where(jnp.abs(step_dir) < 1e-5, 1e-5, step_dir)
    intobs = jnp.asarray(intobs, jnp.float32)
    pos = jnp.broadcast_to(intobs, (npix, 3))
    # nudge off cell boundaries (reference: +2e-5 guards)
    pos = pos + 2.0e-5

    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    tau = jnp.zeros((npix, nf), jnp.float32)
    phot = jnp.zeros((npix, nf), jnp.float32)
    colden = jnp.zeros(npix, jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, phot, colden = state
        active = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        if interpolate:
            gpos = traverse.root_pos(grid, pos, level, ind)
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        if interpolate:
            dens = _interp_density(grid, gpos + (0.5 * ds)[:, None]
                                   * step_dir, dens, level, interpolate)
        w = jnp.where(active, ds, 0.0)
        # ext_gl [NF] (constant abundances) or [CELLS, NF] (WITH_ABU OPT)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        dtau = (w * dens)[:, None] * ext_row
        emit = emit_map[gidx, :]
        attw = jnp.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                         (1.0 - jnp.exp(-dtau)) / jnp.maximum(dtau, 1e-30))
        phot = phot + jnp.exp(-tau) * attw * (w * dens)[:, None] * emit
        tau = tau + dtau
        colden = colden + w * dens
        return it + 1, npos, nlevel, nind, anc, tau, phot, colden

    state = (jnp.int32(0), pos, level, ind, anc, tau, phot, colden)
    _, _, _, _, _, tau, phot, colden = lax.while_loop(cond, body, state)
    return phot.T, tau.T, colden


@partial(jax.jit, static_argnames=("npix", "max_steps"))
def render_perspective(grid, emit_map, ext_gl, intobs, npix,
                       max_steps=100000):
    """Panoramic (lon, lat) map from an internal observer (the INTOBS branch
    of the Mapping kernel, kernel_ASOC_map.c:538-557): longitude spans 2 pi
    over NPIX.x with lon 0 in the map centre, latitude pix-size rows around
    the equator. Reference orientation: the map centre (lon 0, lat 0) looks
    along +X ("towards GC"); NOTE the reference's own all-sky healpix
    kernels use the opposite convention ((lon, lat) = (0, 0) along -X,
    render_healpix), so a panorama and an all-sky map of the same model
    differ by 180 degrees in longitude -- in the reference too.

    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]).
    """
    nxp, nyp = npix
    nf = emit_map.shape[1]
    i = jnp.arange(nxp, dtype=jnp.float32)
    j = jnp.arange(nyp, dtype=jnp.float32)
    ii, jj = jnp.meshgrid(i, j, indexing="xy")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    phi = 2.0 * np.pi * ii / nxp + np.pi
    pix = 2.0 * np.pi / nxp
    theta = pix * (jj - (nyp - 1) / 2.0)
    step_dir = jnp.stack([jnp.cos(theta) * jnp.cos(phi),
                          jnp.cos(theta) * jnp.sin(phi),
                          jnp.sin(theta)], -1)
    step_dir = jnp.where(jnp.abs(step_dir) < 1e-5, 1e-5, step_dir)
    pos = jnp.broadcast_to(jnp.asarray(intobs, jnp.float32),
                           step_dir.shape) + 2.0e-5

    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    npixels = pos.shape[0]
    tau = jnp.zeros((npixels, nf), jnp.float32)
    phot = jnp.zeros((npixels, nf), jnp.float32)
    colden = jnp.zeros(npixels, jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, phot, colden = state
        active = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        w = jnp.where(active, ds, 0.0)
        # ext_gl [NF] (constant abundances) or [CELLS, NF] (WITH_ABU OPT)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        dtau = (w * dens)[:, None] * ext_row
        emit = emit_map[gidx, :]
        attw = jnp.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                         (1.0 - jnp.exp(-dtau)) / jnp.maximum(dtau, 1e-30))
        phot = phot + jnp.exp(-tau) * attw * (w * dens)[:, None] * emit
        tau = tau + dtau
        colden = colden + w * dens
        return it + 1, npos, nlevel, nind, anc, tau, phot, colden

    state = (jnp.int32(0), pos, level, ind, anc, tau, phot, colden)
    _, _, _, _, _, tau, phot, colden = lax.while_loop(cond, body, state)
    return (phot.T.reshape(nf, nyp, nxp), tau.T.reshape(nf, nyp, nxp),
            colden.reshape(nyp, nxp))


@partial(jax.jit, static_argnames=("max_steps",))
def render_pstau(grid, ext_gl, ps_pos, odir, max_steps=100000):
    """Optical depth + column density from each point source toward the
    observer (PSTau, kernel_ASOC_map.c:1545-1583): one ray per source,
    stepping TOWARDS the observer direction until exit.

    ps_pos : [S, 3]; ext_gl : [NF] or [CELLS, NF] (WITH_ABU per-cell OPT)
    Returns (tau [S, NF], colden [S]) -- colden in GL units.
    """
    step_dir = jnp.where(jnp.abs(odir) < 1e-5, 1e-5, odir)
    ps_pos = jnp.asarray(ps_pos, jnp.float32)
    step_dir = jnp.broadcast_to(step_dir, ps_pos.shape)
    nf = ext_gl.shape[-1]
    pos, level, ind, anc = traverse.index_global_stack(grid, ps_pos)
    ns = pos.shape[0]
    tau = jnp.zeros((ns, nf), jnp.float32)
    colden = jnp.zeros(ns, jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, colden = state
        active = ind >= 0
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        w = jnp.where(active, ds, 0.0)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        tau = tau + (w * dens)[:, None] * ext_row
        colden = colden + w * dens
        return it + 1, npos, nlevel, nind, anc, tau, colden

    state = (jnp.int32(0), pos, level, ind, anc, tau, colden)
    _, _, _, _, _, tau, colden = lax.while_loop(cond, body, state)
    return tau, colden


@partial(jax.jit, static_argnames=("npix", "max_steps"))
def render_ortho_hier(grid, emit_map, ext_gl, odir, ra, de, centre, map_dx,
                      npix, max_steps=100000):
    """Orthographic maps separated by hierarchy level (MAP_HIER mode,
    kernel_ASOC_map_H.c: one map per octree level, the contribution of each
    LOS step binned by the emitting cell's level).

    Returns photons [LEVELS, NF, NY, NX].
    """
    nxp, nyp = npix
    nf = emit_map.shape[1]
    nlev = grid.levels
    i = jnp.arange(nxp, dtype=jnp.float32)
    j = jnp.arange(nyp, dtype=jnp.float32)
    ii, jj = jnp.meshgrid(i, j, indexing="xy")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    centre = jnp.asarray(centre, jnp.float32)
    pos = (centre[None, :]
           + ((ii - 0.5 * (nxp - 1)) * map_dx)[:, None] * ra[None, :]
           + ((jj - 0.5 * (nyp - 1)) * map_dx)[:, None] * de[None, :])
    pos = pos + (grid.nx + grid.ny + grid.nz) * odir[None, :]
    pos = _front_surface(pos, odir, grid.nx, grid.ny, grid.nz)
    step_dir = -odir
    step_dir = jnp.where(jnp.abs(step_dir) < 1e-5, 1e-5, step_dir)
    step_dir = jnp.broadcast_to(step_dir, pos.shape)

    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    npixels = pos.shape[0]
    tau = jnp.zeros((npixels, nf), jnp.float32)
    phot = jnp.zeros((npixels, nlev, nf), jnp.float32)

    def cond(state):
        it = state[0]
        ind = state[3]
        return (it < max_steps) & jnp.any(ind >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, phot = state
        active = ind >= 0
        olevel = level
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        w = jnp.where(active, ds, 0.0)
        # ext_gl [NF] (constant abundances) or [CELLS, NF] (WITH_ABU OPT)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        dtau = (w * dens)[:, None] * ext_row
        emit = emit_map[gidx, :]
        attw = jnp.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                         (1.0 - jnp.exp(-dtau)) / jnp.maximum(dtau, 1e-30))
        contrib = jnp.exp(-tau) * attw * (w * dens)[:, None] * emit
        onehot = (olevel[:, None]
                  == jnp.arange(nlev, dtype=jnp.int32)[None, :])
        phot = phot + onehot.astype(jnp.float32)[:, :, None] \
            * contrib[:, None, :]
        tau = tau + dtau
        return it + 1, npos, nlevel, nind, anc, tau, phot

    state = (jnp.int32(0), pos, level, ind, anc, tau, phot)
    _, _, _, _, _, tau, phot = lax.while_loop(cond, body, state)
    return jnp.transpose(phot, (1, 2, 0)).reshape(nlev, nf, nyp, nxp)


@partial(jax.jit, static_argnames=("nside", "max_steps"))
def render_healpix_hier(grid, emit_map, ext_gl, intobs, nside,
                        max_steps=100000):
    """All-sky maps separated by hierarchy level: the MAP_HIER + healpix
    combination (`mapping NSIDE -1 dx` with FAST_MAP>=999,
    ASOC.py:3323-3438 selecting kernel_ASOC_map_H.c:507 HealpixMapping).
    Rays march from INTOBS exactly like render_healpix; each step's
    contribution is binned by the emitting cell's level like
    render_ortho_hier. NOTE the reference kernel collapses the levels
    into a single plane (MAP[id] = PHOTONS, :571) although the driver
    sizes the file for LEVELS planes -- we actually perform the split,
    so summing our level planes reproduces the reference's one filled
    plane.

    Returns (photons [LEVELS, NF, NPIX], tau [NF, NPIX], colden [NPIX]).
    """
    from . import healpix as hp
    npix = 12 * nside * nside
    nf = emit_map.shape[1]
    nlev = grid.levels
    theta, phi = hp.pix2ang_ring(nside, jnp.arange(npix))
    step_dir = jnp.stack([-jnp.sin(theta) * jnp.cos(phi),
                          -jnp.sin(theta) * jnp.sin(phi),
                          jnp.cos(theta)], -1)
    step_dir = jnp.where(jnp.abs(step_dir) < 1e-5, 1e-5, step_dir)
    pos = jnp.broadcast_to(jnp.asarray(intobs, jnp.float32),
                           (npix, 3)) + 2.0e-5
    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    tau = jnp.zeros((npix, nf), jnp.float32)
    phot = jnp.zeros((npix, nlev, nf), jnp.float32)
    colden = jnp.zeros(npix, jnp.float32)

    def cond(state):
        it = state[0]
        return (it < max_steps) & jnp.any(state[3] >= 0)

    def body(state):
        it, pos, level, ind, anc, tau, phot, colden = state
        active = ind >= 0
        olevel = level
        gidx = jnp.clip(grid.off[jnp.clip(level, 0, grid.levels - 1)]
                        + jnp.maximum(ind, 0), 0, grid.cells - 1)
        dens = grid.dens[gidx]
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        w = jnp.where(active, ds, 0.0)
        ext_row = ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]
        dtau = (w * dens)[:, None] * ext_row
        emit = emit_map[gidx, :]
        attw = jnp.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                         (1.0 - jnp.exp(-dtau)) / jnp.maximum(dtau, 1e-30))
        contrib = jnp.exp(-tau) * attw * (w * dens)[:, None] * emit
        onehot = (olevel[:, None]
                  == jnp.arange(nlev, dtype=jnp.int32)[None, :])
        phot = phot + onehot.astype(jnp.float32)[:, :, None] \
            * contrib[:, None, :]
        tau = tau + dtau
        colden = colden + w * dens
        return it + 1, npos, nlevel, nind, anc, tau, phot, colden

    state = (jnp.int32(0), pos, level, ind, anc, tau, phot, colden)
    _, _, _, _, _, tau, phot, colden = lax.while_loop(cond, body, state)
    return jnp.transpose(phot, (1, 2, 0)), tau.T, colden
