"""Seeded example inputs: the reference's ``soc_example`` workload, generated.

The reference ships its end-to-end example as a zip (``my.ini``,
``make_cloud.py``, ``tmp.dust``, ``tmp.dsc``, ``bg_intensity.bin``,
``freq.dat``). This module writes files of the same formats and sizes from
code, so tests, the benchmark and the chip smoke run need nothing outside
the repository:

* ``tmp.cloud``        -- 64^3 uniform cloud, exactly as make_cloud.py;
* ``tmp.dust``         -- a 44-channel ``eqdust`` on a log wavelength grid
  of three channels per octave from 2520 um to 0.122 um (channels 7 and 10
  are exactly 500 and 250 um), with power-law
  absorption (beta = 1 up to 50 um, beta = 2 beyond), power-law scattering
  and an HG asymmetry g(nu) falling from 0.6 in the UV to ~0 in the FIR;
* ``tmp.dsc``          -- HG phase functions of that g(nu), 2500 bins;
* ``bg_intensity.bin`` -- 0.86 times a Mathis, Mezger & Panagia (1983)
  ISRF (three diluted stellar blackbodies and the UV piecewise law) plus
  the CMB;
* ``freq.dat``         -- the 44 frequencies;
* ``my.ini``           -- the example run: 999,999 background packets per
  channel, one iteration, 64x64 map.

The grain abundance is set so that A_V / N_H = 5.3e-22 mag cm^2, and the
example density so that the externally heated cloud's equilibrium
temperatures fall in 10-20 K. These are assumptions of this generator, not
the reference's measured dust tables.

Every file is written to a temporary name and renamed into place, so
several processes may generate into the same directory at once.

Also here: a larger octree cloud for at-scale runs (``write_large_cloud``)
and the synthetic GSET grain model used to build stochastic-heating
solvers (``gset_dust``, ``isrf_absorptions``).
"""

import os
import tempfile

import numpy as np

from ..constants import BOLTZMANN, C_LIGHT, FACTOR, PLANCK
from ..grid import encode_link_np
from .cloud import write_hierarchy
from .dust import hg_scattering_function, write_scattering_function

NFREQ = 44
EXAMPLE_N = 64
EXAMPLE_DENSITY = 1.0e4          # n_H [cm^-3] of the uniform cloud
DSC_BINS = 2500
GRAIN_SIZE = 1.0e-5              # cm
GRAIN_DENSITY = 9.0e-13          # grains per H
ISRF_SCALE = 0.86                # x the Mathis et al. (1983) field

EXAMPLE_INI = """\
gridlength      0.01
cloud           tmp.cloud
mapping         {npix} {npix} 1.0
density         {density:.6e}
seed            1.0
directions      0.0 0.0
optical         tmp.dust
dsc             tmp.dsc {bins}
bgpackets       {bgpackets}
background      bg_intensity.bin
iterations      1
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
temperature     tmp.T
"""


def example_wavelengths():
    """[NFREQ] wavelengths in um, decreasing (frequency increasing):
    three channels per octave, channel 10 at 250 um."""
    k = np.arange(NFREQ, dtype=np.float64)
    return 250.0 * 2.0 ** (-(k - 10.0) / 3.0)


def example_freq():
    """[NFREQ] frequencies in Hz, increasing, rounded to the six
    significant digits the eqdust file keeps (so freq.dat, tmp.dust and
    the background agree exactly)."""
    freq = C_LIGHT / (example_wavelengths() * 1.0e-4)
    return np.asarray([float("%.5e" % f) for f in freq])


def example_optics():
    """(freq, g, Qabs, Qsca) rows of the example's eqdust file."""
    um = example_wavelengths()
    qabs = np.where(um < 50.0, (um / 0.55) ** -1.0,
                    (50.0 / 0.55) ** -1.0 * (um / 50.0) ** -2.0)
    qsca = 0.8 * np.where(um < 1.0, (um / 0.55) ** -1.0,
                          (1.0 / 0.55) ** -1.0 * um ** -4.0)
    g = 0.6 / (1.0 + (um / 2.0) ** 2)
    return example_freq(), g, qabs, qsca


def _planck(freq, t):
    x = np.clip(PLANCK * freq / (BOLTZMANN * t), 1e-8, 700.0)
    return 2.0 * PLANCK * freq ** 3 / C_LIGHT ** 2 / np.expm1(x)


def isrf_intensity(freq):
    """Isotropic interstellar radiation field I_nu [erg/s/cm2/Hz/sr]."""
    freq = np.asarray(freq, np.float64)
    um = C_LIGHT / freq * 1.0e4
    stars = (1.0e-14 * _planck(freq, 7500.0)
             + 1.0e-13 * _planck(freq, 4000.0)
             + 4.0e-13 * _planck(freq, 3000.0))
    # UV: 4 pi lambda J_lambda [erg/s/cm2], lambda in um
    uv = np.select([(um >= 0.0912) & (um < 0.110),
                    (um >= 0.110) & (um < 0.134),
                    (um >= 0.134) & (um < 0.246)],
                   [38.57 * um ** 3.4172, np.full_like(um, 2.045e-2),
                    7.115e-4 * um ** -1.6678], 0.0)
    return (ISRF_SCALE * (stars + uv / (4.0 * np.pi * freq))
            + _planck(freq, 2.728))


def _atomic(path, write):
    """Run write(tmp_path), then rename tmp_path to path."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               dir=d)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write_text(path, text):
    def w(tmp):
        with open(tmp, "w") as fp:
            fp.write(text)
    _atomic(path, w)


def write_dust_inputs(workdir):
    """Write tmp.dust, tmp.dsc, bg_intensity.bin and freq.dat."""
    os.makedirs(workdir, exist_ok=True)
    freq, g, qabs, qsca = example_optics()
    rows = "".join(" %12.5e  %8.5f  %12.5e %12.5e\n" % r
                   for r in zip(freq, g, qabs, qsca))
    _write_text(os.path.join(workdir, "tmp.dust"),
                "eqdust\n %.5e\n %.5e\n%d\n" % (GRAIN_DENSITY, GRAIN_SIZE,
                                                NFREQ) + rows)
    dsc, csc = hg_scattering_function(g, DSC_BINS)
    _atomic(os.path.join(workdir, "tmp.dsc"),
            lambda p: write_scattering_function(p, dsc, csc))
    ibg = isrf_intensity(freq).astype(np.float32)
    _atomic(os.path.join(workdir, "bg_intensity.bin"), ibg.tofile)
    _write_text(os.path.join(workdir, "freq.dat"),
                "".join("%.5e\n" % f for f in freq))


def write_uniform_cloud(path, n):
    """n^3 cloud of unit densities (the reference's make_cloud.py)."""
    _atomic(path, lambda p: write_hierarchy(
        p, n, n, n, [n ** 3], [np.ones(n ** 3, np.float32)]))


def write_example(workdir, n=EXAMPLE_N, bgpackets=999999,
                  density=EXAMPLE_DENSITY):
    """Write the whole example into workdir; returns the path of my.ini.

    n, bgpackets and density scale the example down for tests (the
    defaults are the reference example's)."""
    write_dust_inputs(workdir)
    write_uniform_cloud(os.path.join(workdir, "tmp.cloud"), n)
    path = os.path.join(workdir, "my.ini")
    _write_text(path, EXAMPLE_INI.format(
        npix=n, density=density, bins=DSC_BINS, bgpackets=bgpackets))
    return path


def large_cloud_arrays(n=256, seed=12):
    """(lcells, [level densities]) of the at-scale octree: an n^3 root of
    densities 500-1500 with its central 16^3 block refined (2000 +- 50%),
    and 512 of those children refined once more (4000 +- 50%). At n=256
    it has 16,814,080 cells."""
    rng = np.random.default_rng(seed)
    root = (1000.0 * rng.uniform(0.5, 1.5, n ** 3)).astype(np.float32)
    c = np.arange(n // 2 - 8, n // 2 + 8)
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    ii = (x + n * y + n * n * z).ravel()
    root[ii] = encode_link_np(np.arange(0, 8 * len(ii), 8, dtype=np.int32))
    l1 = (2000.0 * rng.uniform(0.5, 1.5, 8 * len(ii))).astype(np.float32)
    sub = np.arange(512) * (len(l1) // 512) + 3
    l1[sub] = encode_link_np(np.arange(0, 8 * 512, 8, dtype=np.int32))
    l2 = (4000.0 * rng.uniform(0.5, 1.5, 8 * 512)).astype(np.float32)
    return [n ** 3, len(l1), len(l2)], [root, l1, l2]


def write_large_cloud(path, n=256, seed=12):
    """Write the at-scale octree cloud of large_cloud_arrays."""
    lcells, values = large_cloud_arrays(n, seed)
    _atomic(path, lambda p: write_hierarchy(p, n, n, n, lcells, values))


def gset_dust(size_a=(1e-7, 3e-6), s_frac=(0.7, 0.3)):
    """Synthetic GSET grain model: silicate-like grains with a Debye-like
    enthalpy E ~ 0.35 a^3 T^4 / (1 + (T/500)^3) erg and Qabs ~ x/(1+x),
    x = a nu / 3e4. Sizes in cm; s_frac is normalised."""
    from ..solve.grain_model import GSETDust
    qnfreq = 48
    qfreq = np.logspace(11, 15.5, qnfreq)
    qsize = np.asarray([5e-8, 1e-7, 1e-6, 1e-5])     # cm
    x = qsize[:, None] * qfreq[None, :] / 3e4
    qabs = x / (1.0 + x)
    c_temp = np.logspace(0, np.log10(3000.0), 64)
    c_e = (0.35 * qsize[:, None] ** 3 * c_temp[None, :] ** 4
           / (1.0 + (c_temp[None, :] / 500.0) ** 3))
    size_a = np.asarray(size_a, np.float64)
    s_frac = np.asarray(s_frac, np.float64)
    s_frac = s_frac / s_frac.sum()
    nsize = len(size_a)
    return GSETDust(
        grain_density=1.0e-10, size_a=size_a, s_frac=s_frac,
        tmin=np.full(nsize, 3.0), tmax=np.full(nsize, 200.0),
        qsize=qsize, qfreq=qfreq, qabs=qabs, qsca=qabs * 0.5,
        g=np.zeros((4, qnfreq)),
        c_size=qsize.copy(), c_temp=c_temp, c_e=c_e)


def isrf_absorptions(dust, freq, scale=1.0):
    """Absorbed photons per H per Hz (x FACTOR) in a diluted 1e4 K field
    (the absorbed.data convention: FACTOR * 4 pi J_nu / (h nu) * kabs)."""
    bnu = _planck(np.asarray(freq, np.float64), 1.0e4)
    return (FACTOR * 4.0 * np.pi * 1.0e-13 * scale * bnu
            / (PLANCK * freq) * dust.kabs(freq)).astype(np.float32)
