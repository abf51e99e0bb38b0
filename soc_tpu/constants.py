"""Physical constants and unit conventions shared across the framework.

The numerical values (and the 1e20 ``FACTOR`` photon-count scaling convention)
match the reference implementation (cf. ASOC_aux.py:26-43) so
that on-disk artifacts (absorbed.data, emitted.data, *.T, map_dir_XX.bin) are
bit-compatible in format and allclose in value.
"""

import numpy as np

# cgs constants (float64 on host; device code downcasts as needed)
C_LIGHT = 2.99792458e10       # speed of light [cm/s]
PLANCK = 6.62606957e-27       # Planck constant [erg s]
BOLTZMANN = 1.3806488e-16     # Boltzmann constant [erg/K]
STEFAN_BOLTZMANN = 5.670373e-5
PARSEC = 3.08567758e18        # parsec [cm]
AMU = 1.6605e-24

H_K = PLANCK / BOLTZMANN      # 4.79924335e-11  [K s]
H_CC20 = 1.0e20 * PLANCK / C_LIGHT**2  # Planck-law prefactor carrying 1e20

# Global photon-number scaling: all device-side photon counts carry FACTOR to
# keep float32 tallies in a safe exponent range.
FACTOR = 1.0e20

# Kernel tally scaling knob (reference: ASOC.py:80-81).
ADHOC = 1.0

# Emission-rate prefactor 8 pi / c^2 = 2.79639459e-20 shared by the
# equilibrium/stochastic emission integrals (kernel_ASOC_aux.c Emission,
# kernel_A2E_pre.c EA rows): photons/Hz/H = EMIT_COEFF * freq^2 * kabs /
# (exp(h nu / k T) - 1).
EMIT_COEFF = 8.0 * np.pi / C_LIGHT**2

# Geometry epsilons -- the float32 epsilon discipline of the reference ray
# stepper (kernel_ASOC_aux.c:99-119). Values are load-bearing: they encode the
# over-step that pushes a ray across a cell boundary.
PEPS = 1.0e-4                 # position epsilon, over-step at cell boundaries
DEPS = 5.0e-5                 # direction epsilon, avoid axis-aligned rays
EPS = 5.0e-4                  # map-ray surface clamp epsilon
DPEPS = 2.0e-5                # double-precision variant for huge root grids
TAULIM = 5.0e-4               # Taylor-expansion threshold for 1-exp(-tau)
PHOTON_LIMIT = 1.0e-30

MAX_SCATTERINGS = 20          # hard cap per packet (kernel_ASOC.c:804)

SEED0 = 0.8150982470475214    # host-side seed scramblers (ASOC_aux.py:42-43)
SEED1 = 0.1393378751427912


def planck_intensity(freq, T):
    """Planck intensity B_nu(T) = 2 h nu^3/c^2 / (exp(h nu/kT) - 1), cgs.

    (The 1e-20 literal cancels H_CC20's 1e20: this is the TRUE intensity,
    matching the reference's PlanckSafe, ASOC_aux.py:60-62.)
    Works with numpy arrays; exponent clipped for numerical safety.
    """
    freq = np.asarray(freq, np.float64)
    x = np.clip(H_K * freq / np.maximum(np.asarray(T, np.float64), 1e-30), -100, 100)
    return 2.0e-20 * ((H_CC20 * freq) * freq) * freq / (np.exp(x) - 1.0)


def um2f(um):
    """Wavelength [um] -> frequency [Hz]."""
    return 1.0e4 * C_LIGHT / um


def f2um(f):
    """Frequency [Hz] -> wavelength [um]."""
    return 1.0e4 * C_LIGHT / f
