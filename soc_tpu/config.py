"""Run configuration: the ini-file dialect of the reference.

Parses the same whitespace-separated keyword files as the reference's ``User``
class (ASOC_aux.py:79-554): one keyword + arguments per line, ``#`` comments,
keyword matching by prefix. Unknown keywords are retained in ``self.keys`` so
feature code can probe them (the reference's ``'CLT' in USER.KEYS`` pattern).

Only semantics differ where the reference's OpenCL bookkeeping is meaningless
under XLA (device/platform/local/global/fission/batch, the mmapabs/mmapemit host
mmap switches and the solveondev/xemonhost work-placement flags are accepted
and retained in ``self.keys`` -- XLA owns those decisions here). Three
reference keywords are parsed but never consumed by the reference itself
(`bgmethod`: -D define no kernel reads; `dustfile`, `sourcemap`: assigned,
never used -- ASOC_aux.py:320-322,336,403); they are likewise key-retained
only, as is `radiusalign` (sets USER.ALIGN_DAT, which nothing in the
reference ever reads -- ASOC_aux.py:236,337; grain alignment is instead
driven by the `polarisation dust aalg_file` route implemented here).
`DEFS` (raw extra -D macro strings injected into the OpenCL compile,
ASOC_aux.py:250) is OpenCL-compiler plumbing with no XLA analog --
key-retained. `polsim` (ASOC_aux.py:462) is an unfinished reference
experiment:
its only consumer switches read_dust to a 6-tuple return
(ASOC_aux.py:1962) that every caller unpacks as 4 values (ASOC.py:112,
ASOCS.py:21), so any ini setting it crashes the reference before
simulating -- key-retained here, not implemented.
"""

import os
from math import pi

import numpy as np

from .constants import um2f


class RunConfig:
    def __init__(self, ini_path=None, text=None):
        # --- model & files
        self.file_cloud = ""
        self.file_optical = []          # dust files (1 per dust population)
        self.file_scafunc = []          # dsc files
        self.file_abundance = []
        self.file_background = ""
        self.file_hpbg = ""
        self.file_pointsource = []
        self.file_absorbed = "absorbed.data"
        self.file_emitted = "emitted.data"
        self.file_temperature = ""
        self.file_intensity = "ISRF.DAT"
        self.save_intensity = 0
        self.file_checkpoint = ""
        self.checkpoint_every = 1
        self.file_diffuse = ""
        self.file_constant_load = ""
        self.file_constant_save = ""
        self.file_savetau = ""
        self.file_pssavetau = ""
        self.pssavetau_freq = -1.0
        self.file_polred = ""
        self.file_external_mask = ""
        # --- ROI save/load (reference WITH_ROI_SAVE / WITH_ROI_LOAD)
        self.roi = None                 # [x0, x1, y0, y1, z0, z1] root cells
        self.roi_map = 0                # maps from ROI emission only
        self.file_roi_save = ""
        self.roi_step = 1
        self.file_roi_load = ""
        self.roi_load_scale = 1.0
        self.roi_nside = 8
        # --- library / NN emission surrogates
        self.fselect = []               # reference frequencies [Hz]
        self.lib_abs = False
        self.lib_maps = False
        self.file_library = ""
        self.nn_make = ""               # train surrogate, save to this file
        self.nn_solve = ""              # load surrogate from this file
        self.nn_abs = []                # input wavelengths [um]
        self.nn_emit = []               # output wavelengths [um]
        self.nn_net = (13, 17, 13)
        self.nn_thin = 1
        self.abs_thin = 1
        self.nnn_limit = 0.0            # density floor for absorbed/NN cells
        self.aalg = {}                  # dust name -> aalg file (polarised
        #                                 emission, A2E_MABU.py:158-167)
        self.file_scattering = "scattering"   # ASOCS FITS output name
        self.b_files = []
        self.prefix = "soc"
        # --- geometry / scaling
        self.gl = 0.0                   # root cell size [pc]
        self.kdensity = 1.0
        self.distance = 0.0
        self.max_levels = 999
        self.map_dx = 1.0
        self.npix = (10, 10)
        self.mapcentre = (-1e12, 0.0, 0.0)
        self.intobs = (-1e12, 0.0, 0.0)
        self.obs_theta = []             # radians
        self.obs_phi = []
        self.ne_number = 0              # 0 = caller default
        self.level_threshold = 0
        self.y_shear = 0.0
        self.minlos = -1.0
        self.maxlos = 1.0e10
        self.mirror = ""
        # --- packets
        self.bgpac = 0
        self.pspac = 0
        self.clpac = 0
        self.dfpac = 0
        self.roipac = 0
        self.ps_method = 0
        self.no_ps = 0
        self.ps_pos = np.zeros((0, 3), np.float32)
        self.ps_scale = []
        self.scale_background = 1.0
        self.do_split = 0
        self.n_domains = 0
        self.n_devices = 0
        self.mmap_absorbed = 0
        # --- simulation control
        self.iterations = 1
        self.seed = pi / 4.0
        self.nosolve = False
        self.noabsorbed = False
        self.nomap = False
        self.load_temperature = False
        self.sim_f = (1.0e8, 1.0e17)
        self.remit_f = (0.0, 1e30)
        self.map_freq = (1.0e6, 1.0e18)
        self.single_map_freq = []
        self.savetau_freq = []
        self.with_ali = 0
        self.with_reference = 0
        self.ffs = 1
        self.step_weight = (-1, 0.0, 0.0)
        self.dir_weight = (-1, 0.0, 0.0)
        self.use_emweight = 0
        self.emweight_skip = 3
        self.emweight_lim = (0.0, 1e10, 0.0)
        self.dsc_bins = 0
        self.optishalf = False
        self.k_diffuse = 1.0
        self.cr_heating = 0.0
        self.interpolate = 0
        self.map_interpolation = 0
        self.fast_map = -1
        self.polmap = 0
        self.polstat = 0
        self.pol_rho_weight = False     # density- vs emission-weighted IQU
        self.p0 = 0.2
        self.fits = 0
        self.fits_ra = 0.0              # FITS centre coordinates [deg]
        self.fits_de = 0.0
        self.fits_prefix = "map"        # ASOC_aux.py:218 FITS_PREFIX
        self.verbose = 0
        self.batch = 30
        self.device = ""                # accepted, ignored (XLA places work)
        self.keys = {}                  # every keyword kept verbatim
        # filled in by the pipeline after reading the model:
        self.nfreq = 0
        self.freq = None

        if text is None and ini_path is not None:
            with open(ini_path) as fp:
                text = fp.read()
        if text is not None:
            self._parse(text)

    # -- parsing ---------------------------------------------------------
    def _parse(self, text):
        for raw in text.splitlines():
            line = raw.split("#")[0].strip()
            if not line:
                continue
            s = line.split()
            key, args = s[0], s[1:]
            self.keys.setdefault(key, []).append(args)
            self._apply(key, args)

    def _apply(self, key, a):
        def f(i=0):
            return float(a[i])

        def n(i=0):
            return int(round(float(a[i])))

        if key.startswith("gridlen"):
            self.gl = f()
        elif key.startswith("cloud"):
            self.file_cloud = a[0]
        elif key.startswith("optic"):
            self.file_optical.append(a[0])
        elif key.startswith("dsc"):
            self.file_scafunc.append(a[0])
            if len(a) > 1:
                self.dsc_bins = int(a[1])
        elif key.startswith("abunda"):
            self.file_abundance.append(a[0])
        elif key.startswith("backg"):
            self.file_background = a[0]
            if len(a) > 1:
                self.scale_background = f(1)
        elif key.startswith("hpbg"):
            self.file_hpbg = a[0]
            if len(a) > 1:
                self.scale_background = f(1)
        elif key.startswith("pointsou"):
            # pointsource  x y z  file [scale]
            pos = np.asarray([f(0), f(1), f(2)], np.float32)
            self.ps_pos = np.vstack([self.ps_pos, pos[None]])
            self.file_pointsource.append(a[3] if len(a) > 3 else "")
            self.ps_scale.append(f(4) if len(a) > 4 else 1.0)
            self.no_ps += 1
        elif key.startswith("diffus"):
            self.file_diffuse = a[0]
            if len(a) > 1:
                self.k_diffuse = f(1)
        elif key.startswith("absorb"):
            if a:
                self.file_absorbed = a[0]
        elif key.startswith("emit"):
            if a:
                self.file_emitted = a[0]
        elif key.startswith("tempera"):
            self.file_temperature = a[0]
        elif key.startswith("cload"):
            self.file_constant_load = a[0]
        elif key.startswith("csave"):
            self.file_constant_save = a[0]
        elif key.startswith("pssavetau"):
            self.file_pssavetau = a[0]
            self.pssavetau_freq = um2f(f(1)) if len(a) > 1 else -1.0
        elif key.startswith("savetau"):
            # savetau filename um1 um2 ...; negative um => column density
            # (ASOC_aux.py:287-293)
            if len(a) >= 2:
                self.file_savetau = a[0]
                for x in a[1:]:
                    x = float(x)
                    self.savetau_freq.append(um2f(x) if x > 0 else 0.0)
        elif key.startswith("prefix"):
            self.prefix = a[0]
        elif key.startswith("density"):
            self.kdensity = f()
        elif key.startswith("distance"):
            self.distance = f()
        elif key.startswith("levels"):
            self.max_levels = n()
        elif key.startswith("mapum"):
            # individual map frequencies (ASOC_aux.py:255-261)
            self.single_map_freq = sorted(
                set(self.single_map_freq) | {um2f(float(x)) for x in a})
        elif key.startswith("mapping"):
            self.npix = (n(0), n(1))
            if len(a) > 2:
                self.map_dx = f(2)
            if len(a) > 3:
                # 4th argument = FAST_MAP; >=999 selects MAP_HIER per-level
                # maps (ASOC_aux.py:493, ASOC.py:2903)
                self.fast_map = n(3)
        elif key.startswith("mapcent"):
            self.mapcentre = (f(0), f(1), f(2))
        elif key.startswith("perspec"):
            self.intobs = (f(0), f(1), f(2))
        elif key.startswith("direct"):
            # observer directions: theta phi [theta phi ...] in degrees
            vals = [float(x) for x in a]
            for i in range(0, len(vals) - 1, 2):
                self.obs_theta.append(vals[i] * pi / 180.0)
                self.obs_phi.append(vals[i + 1] * pi / 180.0)
        elif key.startswith("mapview"):
            # single-view spec replacing direction/mapping/mapcentre:
            #   mapview theta phi [NX NY [dx [Xc Yc Zc]]]  (ASOC_aux.py:498)
            if len(a) >= 2:
                self.obs_theta = [f(0) * pi / 180.0]
                self.obs_phi = [f(1) * pi / 180.0]
                if len(a) >= 4:
                    self.npix = (n(2), n(3))
                    if len(a) >= 5:
                        self.map_dx = f(4)
                        if len(a) >= 8:
                            self.mapcentre = (f(5), f(6), f(7))
        elif key.startswith("nenumber"):
            # enthalpy-grid size for generated .solver files
            # (ASOC_driver.py:93,131-132)
            self.ne_number = n()
        elif key.startswith("bgpac"):
            self.bgpac = n()
        elif key.startswith("pspac"):
            self.pspac = n()
        elif key.startswith("psmetho"):
            self.ps_method = n()
        elif key.startswith("cellpac"):
            self.clpac = n()
        elif key.startswith("diffpac"):
            self.dfpac = n()
        elif key.startswith("roipac"):
            self.roipac = n()
        elif key.startswith("roinside"):
            self.roi_nside = n()
        elif key.startswith("roimap"):
            # maps include only emission from inside the ROI box
            # (ASOC_aux.py:285, -D ROI_MAP in kernel_ASOC_map.c)
            self.roi_map = 1
        elif key.startswith("roisave"):
            # roisave filename step (ASOC_aux.py:448-451)
            self.file_roi_save = a[0]
            if len(a) > 1:
                self.roi_step = n(1)
        elif key.startswith("roiload"):
            self.file_roi_load = a[0]
            if len(a) > 1:
                self.roi_load_scale = f(1)
        elif key == "roi" and len(a) >= 6:
            self.roi = [int(float(x)) for x in a[:6]]
        elif key.startswith("libabs"):
            self.fselect = sorted(um2f(float(x)) for x in a) if len(a) > 1 \
                else list(np.atleast_1d(np.loadtxt(a[0])).astype(float))
            self.lib_abs = True
        elif key.startswith("libmap"):
            self.fselect = sorted(um2f(float(x)) for x in a) if len(a) > 1 \
                else list(np.atleast_1d(np.loadtxt(a[0])).astype(float))
            self.lib_maps = True
        elif key.startswith("library"):
            self.file_library = a[0]
        elif key.startswith("nnmake"):
            self.nn_make = a[0]
        elif key.startswith("nnsolve"):
            self.nn_solve = a[0]
        elif key.startswith("nnabs"):
            self.nn_abs = sorted(float(x) for x in a)
        elif key.startswith("nnemit"):
            self.nn_emit = sorted(float(x) for x in a)
        elif key.startswith("nnnet"):
            self.nn_net = tuple(int(float(x)) for x in a)
        elif key.startswith("nnnlimit"):
            # density threshold: cells with DENS <= limit are marked -1e20
            # in the absorbed file, excluding them from the solve / NN
            # training sample (ASOC.py:2808-2825)
            self.nnn_limit = f()
        elif key.startswith("nnthin"):
            self.nn_thin = n()
        elif key.startswith("absthin"):
            self.abs_thin = n()
        elif key.startswith("polari"):
            # 'polarisation dust_name aalg_file': also save the polarised
            # emission of this dust (grains a >= aalg[cell]) to
            # <emitted>.P (A2E_MABU.py:158-167, 615-637)
            if len(a) >= 2:
                self.aalg[os.path.basename(a[0]).replace(".dust", "")] = a[1]
        elif key.startswith("dustem"):
            # DustEM coupling: skip the absorbed file, save the radiation
            # field intensities instead (ASOC_aux.py:279-281)
            self.noabsorbed = True
            self.save_intensity = max(1, self.save_intensity)
        elif key.startswith("scatter"):
            # output-name stem for ASOCS FITS images (ASOC_aux.py:104,326)
            self.file_scattering = a[0]
        elif key.startswith("iterations"):
            self.iterations = n()
        elif key.startswith("seed"):
            self.seed = float(np.clip(f(), -1.0, 1.0))
        elif key.startswith("nosolve"):
            self.nosolve = True
        elif key.startswith("noabs"):
            self.noabsorbed = True
        elif key.startswith("nomap"):
            self.nomap = True
        elif key.startswith("loadtemp"):
            self.load_temperature = True
        elif key.startswith("forcedfirst") or key.startswith("ffs"):
            self.ffs = n()
        elif key.startswith("ali") and not key.startswith("alibeta"):
            self.with_ali = n()
        elif key.startswith("alibeta"):
            # beta(T, tau) refinement flag: probed via has_key (driver)
            pass
        elif key.startswith("reference"):
            self.with_reference = n()
        elif key.startswith("emwei"):
            self.use_emweight = n(0)
            if len(a) > 2:
                self.emweight_lim = (f(1), f(2), f(3) if len(a) > 3 else 0.0)
                if len(a) > 4:
                    self.emweight_skip = n(4)
        elif key.startswith("stepwei"):
            self.step_weight = (n(0), f(1) if len(a) > 1 else 0.0,
                                f(2) if len(a) > 2 else 0.0)
        elif key.startswith("direwei"):
            # direweight mode A: importance-sample scatter directions from
            # HG(A) with p(DSC)/p(HG) weight correction (WScatter,
            # kernel_ASOC_aux.c:567)
            self.dir_weight = (n(0), f(1) if len(a) > 1 else 0.0, 0.0)
        elif key.startswith("optishalf"):
            self.optishalf = True
        elif key.startswith("simum"):
            self.sim_f = (um2f(f(1)), um2f(f(0)))
        elif key.startswith("remit"):
            self.remit_f = (um2f(f(1)), um2f(f(0)))
        elif key.startswith("wavelen"):
            # 'wavelength um_long um_short' -> map-frequency band
            # (ASOC_aux.py:446 MAP_FREQ); a single value selects the
            # nearest frequency only.
            freqs = sorted(um2f(float(x)) for x in a)
            if len(freqs) >= 2:
                self.map_freq = (freqs[0], freqs[-1])
            else:
                self.single_map_freq = list(freqs)
        elif key.startswith("split"):
            # packet splitting at refinement boundaries (reference
            # SimBgSplit); here: stratified per-element budgets, arg =
            # boost factor (default 8)
            self.do_split = n() if a else 8
        elif key.startswith("domains"):
            # Z-slab spatial domain decomposition over the dp mesh axis
            # (parallel/domain.py); arg = slab/device count
            self.n_domains = n()
        elif key.startswith("threshold"):
            self.level_threshold = n()
        elif key.startswith("yshear"):
            self.y_shear = f()
        elif key.startswith("mirror"):
            self.mirror = a[0] if a else ""
        elif key.startswith("mmapabs"):
            # host-resident per-frequency absorption tally (the reference
            # mmaps FABSORBED, ASOC.py:623-638): the [CELLS, NFREQ] array
            # never lives in device memory; columns stream back per channel
            self.mmap_absorbed = n() if a else 1
        elif key.startswith("devices"):
            # multi-chip product path: shard every phase over N devices
            # on a (dp x freq) mesh (parallel/product.py); bare keyword
            # (or 0) = all visible devices
            self.n_devices = (n() or -1) if a else -1
        elif key.startswith("device"):
            self.device = a[0] if a else ""
        elif key.startswith("batch"):
            self.batch = n()
        elif key.startswith("verbose"):
            self.verbose = n()
        elif key.startswith("polmap"):
            # 'polmap Bx By Bz [minlos] [maxlos]' (ASOC_aux.py:466-474) or
            # the bare flag form 'polmap [1]' with a separate Bfiles line
            if len(a) >= 3:
                self.polmap = 1
                self.b_files = list(a[:3])
                if len(a) == 4:
                    self.maxlos = f(3)
                elif len(a) > 4:
                    self.minlos = f(3)
                    self.maxlos = f(4)
            else:
                self.polmap = max(1, n() if a else 1)
        elif key.startswith("polstat"):
            self.polstat = n()
        elif key.startswith("polrho"):
            # 'polrhoweight': weight the Stokes integrand by density alone
            # instead of attenuated emission (ASOC_aux.py:284,
            # kernel_ASOC_map.c:1092 POL_RHO_WEIGHT)
            self.pol_rho_weight = True
        elif key.startswith("polred"):
            self.file_polred = a[0]
        elif key.startswith("p0"):
            self.p0 = f()
        elif key.startswith("Bfiles") or key.startswith("bfiles"):
            self.b_files = list(a[:3])
        elif key.startswith("mapint"):
            self.map_interpolation = n()
        elif key.startswith("FITS") or key.startswith("fits"):
            # FITS [ra de [prefix]]: per-frequency FITS maps with optional
            # centre coordinates [deg] and filename prefix
            # (ASOC_aux.py:299-305, ASOC.py:3144)
            self.fits = 1
            if len(a) >= 2:
                self.fits_ra = f(0)
                self.fits_de = f(1)
                if len(a) >= 3:
                    self.fits_prefix = a[2]
            elif a:
                self.fits = n()
        elif key.startswith("checkpoint"):
            # checkpoint file [every_n_units]: mid-run preemption recovery
            self.file_checkpoint = a[0]
            if len(a) > 1:
                self.checkpoint_every = n(1)
        elif key.startswith("saveint"):
            # saveint mode [file]: 1 = scalar intensity, 2 = (I,Ix,Iy,Iz)
            # (ASOC_aux.py:404-407)
            self.save_intensity = n() if a else 1
            if len(a) > 1:
                self.file_intensity = a[1]
        elif key.startswith("externalm"):
            self.file_external_mask = a[0]
        elif key.startswith("interpol"):
            self.interpolate = f()
        elif key.startswith("CR_HEATING"):
            self.cr_heating = f()
        # everything else: retained in self.keys only

    # -- helpers ---------------------------------------------------------
    def has_key(self, key):
        return key in self.keys

    @staticmethod
    def write_sample_ini(path):
        """Emit a fully documented sample ini covering every supported
        keyword (the reference's WriteSampleIni, ASOC_aux.py:1670-1721)."""
        with open(path, "w") as fp:
            fp.write(SAMPLE_INI)

    def validate(self):
        if not self.file_cloud:
            raise ValueError("ini: missing 'cloud' keyword")
        if not self.file_optical:
            raise ValueError("ini: missing 'optical' keyword")
        if self.gl <= 0:
            raise ValueError("ini: missing/invalid 'gridlength'")
        for path in [self.file_cloud] + self.file_optical + self.file_scafunc:
            if path and not os.path.exists(path):
                raise FileNotFoundError(path)
        if not self.obs_theta:
            self.obs_theta = [0.5 * pi]
            self.obs_phi = [0.0]
        if self.clpac < 1:
            # ASOC.py:238 -- emission weighting is tied to the CLPAC
            # budget; with no cell packets the reference disables it
            # (including for the diffuse source, despite ASOC.py:548's
            # aspirational comment)
            self.use_emweight = 0
        return self


SAMPLE_INI = """\
# soc_tpu sample ini -- every supported keyword, with defaults and units.
# One keyword + arguments per line; '#' starts a comment; keywords match by
# prefix (the reference ASOC dialect). Lines commented out below are
# optional features.

# ---- model ------------------------------------------------------------
gridlength      0.01                # root-cell size [pc] (required)
cloud           tmp.cloud           # density model, possibly octree (required)
density         1.0                 # multiplier applied to cloud densities
optical         tmp.dust            # dust optical data; repeat per population
dsc             tmp.dsc 2500        # scattering functions DSC/CSC [+ bins]
# abundance     abu1.bin            # per-cell abundance file, one per dust
# levels        999                 # cut octree below this many levels
# threshold     0                   # ignore cells below this hierarchy level

# ---- radiation sources ------------------------------------------------
background      bg_intensity.bin    # isotropic background [+ scale]
# hpbg          sky.bin 1.0         # Healpix (NSIDE=64 RING) background sky
# pointsource   32.0 32.0 32.0 ps.bin 1.0   # x y z  intensity-file [scale]
# psmethod      0                   # external-PS sampling method 0-5
# diffuse       field.bin 1.0       # per-cell diffuse emission [+ k scale]
# roi           8 23 8 23 8 23      # region-of-interest box [root cells]
# roisave       roi.photons 1       # record packets entering the ROI
# roiload       roi.photons 1.0     # re-inject a recorded ROI file [scale]
# roinside      8                   # healpix NSIDE of the ROI histograms

# ---- packet counts ----------------------------------------------------
bgpackets       999999              # background packets per frequency
# pspackets     100000              # point-source packets per frequency
cellpackets     999999              # cell-emission packets per iteration
# diffpack      100000              # diffuse-source packets per frequency
# roipackets    100000              # ROI re-injection packets per frequency

# ---- simulation control -----------------------------------------------
seed            1.0                 # RNG seed in [-1, 1]
iterations      1                   # dust self-heating iterations
# simum         0.09 1000.0         # simulate only this band [um_min um_max]
# remit         0.09 1000.0         # re-emit only inside this band [um]
# ali           1                   # accelerated lambda iteration (XAB/XEM)
# reference     1                   # WITH_REFERENCE control variate; AABB
#                                   # encodes total/first iteration over runs
# SUBITERATIONS                     # hot/cold cell sub-iteration scheme
# emweight      1 0 100             # emission-weighted packets + roulette
#                                   #   mode 2 = deterministic quotas;
#                                   #   args: mode min max [ignore [skip]]
# stepweight    1 0.5               # stretched free paths: 1 A (single
#                                   #   exponential) or 2 A B (mixture)
# direweight    0 0.5               # HG importance-sampled deflections
# split         8                   # packet splitting on octree refinement
# forcedfirst   1                   # forced first scattering (scattered light)
# mirror        xX                  # mirror boundaries on the named faces
# optishalf                         # store per-cell OPT in bfloat16
# CR_HEATING    1.0                 # cosmic-ray heating mode/rate
# checkpoint    run.ckpt 1          # mid-run preemption checkpoint [every N]
# devices       8                   # shard EVERY phase over N chips on a
#                                   # (dp x freq) mesh; bare keyword = all
# domains       8                   # Z-slab domain decomposition over N
#                                   # devices (bg + cell emission; needs
#                                   # noabsorbed and NZ divisible by N)

# ---- outputs ----------------------------------------------------------
prefix          soc                 # output name prefix
absorbed        absorbed.data       # per-cell absorptions [CELLS, NFREQ]
emitted         emitted.data        # per-cell emission [CELLS, NFREQ]
temperature     soc.T               # equilibrium-dust temperature field
# noabsorbed                        # skip the absorbed-file output
# nosolve                           # skip the temperature/emission solve
# nomap                             # skip map rendering
# loadtemp                          # recompute emission from 'temperature'
# cload         ctabs.save          # load integrated constant-source heating
# csave         ctabs.save          # save it (skip phase 1 next run)
# saveint       1 ISRF.DAT          # intensity file; 2 = (I, Ix, Iy, Iz)
# savetau       tau.map 250.0 -1.0  # tau map at um (>0) / column density (<0)
# pssavetau     pstau 250.0         # LOS tau from each point source

# ---- maps -------------------------------------------------------------
mapping         64 64 1.0           # NX NY pixel-size [root cells] [FASTMAP]
directions      0.0 0.0             # observer theta phi [deg]; repeatable
# mapview       0.0 0.0 64 64 1.0 32 32 32   # one-line view spec
# mapcentre     32.0 32.0 32.0      # map centre [root-grid coordinates]
# mapum         250.0 500.0         # render only these wavelengths [um]
# wavelength    1000.0 0.1          # map band [um_long um_short]
# perspective   32.0 32.0 32.0      # internal observer -> panorama
#                                   # (mapping N 0 renders healpix NSIDE=N)
# distance      100.0               # source distance [pc] (FITS scaling)
# FITS          1                   # per-frequency FITS maps; or
#                                   #   'FITS ra de [prefix]' to set the
#                                   #   WCS centre [deg] + filename stem
# mapint        1                   # bilinear cross-ray map interpolation
# yshear        0.0                 # shearing-box periodic map continuation

# ---- polarization -----------------------------------------------------
# polmap        Bx.bin By.bin Bz.bin [minlos maxlos]   # Stokes I,Q,U maps
# polstat       1                   # 1/3: B statistics, 2: replicated IQU
# polred        R.bin               # polarization-reduction factor file
# p0            0.2                 # intrinsic polarization fraction
# polarisation  gs_aSilx.dust a.alg # per-cell aligned-size file: also
#                                   # write polarised emission <emitted>.P

# ---- stochastic heating / surrogates ----------------------------------
# nenumber      128                 # enthalpy bins for generated .solver
# libabs        0.55 21.0 500.0     # simulate only reference um, then stop
# libmaps       0.55 21.0 500.0     # maps from library-solved emission
# library       dust.lib            # emission-library file
# nnmake        dust.nn             # train an MLP emission surrogate
# nnsolve       dust.nn             # solve emission with a trained MLP
# nnabs         0.55 21.0 500.0     # surrogate input wavelengths [um]
# nnemit        100.0 250.0 850.0   # surrogate output wavelengths [um]
# nnnet         13 17 13            # MLP hidden-layer widths
# nnthin        1                   # train on every Nth cell
# absthin       1                   # subsample absorption cells
# nnnlimit      1.0e3               # exclude cells with density <= limit
# dustem                            # DustEM coupling: write intensities,
#                                   # skip the absorbed file
# scattering    scat                # ASOCS FITS output name stem (fits 1)

# ---- accepted for compatibility, ignored ------------------------------
# device        g
# batch         30
# verbose       1
"""
