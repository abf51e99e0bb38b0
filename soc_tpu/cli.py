"""Command-line entry points mirroring the reference executables.

  python -m soc_tpu rt soc.ini          ~  ASOC.py soc.ini
  python -m soc_tpu sca soc.ini         ~  ASOCS.py soc.ini
  python -m soc_tpu a2e_pre gs.dust freq.dat out.solver [NE]
                                        ~  A2E_pre.py ...
  python -m soc_tpu a2e solver absorbed emitted [GPU [nstoch [IFREQ [aalg]]]]
                                        ~  A2E.py ... (GPU accepted+ignored)
  python -m soc_tpu eqsolve dust absorbed emitted [GPU]
                                        ~  EQ_solver.py ...
  python -m soc_tpu a2e_lib solver lib freq.dat lfreq.dat abs emit
                    [makelib] [GPU] [ofreq] [bins-a-b-c]
                                        ~  A2E_LIB.py ...
  python -m soc_tpu mabu soc.ini absorbed emitted
                                        ~  A2E_MABU.py ...
  python -m soc_tpu pipeline soc.ini    ~  ASOC_driver.py soc.ini
  python -m soc_tpu dust GRAIN.DAT freq.dat [NE [GL]]
                                        ~  DE_to_GSET.jl (DustEM compiler)
  python -m soc_tpu bench               ~  run the benchmark workload
  python -m soc_tpu sampleini [file]    ~  write a documented sample ini
                                           (WriteSampleIni, ASOC_aux.py:1670)
"""

import os
import sys

import numpy as np


def _usage():
    print(__doc__)
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    # multi-host jobs: jax.distributed init from the environment
    # (SOC_TPU_COORDINATOR / SOC_TPU_DISTRIBUTED=auto); no-op otherwise
    from .parallel.dist import maybe_initialize
    maybe_initialize()
    # --profile[=DIR] wraps the whole command in a jax.profiler trace:
    # per-kernel device timings, HLO names and memory viewer, readable
    # with tensorboard/xprof (in place of the reference's per-kernel
    # OpenCL event timing).  Default output dir: ./soc_profile
    profile_dir = None
    kept = []
    for a in argv:
        if a == "--profile":
            profile_dir = "soc_profile"
        elif a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
        else:
            kept.append(a)
    if profile_dir is not None:
        import jax
        with jax.profiler.trace(profile_dir):
            return _dispatch(kept)
    return _dispatch(kept)


_MIN_ARGS = {"rt": 1, "sca": 1, "a2e_pre": 3, "a2e": 3, "mabu": 3,
             "pipeline": 1, "dust": 2}


def _dispatch(argv):
    if not argv:
        return _usage()
    cmd, args = argv[0], argv[1:]
    if len(args) < _MIN_ARGS.get(cmd, 0):
        print("%s: expected at least %d argument(s)\n"
              % (cmd, _MIN_ARGS[cmd]))
        return _usage()

    if cmd == "rt":
        from .pipeline import driver
        res = driver.run(args[0])
        print("soc_tpu rt done: cells=%d timings=%s"
              % (res.grid.cells,
                 {k: round(v, 2) for k, v in res.timings.items()}))
        return 0

    if cmd == "sca":
        from .pipeline import scattering
        out = scattering.run(args[0])
        print("soc_tpu sca done: outcoming.socs shape", out.shape)
        return 0

    if cmd == "sampleini":
        from .config import RunConfig
        path = args[0] if args else "sample.ini"
        RunConfig.write_sample_ini(path)
        print("wrote", path)
        return 0

    if cmd == "a2e_pre":
        from .solve.grain_model import read_gset_dust
        from .solve import solver_prep
        from .solve.solver_file import write_solver
        dust = read_gset_dust(args[0])
        freq = np.loadtxt(args[1])
        ne = int(args[3]) if len(args) > 3 else 256
        sol = solver_prep.build_solver(dust, freq, ne=ne)
        write_solver(args[2], sol)
        print("wrote %s: NSIZE=%d NFREQ=%d NE=%d"
              % (args[2], sol.nsize, sol.nfreq, sol.ne))
        return 0

    if cmd == "a2e":
        from .solve.solver_file import read_solver
        from .solve import stochastic
        sol = read_solver(args[0])
        # reference argument list (A2E.py:17-30):
        #   solver absorbed emitted [GPU [nstoch [IFREQ [aalg]]]]
        # GPU selects an OpenCL device there -- ALWAYS accepted and
        # ignored here (XLA owns placement) so reference command lines,
        # including bare-integer GPU ids like '0' or '1', run verbatim
        # with unchanged physics. nstoch therefore requires the 5-arg
        # layout: a2e solver absorbed emitted 0 <nstoch>.
        nstoch, ifreq_sel, aalg = 999, None, None
        rest = args[3:]
        if rest:
            if len(rest) > 1:
                nstoch = int(rest[1])
            if len(rest) > 2 and int(rest[2]) >= 0:
                ifreq_sel = int(rest[2])
            if len(rest) > 3:
                # aalg file: int32 CELLS header + float32[CELLS]
                # (A2E.py:382-384); writes polarised emission to
                # <emitted>.P alongside
                with open(rest[3], "rb") as fp:
                    n = int(np.fromfile(fp, np.int32, 1)[0])
                    aalg = np.fromfile(fp, np.float32, n)
                cells_abs = int(np.fromfile(args[1], np.int32, 1)[0])
                if n != cells_abs:
                    raise SystemExit(
                        "a2e: aalg file has %d entries, absorbed has %d"
                        " rows" % (n, cells_abs))
        # out-of-core: stream absorbed.data -> emitted.data through the
        # native double-buffered IO engine (files need not fit in RAM)
        rows = stochastic.solve_emission_streaming(
            sol, args[1], args[2], nstoch=nstoch, aalg=aalg,
            pemitted_path=(args[2] + ".P") if aalg is not None else None,
            ifreq=ifreq_sel)
        print("wrote %s: (%d, %d)"
              % (args[2], rows, 1 if ifreq_sel is not None else sol.nfreq))
        return 0

    if cmd == "a2e_lib":
        # A2E_LIB.py solver lib freq.dat lfreq.dat abs emit [makelib]
        #            [GPU] [ofreq] [bins-a-b-c]   (A2E_LIB.py:13-47)
        # makelib: full A2E solve first, then bin the (absorbed at the
        # reference frequencies -> emission) mapping; uselib: absorbed
        # may carry all nfreq columns or only the nlfreq reference ones.
        # GPU is accepted+ignored; bins-a-b-c maps to the dense grid's
        # per-axis bin count (the largest of a,b,c -- this library is a
        # single dense level, not the reference's 3-level tree).
        from .solve.solver_file import read_solver
        from .solve import stochastic
        from .solve import library as libmod
        sol = read_solver(args[0])
        lib_path = args[1]
        freq = np.atleast_1d(np.loadtxt(args[2]))
        lfreq = np.atleast_1d(np.loadtxt(args[3]))
        f_abs, f_emit = args[4], args[5]
        rest = args[6:]
        makelib = any(r == "makelib" for r in rest)
        nbins = 64
        ofreq = None

        def _numeric(r):
            try:
                float(r)
                return True
            except ValueError:
                return False

        for r in rest:
            if r == "makelib" or r == "GPU":
                continue
            if r.startswith("bins-"):
                nbins = max(int(x) for x in r.split("-")[1:])
            elif _numeric(r):
                pass                    # a GPU/device id -- ignored
            elif os.path.exists(r):
                ofreq = np.atleast_1d(np.loadtxt(r))
            else:
                raise SystemExit("a2e_lib: ofreq file %r not found" % r)
        if len(lfreq) != 3:
            raise SystemExit("a2e_lib: lfreq.dat must list exactly 3 "
                             "reference frequencies (got %d) -- the "
                             "library bins on 3 axes like the "
                             "reference's tree (A2E_LIB.py:535-849)"
                             % len(lfreq))
        from .io.fields import (read_cell_frequency_array,
                                write_cell_frequency_array)
        absorbed = read_cell_frequency_array(f_abs)
        ref_idx = [int(np.argmin(np.abs(freq - f0))) for f0 in lfreq]
        if makelib:
            if absorbed.shape[1] != len(freq):
                raise SystemExit("a2e_lib makelib: absorbed must have all"
                                 " %d frequencies" % len(freq))
            emitted = stochastic.solve_emission(sol, absorbed)
            lib = libmod.build_library(absorbed, emitted, ref_idx,
                                       nbins=nbins)
            libmod.save_library(lib_path, lib)
            print("wrote %s: nbins=%d occupancy=%.3f"
                  % (lib_path, lib["nbins"], lib["occupancy"]))
        else:
            lib = libmod.load_library(lib_path)
            if absorbed.shape[1] == len(lfreq):
                # reduced file: columns ARE the reference frequencies
                lib = dict(lib, ref_indices=list(range(len(lfreq))))
            emitted = libmod.solve_with_library(lib, absorbed)
        if ofreq is not None:
            sel = [int(np.argmin(np.abs(freq - f0))) for f0 in ofreq]
            emitted = np.ascontiguousarray(emitted[:, sel])
        write_cell_frequency_array(f_emit, emitted)
        print("wrote %s: (%d, %d)" % (f_emit, *emitted.shape))
        return 0

    if cmd == "eqsolve":
        # EQ_solver.py dust absorbed emitted [GPU] (EQ_solver.py:10-17):
        # standalone equilibrium solve for one simple dust. GPU is a
        # device selector there -- accepted and ignored here. Writes
        # emitted + the reference's companion '<dust>.T' raw-float32
        # temperature file (EQ_solver.py:180).
        from .io.dust import read_simple_dust
        from .io.fields import (read_cell_frequency_array,
                                write_cell_frequency_array)
        from .pipeline.mabu import solve_equilibrium_eqdust
        from .constants import PARSEC
        opt = read_simple_dust(args[0], 1.0)
        kabs = np.asarray(opt.abs_gl, np.float64) / PARSEC  # per unit dens
        absorbed = read_cell_frequency_array(args[1])
        if absorbed.shape[1] != len(opt.freq):
            raise SystemExit("eqsolve: absorbed has %d freqs, dust %d"
                             % (absorbed.shape[1], len(opt.freq)))
        emitted, t = solve_equilibrium_eqdust(kabs, opt.freq, absorbed)
        write_cell_frequency_array(args[2], emitted)
        np.asarray(t, np.float32).tofile(args[0] + ".T")
        print("wrote %s: (%d, %d); T percentiles %.2f %.2f %.2f"
              % (args[2], emitted.shape[0], emitted.shape[1],
                 *np.percentile(t, (10, 50, 90))))
        return 0

    if cmd == "mabu":
        from .config import RunConfig
        from .io.fields import (read_cell_frequency_array,
                                write_cell_frequency_array)
        from .io.dust import read_simple_dust
        from .pipeline.full import (build_components, classify_dusts,
                                    emission_stage, read_abundances)
        cfg = RunConfig(args[0]).validate()
        absorbed = read_cell_frequency_array(args[1])
        cells = absorbed.shape[0]
        # the frequency grid: from the first simple dust or gset solver
        stoch, simple = classify_dusts(cfg)
        if simple:
            freq = read_simple_dust(simple[0], cfg.gl).freq
        else:
            from .solve.grain_model import read_gset_dust
            freq = np.asarray(read_gset_dust(stoch[0]).qfreq)
        cfg.freq = freq
        comps = build_components(cfg, freq)
        abu = read_abundances(cfg, cells, len(comps))
        valid = absorbed[:, 0] > -1e19
        clean = np.where(valid[:, None], absorbed, 0.0).astype(np.float32)
        dens = None
        if cfg.cr_heating >= 3:
            # CR_HEATING mode 3 couples to the gas density (A2E_MABU.py:
            # 99-107); read it from the cloud like the pipeline command
            from .io.cloud import read_cloud
            dens = np.asarray(
                read_cloud(cfg.file_cloud, cfg.kdensity,
                           cfg.max_levels).dens)
        emitted, pemitted = emission_stage(cfg, comps, clean, abu, freq,
                                           dens=dens)
        emitted[~valid] = 0.0
        # output-frequency selection (A2E_MABU.py:316-323 NOFREQ): the
        # optional 4th argument is an ofreq.dat frequency list; otherwise
        # `mapum` / `remit` in the ini limit the emitted columns
        sel = None
        if len(args) > 3:
            ofreq = np.atleast_1d(np.loadtxt(args[3]))
            sel = np.asarray([int(np.argmin(np.abs(freq - f0)))
                              for f0 in ofreq])
        elif cfg.single_map_freq:
            sel = np.asarray([int(np.argmin(np.abs(freq - f0)))
                              for f0 in cfg.single_map_freq])
        elif cfg.remit_f[0] > 0.0 or cfg.remit_f[1] < 1e30:
            from .pipeline.driver import remit_mask_of
            sel = np.nonzero(remit_mask_of(cfg, freq))[0]
        if sel is not None and len(sel) < len(freq):
            emitted = np.ascontiguousarray(emitted[:, sel])
        write_cell_frequency_array(args[2], emitted)
        print("wrote %s: %s" % (args[2], emitted.shape))
        if pemitted is not None:
            # polarised emission (`polarisation` keyword) -> <emitted>.P
            # (A2E_MABU.py:589, 651-656)
            pemitted[~valid] = 0.0
            if sel is not None and len(sel) < len(freq):
                pemitted = np.ascontiguousarray(pemitted[:, sel])
            write_cell_frequency_array(args[2] + ".P", pemitted)
        return 0

    if cmd == "pipeline":
        from .pipeline.full import run_pipeline
        mode = args[1] if len(args) > 1 else None
        run_pipeline(args[0], mode=mode)
        print("soc_tpu pipeline done" + (" (%s)" % mode if mode else ""))
        return 0

    if cmd == "dust":
        # DustEM -> SOC dust compilation (the DE_to_GSET.jl workflow):
        #   python -m soc_tpu dust GRAIN.DAT freq.dat [NE [GL_pc]]
        # writes, per species: <name>.dust (gset container + .opt/.ent/
        # .size), <name>.solver, <name>.dsc, <name>_simple.dust; plus the
        # combined tmp.dust / tmp.dsc for the RT stage.
        from .io.dust import write_simple_dust
        from .solve import dust_compiler as dc
        from .solve import solver_prep
        from .solve.grain_model import write_gset_dust
        from .solve.solver_file import write_solver
        grain_path, freq_path = args[0], args[1]
        ne = int(args[2]) if len(args) > 2 else 128
        gl = float(args[3]) if len(args) > 3 else 1.0
        freq = np.sort(np.atleast_1d(np.loadtxt(freq_path)))
        dusts = dc.compile_dustem_model(grain_path)
        per_opt = []
        for d in dusts:
            opt = dc.effective_optics(d, freq, gl)
            per_opt.append(opt)
            write_simple_dust("%s_simple.dust" % d.name, opt, gl)
            dsc, csc = dc.tabulated_scattering_function(d, freq)
            dc.write_scattering_file("%s.dsc" % d.name, dsc, csc)
            if d.c_cap is not None:
                gset = dc.to_gset(d)
                write_gset_dust("gs_%s.dust" % d.name, gset, ne=ne)
                sol = solver_prep.build_solver(gset, freq, ne=ne)
                write_solver("%s.solver" % d.name, sol)
            print("compiled %s: nsize=%d%s" % (
                d.name, d.nsize,
                "" if d.c_cap is not None else " (no C data: eq-only)"))
        write_simple_dust("tmp.dust", dc.combine_optics(per_opt), gl)
        dsc, csc = dc.combined_scattering_function(dusts, freq)
        dc.write_scattering_file("tmp.dsc", dsc, csc)
        print("wrote combined tmp.dust / tmp.dsc (%d species, %d freqs)"
              % (len(dusts), len(freq)))
        return 0

    if cmd == "bench":
        import runpy
        runpy.run_path(os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "bench.py"),
            run_name="__main__")
        return 0

    return _usage()


if __name__ == "__main__":
    sys.exit(main())
