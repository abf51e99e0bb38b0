"""A2E stochastic solver: vectorized device path vs direct loop reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from soc_tpu.solve.solver_file import (SolverData, SizeData, read_solver,
                                       write_solver, densify_weights)
from soc_tpu.solve import a2e_reference, stochastic


def random_solver(ne=16, nfreq=8, nsize=2, seed=0):
    """Random but structurally valid solver data (sparse Iw bands)."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(11, 14, nfreq).astype(np.float32)
    sizes = []
    sk_abs = rng.random((nsize, nfreq)).astype(np.float32) + 0.1
    for s in range(nsize):
        l1 = np.full((ne, ne), -1, np.int32)
        l2 = np.full((ne, ne), -2, np.int32)
        iw_list = []
        for l in range(ne - 1):
            for u in range(l + 1, ne):
                if rng.random() < 0.3:
                    continue          # empty band
                a = int(rng.integers(0, nfreq - 1))
                b = int(rng.integers(a, nfreq))
                l1[l, u] = a
                l2[l, u] = b
                iw_list.append(rng.random(b - a + 1).astype(np.float32))
        iw = np.concatenate(iw_list) if iw_list else np.zeros(0, np.float32)
        tdown = (rng.random(ne) * 10 + 0.1).astype(np.float32)
        tdown[0] = 0.0
        ea = rng.random((nfreq, ne)).astype(np.float32)
        ibeg = rng.integers(0, ne // 2, nfreq).astype(np.int32)
        sizes.append(SizeData(iw, l1, l2, tdown, ea, ibeg))
    s_frac = np.full(nsize, 1.0 / nsize, np.float32)
    return SolverData(freq=freq, grain_density=1e-7,
                      size_a=np.logspace(-7, -5, nsize).astype(np.float32),
                      s_frac=s_frac, ne=ne, sk_abs=sk_abs, sizes=sizes)


def dosolve_reference(solver, isize, absorbed_row):
    """Float64 loop port of DoSolve for one cell (a2e_reference)."""
    return a2e_reference.dosolve(solver, isize, absorbed_row)[0]


def test_solver_file_roundtrip(tmp_path):
    solver = random_solver()
    path = tmp_path / "t.solver"
    write_solver(path, solver)
    s2 = read_solver(path)
    assert s2.ne == solver.ne and s2.nsize == solver.nsize
    np.testing.assert_array_equal(s2.sk_abs, solver.sk_abs)
    for a, b in zip(s2.sizes, solver.sizes):
        np.testing.assert_array_equal(a.iw, b.iw)
        np.testing.assert_array_equal(a.l1, b.l1)
        np.testing.assert_array_equal(a.tdown, b.tdown)
        np.testing.assert_array_equal(a.ea, b.ea)
        np.testing.assert_array_equal(a.ibeg, b.ibeg)


def test_densify_consumes_full_stream():
    solver = random_solver(ne=24, nfreq=10)
    for sd in solver.sizes:
        w = densify_weights(sd, solver.ne, solver.nfreq)
        # every sparse weight lands in the dense tensor exactly once
        assert np.isclose(w.sum(), sd.iw.sum(), rtol=1e-5)
        # strictly lower-triangular in (u, l)
        for u in range(solver.ne):
            for l in range(u, solver.ne):
                assert np.all(w[l, u] == 0) or l > u


def test_solve_batch_matches_reference():
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=3)
    rng = np.random.default_rng(5)
    absorbed = (rng.random((6, solver.nfreq)) * 10).astype(np.float32)
    for isize in range(solver.nsize):
        w_flat, tdown, ea = stochastic.prepare_size_arrays(solver, isize)
        got = np.asarray(stochastic.solve_batch(
            w_flat, tdown, ea, jnp.asarray(absorbed), solver.ne))
        for c in range(absorbed.shape[0]):
            expect = dosolve_reference(solver, isize, absorbed[c])
            np.testing.assert_allclose(got[c], expect, rtol=2e-4,
                                       atol=expect.max() * 1e-6)


def test_solve_emission_sums_sizes():
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=7)
    rng = np.random.default_rng(2)
    absorbed = (rng.random((40, solver.nfreq)) * 5).astype(np.float32)
    emitted = stochastic.solve_emission(solver, absorbed, batch=16,
                                        clip_last=False)
    expect = np.zeros_like(emitted)
    for c in range(40):
        for isize in range(2):
            expect[c] += dosolve_reference(solver, isize, absorbed[c])
    np.testing.assert_allclose(emitted, expect, rtol=5e-4,
                               atol=expect.max() * 1e-5)


def test_overflow_rescale_stability():
    """Huge dynamic range in the populations must not produce inf/nan."""
    solver = random_solver(ne=32, nfreq=8, nsize=1, seed=11)
    solver.sizes[0].tdown[:] = np.logspace(-20, 25, 32).astype(np.float32)
    solver.sizes[0].tdown[0] = 0.0
    absorbed = np.full((4, 8), 1e8, np.float32)
    w_flat, tdown, ea = stochastic.prepare_size_arrays(solver, 0)
    got = np.asarray(stochastic.solve_batch(
        w_flat, tdown, ea, jnp.asarray(absorbed), solver.ne))
    assert np.all(np.isfinite(got))
    assert np.all(got >= 0)


def test_polarized_emission_alignment():
    """aalg path: PEMITTED covers the aligned sizes only; limits bracket it."""
    from soc_tpu.solve.stochastic import solve_emission, alignment_weights
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=9)
    solver.size_a[:] = [1e-7, 1e-6, 1e-5]
    rng = np.random.default_rng(6)
    absorbed = (rng.random((10, 8)) * 5).astype(np.float32)
    # all grains aligned -> PEMITTED == EMITTED
    em, pem = solve_emission(solver, absorbed, clip_last=False,
                             aalg=np.full(10, 1e-8, np.float32))
    np.testing.assert_allclose(pem, em, rtol=1e-6)
    # nothing aligned -> PEMITTED == 0
    em2, pem2 = solve_emission(solver, absorbed, clip_last=False,
                               aalg=np.full(10, 1.0, np.float32))
    np.testing.assert_allclose(em2, em, rtol=1e-6)
    assert pem2.max() == 0.0
    # intermediate cutoff: strictly between
    em3, pem3 = solve_emission(solver, absorbed, clip_last=False,
                               aalg=np.full(10, 3e-6, np.float32))
    assert 0 < pem3.sum() < em3.sum()
    # interpolation weight sanity
    w = alignment_weights(solver, 1, np.full(10, 3e-6, np.float32))
    assert np.all((w > 0.4) & (w < 0.6))


def test_streaming_solve_matches_in_memory(tmp_path):
    """Out-of-core streaming solve through the native IO engine must
    reproduce the in-memory result exactly."""
    from soc_tpu.io.fields import (read_cell_frequency_array,
                                   write_cell_frequency_array)
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=2)
    rng = np.random.default_rng(8)
    cells = 1000
    absorbed = rng.random((cells, 8)).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    ref = stochastic.solve_emission(solver, absorbed)
    rows = stochastic.solve_emission_streaming(
        solver, tmp_path / "abs.bin", tmp_path / "emit.bin", batch=256)
    assert rows == cells
    out = read_cell_frequency_array(tmp_path / "emit.bin")
    np.testing.assert_array_equal(out, ref)


def _stacks(solver, n):
    return stochastic.size_stacks(solver, n)


def test_size_scan_matches_per_size_loop():
    """solve_all_chunks (lax.scan over sizes on the device) == the sum of
    per-size solve_batch calls, including the alignment-weighted
    polarized accumulation."""
    solver = random_solver(ne=32, nfreq=10, nsize=3, seed=12)
    rng = np.random.default_rng(5)
    chunk = (rng.random((64, 10)) * 1e4).astype(np.float32)
    align = rng.random((3, 64)).astype(np.float32)
    tot, ptot = stochastic.solve_all_chunks(
        *_stacks(solver, 3), jnp.asarray(chunk[None]),
        jnp.asarray(align[None]), 32)
    ref = np.zeros((64, 10), np.float32)
    pref = np.zeros((64, 10), np.float32)
    for i in range(3):
        w, td, ea = stochastic.prepare_size_arrays(solver, i)
        em = np.asarray(stochastic.solve_batch(w, td, ea,
                                               jnp.asarray(chunk), 32))
        ref += em
        pref += em * align[i][:, None]
    np.testing.assert_allclose(np.asarray(tot[0]), ref, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ptot[0]), pref, rtol=1e-6)


def test_superbatch_matches_chunks():
    """A superbatch of chunks in one dispatch == each chunk on its own,
    with and without the polarized accumulator."""
    solver = random_solver(ne=32, nfreq=10, nsize=2, seed=12)
    rng = np.random.default_rng(6)
    chunks = (rng.random((3, 64, 10)) * 1e4).astype(np.float32)
    align = rng.random((3, 2, 64)).astype(np.float32)
    st = _stacks(solver, 2)
    tot, ptot = stochastic.solve_all_chunks(
        *st, jnp.asarray(chunks), jnp.asarray(align), 32)
    tot_np, none = stochastic.solve_all_chunks(
        *st, jnp.asarray(chunks), None, 32)
    assert none is None
    for k in range(3):
        rt, rp = stochastic.solve_all_chunks(
            *st, jnp.asarray(chunks[k:k + 1]), jnp.asarray(align[k:k + 1]),
            32)
        np.testing.assert_allclose(np.asarray(tot[k]), np.asarray(rt[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ptot[k]), np.asarray(rp[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(tot_np[k]), np.asarray(rt[0]),
                                   rtol=1e-6)


def test_cli_profile_trace(tmp_path):
    """--profile wraps any CLI command in a jax.profiler trace (SURVEY
    5.1); the trace directory must contain xplane protobufs afterwards."""
    from soc_tpu.cli import main
    rng = np.random.default_rng(0)
    solver = random_solver(ne=16, nfreq=8, nsize=1, seed=1)
    write_solver(tmp_path / "s.solver", solver)
    from soc_tpu.io.fields import write_cell_frequency_array
    absorbed = rng.random((64, 8)).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    prof = tmp_path / "prof"
    rc = main(["--profile=%s" % prof, "a2e", str(tmp_path / "s.solver"),
               str(tmp_path / "abs.bin"), str(tmp_path / "emit.bin")])
    assert rc == 0
    assert list(prof.rglob("*.xplane.pb"))


def test_sharded_chunks_match_single_device():
    """solve_all_chunks_sharded (chunk axis over the 8-device mesh) must
    reproduce the single-device superbatch bit-for-bit -- the cell solve
    has no cross-chunk coupling, so sharding only relabels devices."""
    import jax
    assert len(jax.local_devices()) == 8
    solver = random_solver(ne=32, nfreq=10, nsize=2, seed=12)
    rng = np.random.default_rng(9)
    chunks = jnp.asarray((rng.random((8, 64, 10)) * 1e4).astype(np.float32))
    align = jnp.asarray(rng.random((8, 2, 64)).astype(np.float32))
    st = _stacks(solver, 2)
    ref_t, ref_p = stochastic.solve_all_chunks(*st, chunks, align, 32)
    sh_t, sh_p = stochastic.solve_all_chunks_sharded(*st, chunks, align, 32)
    np.testing.assert_array_equal(np.asarray(sh_t), np.asarray(ref_t))
    np.testing.assert_array_equal(np.asarray(sh_p), np.asarray(ref_p))
    sh_t2, none = stochastic.solve_all_chunks_sharded(*st, chunks, None, 32)
    assert none is None
    np.testing.assert_array_equal(np.asarray(sh_t2), np.asarray(ref_t))
    with pytest.raises(ValueError, match="multiple"):
        stochastic.solve_all_chunks_sharded(*st, chunks[:3], None, 32)


def test_cli_reference_arg_list(tmp_path):
    """The a2e CLI accepts the reference's full argument list
    `solver absorbed emitted [GPU [nstoch [IFREQ [aalg]]]]` (A2E.py:17-30):
    GPU ignored, IFREQ selects a single output column, aalg writes the
    polarised emission to <emitted>.P."""
    from soc_tpu.cli import main
    from soc_tpu.io.fields import write_cell_frequency_array

    rng = np.random.default_rng(3)
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=5)
    write_solver(tmp_path / "s.solver", solver)
    cells = 100
    absorbed = rng.random((cells, 8)).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    with open(tmp_path / "aalg.bin", "wb") as fp:
        np.asarray([cells], np.int32).tofile(fp)
        np.full(cells, 1e-8, np.float32).tofile(fp)

    ref = stochastic.solve_emission(solver, absorbed)

    # full reference layout: GPU=1.0 ignored, nstoch=999, IFREQ=3, aalg
    rc = main(["a2e", str(tmp_path / "s.solver"), str(tmp_path / "abs.bin"),
               str(tmp_path / "emit.bin"), "1.0", "999", "3",
               str(tmp_path / "aalg.bin")])
    assert rc == 0
    hdr = np.fromfile(tmp_path / "emit.bin", np.int32, 2)
    assert tuple(hdr) == (cells, 1)
    out = np.fromfile(tmp_path / "emit.bin", np.float32,
                      offset=8).reshape(cells, 1)
    np.testing.assert_allclose(out[:, 0], ref[:, 3], rtol=1e-6)
    # aalg = tiny -> everything aligned -> P equals total emission
    pout = np.fromfile(tmp_path / "emit.bin.P", np.float32,
                       offset=8).reshape(cells, 1)
    np.testing.assert_allclose(pout[:, 0], ref[:, 3], rtol=1e-6)

    # nstoch via the reference 5-arg layout
    rc = main(["a2e", str(tmp_path / "s.solver"), str(tmp_path / "abs.bin"),
               str(tmp_path / "emit2.bin"), "0", "1"])
    assert rc == 0
    out2 = np.fromfile(tmp_path / "emit2.bin", np.float32,
                       offset=8).reshape(cells, 8)
    ref2 = stochastic.solve_emission(solver, absorbed, nstoch=1)
    np.testing.assert_allclose(out2, ref2, rtol=1e-6)

    # GPU-only reference calls: a lone 4th argument is ALWAYS the device
    # id (bare int '1' or float '1.0'), never nstoch -- verbatim reference
    # command lines keep their physics
    for gpu in ("1.0", "1", "0"):
        rc = main(["a2e", str(tmp_path / "s.solver"),
                   str(tmp_path / "abs.bin"),
                   str(tmp_path / "emit3.bin"), gpu])
        assert rc == 0
        out3 = np.fromfile(tmp_path / "emit3.bin", np.float32,
                           offset=8).reshape(cells, 8)
        np.testing.assert_allclose(out3, ref, rtol=1e-6)


def test_solve_emission_aalg_matches_oracle():
    """solve_emission with aalg == the float64 loop port, total and
    polarized, on a cell count that leaves a padded tail chunk."""
    solver = random_solver(ne=32, nfreq=6, nsize=3, seed=3)
    solver.size_a[:] = [1e-7, 1e-6, 1e-5]
    rng = np.random.default_rng(9)
    cells = 77
    absorbed = rng.random((cells, 6)).astype(np.float32)
    aalg = rng.choice([1e-8, 3e-6, 1.0], cells).astype(np.float32)
    out, pout = stochastic.solve_emission(solver, absorbed, clip_last=False,
                                          aalg=aalg)
    ref, pref = a2e_reference.solve_emission(solver, absorbed, aalg=aalg)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(pout, pref, rtol=5e-4, atol=1e-5 * scale)
    assert 0 < pout.sum() < out.sum()


def test_solve_emission_superbatch_bookkeeping():
    """Many superbatches with a padded tail (batch 8 over 700 cells on 8
    devices, the next superbatch dispatched before the last is stored)
    give the same rows as one chunk per device."""
    solver = random_solver(ne=32, nfreq=6, nsize=2, seed=3)
    rng = np.random.default_rng(9)
    cells = 700
    absorbed = rng.random((cells, 6)).astype(np.float32)
    aalg = np.full(cells, 2e-7, np.float32)
    ref, pref = stochastic.solve_emission(solver, absorbed, aalg=aalg)
    out, pout = stochastic.solve_emission(solver, absorbed, batch=8,
                                          aalg=aalg)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_allclose(pout, pref, rtol=1e-6)
