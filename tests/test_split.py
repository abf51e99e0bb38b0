"""Packet-splitting statistical equivalence on octree-refined clouds.

The reference's SimBgSplit splits rays at refinement boundaries via dynamic
per-ray stacks; here packets split in-flight: a packet crossing into
a finer level halves its weight and posts a clone request served through
the lane-refill machinery. Promise: expectation unchanged, refined-region
variance reduced at (near-)equal cost.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from soc_tpu.grid import grid_from_arrays, encode_link_np
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.transport.propagate import transport_run


def three_level_grid(n=8, seed=0):
    """Root n^3 with one octet refined at level 1 and one of its children
    refined again (3 levels)."""
    rng = np.random.default_rng(seed)
    root = rng.uniform(0.5, 1.0, n ** 3).astype(np.float32)
    centre = (n // 2) + n * (n // 2) + n * n * (n // 2)
    root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
    l1 = rng.uniform(2.0, 4.0, 8).astype(np.float32)
    l1[3] = encode_link_np(np.asarray([0], np.int32))[0]
    l2 = rng.uniform(8.0, 16.0, 8).astype(np.float32)
    return grid_from_arrays(n, n, n, [n ** 3, 8, 8], [root, l1, l2])


def run_bg(grid, n_packets, seed, split_max=0):
    dsc, csc = hg_scattering_function([0.3], 128)
    physics = dict(kabs=jnp.float32(0.05), ksca=jnp.float32(0.05),
                   csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    params = dict(photons=jnp.float32(1.0), ifreq=jnp.int32(0),
                  per_freq=jnp.int32(n_packets))
    tabs = jnp.zeros(grid.cells, jnp.float32)
    intf = jnp.zeros((1, 1), jnp.float32)
    out = transport_run(
        grid, physics, params, jnp.int32(n_packets), tabs, intf, seed,
        source_kind="bg", nlanes=1 << 11, split_max=split_max)
    tabs, _, esc = out[0], out[1], out[2]
    clones = int(out[4]) if split_max > 0 else 0
    return np.asarray(tabs), float(esc[0]), clones


def test_split_conserves_weight():
    """Energy balance must hold exactly in expectation: halving + cloning
    keeps the total injected weight."""
    grid = three_level_grid()
    n = 4 * int(grid.area)
    t0, e0, _ = run_bg(grid, n, 5)
    t1, e1, ncl = run_bg(grid, n, 5, split_max=4)
    assert ncl > 0          # clones actually spawned
    # absorbed + escaped = injected in both runs
    assert abs((t0.sum() + e0) - n) / n < 1e-3
    assert abs((t1.sum() + e1) - n) / n < 1e-3


def test_split_unbiased_and_lower_variance():
    """Same expectation as the plain run; smaller refined-cell error
    (the reference's SimBgSplit equivalence promise, SURVEY 7.3)."""
    grid = three_level_grid()
    n = 6 * int(grid.area)

    truth_raw, _, _ = run_bg(grid, 16 * n, 999)
    truth = truth_raw / (16 * n)

    refined = (np.arange(grid.cells) >= grid.nx ** 3) \
        & (np.asarray(grid.dens) > 0)                    # level-1/2 leaves
    err_plain, err_split = [], []
    tot_plain, tot_split = [], []
    for seed in (11, 23, 37, 53, 71):
        tp, _, _ = run_bg(grid, n, seed)
        ts, _, _ = run_bg(grid, n, seed, split_max=4)
        tp_hat = tp / n
        ts_hat = ts / n
        err_plain.append(np.abs(tp_hat - truth)[refined] / truth[refined])
        err_split.append(np.abs(ts_hat - truth)[refined] / truth[refined])
        tot_plain.append(tp_hat.sum())
        tot_split.append(ts_hat.sum())
    # unbiased: totals agree with truth within MC noise
    assert abs(np.mean(tot_split) - truth.sum()) / truth.sum() < 0.02
    assert abs(np.mean(tot_plain) - truth.sum()) / truth.sum() < 0.02
    # variance reduction in the refined cells
    e_p = np.mean(np.concatenate(err_plain))
    e_s = np.mean(np.concatenate(err_split))
    assert e_s < e_p, (e_s, e_p)
