"""Multi-host execution: jax.distributed initialization (SURVEY 5.8).

The reference is single-process (ASOC.py:179-181 hardcodes DEVICES=1); this
framework scales over hosts with JAX's multi-controller runtime: every
process runs the same driver, `jax.devices()` exposes the global device
set, and the (dp, freq) product mesh (parallel/product.py) spans all of
them -- XLA runs the collectives between devices and hosts, with no
application-level communication code.

Initialization sources, in priority order:
  1. explicit arguments (initialize(coordinator=..., ...))
  2. SOC_TPU_COORDINATOR / SOC_TPU_NUM_PROCESSES / SOC_TPU_PROCESS_ID env
  3. cluster auto-detection (SLURM, ...) -- JAX's own
     jax.distributed.initialize() with no arguments

The CLI calls maybe_initialize() once at startup; it is a no-op unless the
env (or caller) describes a multi-process job, so single-host runs are
untouched.
"""

import os

_initialized = False


def initialize(coordinator=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Explicit multi-process init; idempotent."""
    global _initialized
    import jax
    if _initialized:
        return
    # NOTE: no jax.devices()/process_count() probes here -- they would
    # initialise the XLA backend, after which distributed init is illegal
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    _initialized = True


def maybe_initialize():
    """Env-driven init: a no-op unless SOC_TPU_COORDINATOR (explicit) or
    SOC_TPU_DISTRIBUTED=auto (cluster autodetection) is set."""
    coord = os.environ.get("SOC_TPU_COORDINATOR")
    if coord:
        nproc = os.environ.get("SOC_TPU_NUM_PROCESSES")
        pid = os.environ.get("SOC_TPU_PROCESS_ID")
        if nproc is None or pid is None:
            raise ValueError(
                "SOC_TPU_COORDINATOR is set but multi-process init also "
                "needs SOC_TPU_NUM_PROCESSES and SOC_TPU_PROCESS_ID "
                "(got NUM_PROCESSES=%r, PROCESS_ID=%r)" % (nproc, pid))
        initialize(coordinator=coord, num_processes=int(nproc),
                   process_id=int(pid))
        return True
    if os.environ.get("SOC_TPU_DISTRIBUTED", "").lower() == "auto":
        initialize()
        return True
    return False
