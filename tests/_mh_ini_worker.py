"""Multi-host FULL-INI worker: drive pipeline.driver.run (iterations +
absorbed + solve + maps, `devices 8`) under jax.distributed.

Run as `python _mh_ini_worker.py <coordinator> <num_processes>
<process_id> <workdir>` with 4 local CPU devices per process; chdirs into
its own output directory and prints one MH_INI_RESULT digest line. The
test (test_multihost.py) starts two of these and compares against the
same ini executed single-process on 8 devices.
"""

import os
import sys


INI = """
gridlength      0.01
cloud           {workdir}/tmp.cloud
mapping         8 8 1.0
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         {workdir}/tmp.dust
dsc             {workdir}/tmp.dsc 2500
background      {workdir}/bg_intensity.bin
bgpackets       3072
cellpackets     2048
iterations      2
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
temperature     tmp.T
devices         8
"""


def prepare(workdir):
    import numpy as np
    from soc_tpu.io.cloud import write_hierarchy
    from soc_tpu.io.example import write_dust_inputs
    write_dust_inputs(workdir)
    n = 8
    cloud = os.path.join(workdir, "tmp.cloud")
    if not os.path.exists(cloud):
        write_hierarchy(cloud, n, n, n, [n ** 3],
                        [np.ones(n ** 3, np.float32)])
    ini = os.path.join(workdir, "run.ini")
    with open(ini, "w") as fp:
        fp.write(INI.format(workdir=workdir))
    return ini


def digest(res):
    import numpy as np
    t = np.asarray(res.temperature, np.float64)
    m = np.asarray(res.maps[0], np.float64)
    return ("%.9e %.9e %.9e %.9e"
            % (float(np.float64(np.asarray(res.ctabs)).sum()),
               float(t.sum()), float(t.max()),
               float(m.sum())))


def run(ini, outdir):
    from soc_tpu.pipeline import driver
    os.makedirs(outdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(outdir)
    try:
        res = driver.run(ini, lanes=512)
    finally:
        os.chdir(cwd)
    return res


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    coord, nproc, pid, workdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    from soc_tpu.parallel.dist import initialize
    initialize(coordinator=coord, num_processes=nproc, process_id=pid)
    assert jax.device_count() == nproc * 4
    ini = prepare(workdir)
    res = run(ini, os.path.join(workdir, "proc%d" % pid))
    print("MH_INI_RESULT %s" % digest(res), flush=True)
