"""Mid-run preemption checkpointing of the transport phase.

SURVEY 5.4: the reference's only restartability is its stage-wise files;
long device jobs get preempted MID-stage, so the simulation state itself must be
resumable. Because every packet's random stream is a pure function of its
global (phase | iteration | frequency, in-frequency index) id, NO RNG state
needs saving -- a checkpoint is just the accumulated tallies plus the set
of completed transport units (one unit = one frequency sweep of one
source). Re-running the remaining units reproduces the results of an
uninterrupted run: bit-identical on the CPU, and within the float32
atomics' summation-order spread on a GPU.

File format: .npz with tabs/intf tally snapshots, the unit-key list and
each unit's escaped-photon count. Enabled by the ini keyword
`checkpoint <file> [every_n_units]`; covers the phase-1 constant-source
simulation AND the phase-2 re-emission iterations: the plain cell sweep
records per-(iteration, frequency) units, every iteration ends with a
state snapshot (emitted/temperature/reference-field/ALI carries), and the
counter-based RNG makes a resumed run reproduce an uninterrupted one from
either granularity (bitwise on the CPU).
"""

import os

import numpy as np


class RunCheckpoint:
    def __init__(self, path, every=1, fingerprint=""):
        """fingerprint: a string identifying the run configuration (seed +
        the ini parameters that change the physics). A checkpoint written
        under a different fingerprint is STALE -- resuming from it would
        silently return the old configuration's tallies -- so it is
        ignored and overwritten instead."""
        self.path = path
        self.every = max(1, int(every))
        self.fingerprint = str(fingerprint)
        self.done = []
        self.esc = []
        self.arrays = None
        self._since_save = 0
        if path and os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                saved_fp = str(z["fingerprint"]) if "fingerprint" in z.files \
                    else ""
                if saved_fp != self.fingerprint:
                    import sys
                    print("checkpoint %s: configuration changed since it "
                          "was written -- starting fresh" % path,
                          file=sys.stderr)
                    return
                self.done = [str(k) for k in z["done"]]
                self.esc = [float(v) for v in z["esc"]]
                self.arrays = {k: z[k] for k in z.files
                               if k not in ("done", "esc", "fingerprint")}

    def completed(self, key):
        return key in self.done

    def esc_of(self, key):
        return self.esc[self.done.index(key)]

    def restore(self, tabs, intf):
        """Initial tallies: the saved snapshot when resuming, else the
        given fresh arrays."""
        if self.arrays is None or "tabs" not in self.arrays:
            return tabs, intf
        import jax.numpy as jnp
        return (jnp.asarray(self.arrays["tabs"]),
                jnp.asarray(self.arrays["intf"]))

    def restore_roi(self, tally):
        """ROI-save crossing histograms from the snapshot when resuming
        (completed units' contributions live only in this array)."""
        if self.arrays is None or "roi" not in self.arrays:
            return tally
        return np.asarray(self.arrays["roi"], np.float32)

    def saved(self, name):
        """The saved array under `name`, or None."""
        if self.arrays is None or name not in self.arrays:
            return None
        return self.arrays[name]

    def record(self, key, esc_value, tabs=None, intf=None, roi=None,
               **named):
        """Mark a unit complete, merge the given named array snapshots,
        and persist every N units (atomic rename). Named slots accumulate
        across calls: phase 1 writes tabs/intf/roi, the phase-2 sweep adds
        p2_tabs, iteration boundaries add the it_* state arrays."""
        self.done.append(key)
        self.esc.append(float(esc_value))
        self._since_save += 1
        if self._since_save >= self.every:
            self._since_save = 0
            self.flush(tabs, intf, roi=roi, **named)
        else:
            self._merge(tabs, intf, roi, named)

    def record_many(self, keys, esc_values, tabs=None, intf=None,
                    roi=None, **named):
        """Mark a GROUP of units complete under ONE shared snapshot. The
        multi-channel product path deposits a whole frequency group in a
        single device call, so its snapshot is only consistent with ALL
        of the group's keys -- per-key record() calls would open a
        preemption window where the persisted file holds some keys but a
        snapshot containing every channel's deposits (double-counted on
        resume)."""
        self.done.extend(keys)
        self.esc.extend(float(v) for v in esc_values)
        self._since_save += len(keys)
        if self._since_save >= self.every:
            self._since_save = 0
            self.flush(tabs, intf, roi=roi, **named)
        else:
            self._merge(tabs, intf, roi, named)

    def _merge(self, tabs, intf, roi, named):
        # store REFERENCES: device arrays are immutable, so holding one
        # is a zero-cost snapshot; flush() pays the device->host copy
        # only when something is actually persisted (a np.asarray here
        # would read back the full [CELLS, NFREQ] tally on every unit
        # even at checkpoint_every > 1)
        if self.arrays is None:
            self.arrays = {}
        if tabs is not None:
            self.arrays["tabs"] = tabs
        if intf is not None:
            self.arrays["intf"] = intf
        if roi is not None:
            self.arrays["roi"] = roi
        for k, v in named.items():
            if v is not None:
                self.arrays[k] = v

    def flush(self, tabs=None, intf=None, roi=None, **named):
        self._merge(tabs, intf, roi, named)
        if self.arrays is not None:
            for k, v in self.arrays.items():
                self.arrays[k] = np.asarray(v, np.float32) if k == "roi" \
                    else np.asarray(v)
        if not self.path:
            return
        arrays = self.arrays or {}
        # np.savez rejects None entries; every slot in self.arrays is real
        tmp = self.path + ".tmp.npz"
        with open(tmp, "wb") as fp:
            np.savez(fp, done=np.asarray(self.done, dtype="U64"),
                     esc=np.asarray(self.esc, np.float64),
                     fingerprint=np.asarray(self.fingerprint), **arrays)
        os.replace(tmp, self.path)
