"""Counter-based RNG for the transport kernels.

The reference uses the skip-ahead MWC64X generator to give every OpenCL work
item an independent stream (mwc64x_rng.cl, kernel_ASOC.c:71-77). The equivalent
here is a counter-based generator: every photon packet owns the stream
``(seed, packet_id)`` and advances a private 32-bit draw counter. Streams are
therefore reproducible and *device-count invariant* -- resharding packets over
a different mesh never changes the random numbers a given packet consumes.

We implement Threefry-2x32 (the same primitive underlying ``jax.random``) as
plain 32-bit vector arithmetic so it can run inside ``lax.while_loop`` bodies
and Pallas kernels without threading JAX PRNG keys through the loop carry.
"""

import jax.numpy as jnp

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = jnp.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << d) | (x >> (32 - d))


def threefry2x32(k0, k1, c0, c1, rounds=13):
    """Threefry-2x32. All args uint32 arrays; returns (x0, x1).

    Default 13 rounds: the Random123 paper's recommended minimum for
    Threefry-2x32 (passes the full BigCrush battery); the hot transport
    loop consumes one evaluation per packet step, so the 20->13 round cut
    is a direct ~35% saving on the RNG share of the step cost. Pass
    rounds=20 for the conservative full-strength variant.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(c0, jnp.uint32)
    x1 = jnp.asarray(c1, jnp.uint32)
    ks2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, ks2)

    x0 = x0 + k0
    x1 = x1 + k1
    done = 0
    r = 0
    while done < rounds:
        rots = _ROTATIONS[r % 2]
        for d in rots[: rounds - done]:
            x0 = x0 + x1
            x1 = _rotl(x1, jnp.uint32(d))
            x1 = x1 ^ x0
        done += min(4, rounds - done)
        # key injection every 4 rounds (and after a final partial block)
        x0 = x0 + keys[(r + 1) % 3]
        x1 = x1 + keys[(r + 2) % 3] + jnp.uint32(r + 1)
        r += 1
    return x0, x1


def _bits_to_unit(bits):
    # uint32 -> float32 uniform in (0, 1): match the reference's
    # u = bits / 2^32-1 mapping but guard the exact 0 that would break log(u).
    u = bits.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)
    return jnp.maximum(u, jnp.float32(1e-12))


def uniform2(seed, stream, counter, hi=0):
    """Two independent uniform(0,1) float32 draws for (seed, hi, stream,
    counter).

    seed    : uint32 scalar or array -- global run seed
    stream  : uint32 array -- per-packet stream id, LOW word (index within
              the packet's frequency channel)
    counter : uint32 array -- per-packet draw counter (caller increments);
              each counter value owns the two threefry counter-word slots
              2*counter and 2*counter+1
    hi      : uint32 scalar or array -- stream id HIGH word encoding
              (phase, iteration, frequency); folded into the threefry key so
              the 64-bit pair (hi, stream) never collides across phases,
              frequencies, or >2^31 total packets (the reference's skip-ahead
              stream partitioning, kernel_ASOC.c:71-77, scaled up)
    """
    hi = jnp.asarray(hi, jnp.uint32)
    c1 = jnp.asarray(counter, jnp.uint32) * jnp.uint32(2)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    return _bits_to_unit(b0), _bits_to_unit(b1)


def uniform4(seed, stream, counter, hi=0):
    """Four uniform(0,1) float32 draws (two threefry evaluations)."""
    hi = jnp.asarray(hi, jnp.uint32)
    c1 = jnp.asarray(counter, jnp.uint32) * jnp.uint32(2)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    b2, b3 = threefry2x32(seed, hi, stream, c1 + jnp.uint32(1))
    return _bits_to_unit(b0), _bits_to_unit(b1), _bits_to_unit(b2), _bits_to_unit(b3)


def uniform1(seed, stream, counter, hi=0):
    """One uniform(0,1) float32 draw (slot 2*counter)."""
    hi = jnp.asarray(hi, jnp.uint32)
    c1 = jnp.asarray(counter, jnp.uint32) * jnp.uint32(2)
    b0, _ = threefry2x32(seed, hi, stream, c1)
    return _bits_to_unit(b0)


def step_uniforms(seed, stream, counter, hi):
    """(u_fp, u_bin, u_phi) from ONE threefry evaluation -- the transport
    hot path. The free-path draw keeps full 32-bit resolution (it feeds a
    log); the phase-function bin index and azimuth each get 16 bits of the
    second word, far finer than the <=2^12 CSC bins and the float32 angle
    arithmetic they feed."""
    hi = jnp.asarray(hi, jnp.uint32)
    c1 = jnp.asarray(counter, jnp.uint32) * jnp.uint32(2)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    u_fp = _bits_to_unit(b0)
    u_bin = (b1 >> jnp.uint32(16)).astype(jnp.float32) \
        * jnp.float32(1.0 / 65536.0)
    u_phi = (b1 & jnp.uint32(0xFFFF)).astype(jnp.float32) \
        * jnp.float32(1.0 / 65536.0)
    return u_fp, u_bin, u_phi


def step_uniforms4(seed, stream, counter, hi):
    """``step_uniforms`` plus a fourth draw (the WITH_MSF species roulette)
    from a second threefry evaluation at the odd slot. The first three
    values are bit-identical to ``step_uniforms`` so the MSF transport path
    follows the exact same trajectories as the plain path whenever the
    species choice is immaterial (single species / identical optics)."""
    hi = jnp.asarray(hi, jnp.uint32)
    c1 = jnp.asarray(counter, jnp.uint32) * jnp.uint32(2)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    b2, _ = threefry2x32(seed, hi, stream, c1 + jnp.uint32(1))
    u_fp = _bits_to_unit(b0)
    u_bin = (b1 >> jnp.uint32(16)).astype(jnp.float32) \
        * jnp.float32(1.0 / 65536.0)
    u_phi = (b1 & jnp.uint32(0xFFFF)).astype(jnp.float32) \
        * jnp.float32(1.0 / 65536.0)
    return u_fp, u_bin, u_phi, _bits_to_unit(b2)
