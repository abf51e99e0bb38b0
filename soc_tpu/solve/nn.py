"""Neural-network emission surrogate (the ASOC_aux_NN.py capability).

Learns the per-cell mapping log(absorptions at a few reference wavelengths)
-> log(emission spectrum), replacing the expensive per-cell A2E solve for
repeated runs (reference: PyTorch MLP with LeakyReLU hidden layers,
configurable like nnnet=[13,17,13]; ASOC_aux_NN.py:32-210). The MLP is plain
jax.numpy trained with optax; weights are a nested dict
``{"params": {"Dense_<i>": {"kernel": [in, out], "bias": [out]}}}`` stored as
a plain pickled pytree in <prefix>.nn.

Reference ``.nn`` files (torch ``state_dict`` checkpoints written by
ASOC_aux_NN.py:159) are also accepted: nn_load sniffs the torch zip
format, recovers the weights with a torch-free restricted unpickler
(utils/torch_pickle.py) and applies the reference's linear mean
normalization from the ``A_<dust>.norm`` / ``E_<dust>.norm`` companions
(ASOC_aux_NN.py:294-296), so ``nnsolve`` can consume surrogates trained
by the reference itself.
"""

import os
import pickle
import re
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import optax


def mlp_init(key, n_in, hidden, n_out):
    """Parameter pytree of an MLP with LeakyReLU hidden layers: LeCun
    normal kernels, zero biases."""
    widths = [n_in] + list(hidden) + [n_out]
    params = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        key, sub = jax.random.split(key)
        params["Dense_%d" % i] = {
            "kernel": jax.random.normal(sub, (a, b), jnp.float32)
            / np.sqrt(a),
            "bias": jnp.zeros(b, jnp.float32)}
    return {"params": params}


def mlp_apply(params, x):
    """Forward pass of mlp_init's network (LeakyReLU slope 0.01)."""
    layers = params["params"]
    n = len(layers)
    for i in range(n):
        d = layers["Dense_%d" % i]
        x = jnp.dot(x, d["kernel"], precision=jax.lax.Precision.HIGHEST) \
            + d["bias"]
        if i < n - 1:
            x = jax.nn.leaky_relu(x, negative_slope=0.01)
    return x


def _log_standardize(x, eps=1e-33):
    lx = np.log10(np.maximum(np.asarray(x, np.float64), eps))
    mu = lx.mean(axis=0)
    sd = lx.std(axis=0) + 1e-8
    return ((lx - mu) / sd).astype(np.float32), mu, sd


def nn_fit(absorbed, emitted, hidden=(13, 17, 13), epochs=400, lr=3e-3,
           batch=4096, seed=0, verbose=False):
    """Train the surrogate on [N, n_abs] -> [N, n_emit] cell samples.

    Returns a model dict (weights + input/output normalizations) suitable
    for nn_save/nn_solve.
    """
    x, in_mu, in_sd = _log_standardize(absorbed)
    y, out_mu, out_sd = _log_standardize(emitted)
    params = mlp_init(jax.random.PRNGKey(seed), x.shape[1], hidden,
                      y.shape[1])
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            pred = mlp_apply(p, xb)
            return jnp.mean((pred - yb) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n = x.shape[0]
    rng = np.random.default_rng(seed)
    xd, yd = jnp.asarray(x), jnp.asarray(y)
    loss = None
    for epoch in range(epochs):
        order = rng.permutation(n)
        for i0 in range(0, n, batch):
            sel = order[i0:i0 + batch]
            params, opt_state, loss = step(params, opt_state, xd[sel],
                                           yd[sel])
        if verbose and epoch % 50 == 0:
            print(f"  nn_fit epoch {epoch}: loss {float(loss):.5f}")
    return dict(params=params, hidden=tuple(hidden),
                in_mu=in_mu, in_sd=in_sd, out_mu=out_mu, out_sd=out_sd,
                n_out=y.shape[1])


def nn_solve(model_dict, absorbed, batch=1 << 16):
    """Evaluate the surrogate: [CELLS, n_abs] -> [CELLS, n_emit]."""
    linear = model_dict.get("norm") == "ref-linear"
    if linear:
        # the reference's normalization: clip, divide by the per-channel
        # means from A_<dust>.norm (ASOC_aux_NN.py:103-110, 309-311)
        a = np.clip(np.asarray(absorbed, np.float32), 1.0e-29, 1.0e32)
        x = a / model_dict["in_scale"][None, :]
    else:
        lx = np.log10(np.maximum(np.asarray(absorbed, np.float64), 1e-33))
        x = ((lx - model_dict["in_mu"]) /
             model_dict["in_sd"]).astype(np.float32)

    # params as a traced argument: a closure would constant-fold the
    # weights into the executable and recompile on every nn_solve call
    apply = jax.jit(mlp_apply)

    outs = []
    for i0 in range(0, x.shape[0], batch):
        outs.append(np.asarray(apply(model_dict["params"],
                                     jnp.asarray(x[i0:i0 + batch]))))
    if linear:
        return (np.concatenate(outs) *
                model_dict["out_scale"][None, :]).astype(np.float32)
    ly = np.concatenate(outs) * model_dict["out_sd"] + model_dict["out_mu"]
    return (10.0 ** ly).astype(np.float32)


def import_torch_nn(path, a_norm=None, e_norm=None):
    """Convert a reference-trained torch ``.nn`` checkpoint to a model dict.

    The reference saves ``model.state_dict()`` of an ``nn.Sequential`` of
    Linear/LeakyReLU pairs as ``<prefix>_<dust>.nn`` and the linear mean
    normalizations as raw-float32 ``A_<dust>.norm`` / ``E_<dust>.norm`` in
    the working directory (ASOC_aux_NN.py:110-113, 159, 294-296).  When
    the norm paths are not given they are located next to the checkpoint
    by trying every ``'_'``-split of the basename as the dust name;
    without them the import falls back to unit scales (valid only if the
    training data were already normalized).
    """
    from ..utils.torch_pickle import load_state_dict
    state = load_state_dict(path)
    idx = sorted({int(m.group(1)) for k in state
                  for m in [re.match(r"layers\.(\d+)\.(weight|bias)$", k)]
                  if m})
    if not idx:
        raise ValueError("%s: no layers.<i>.weight entries -- not an "
                         "ASOC_aux_NN state dict" % path)
    weights = [(state["layers.%d.weight" % i], state["layers.%d.bias" % i])
               for i in idx]
    params = {"params": {}}
    for d, (w, b) in enumerate(weights):
        # torch Linear stores [out, in]; Dense kernels are [in, out]
        params["params"]["Dense_%d" % d] = {
            "kernel": jnp.asarray(np.ascontiguousarray(w.T)),
            "bias": jnp.asarray(b)}
    hidden = tuple(int(w.shape[0]) for w, _ in weights[:-1])
    n_in = int(weights[0][0].shape[1])
    n_out = int(weights[-1][0].shape[0])

    if a_norm is None or e_norm is None:
        dirname = os.path.dirname(os.path.abspath(path))
        stem = os.path.basename(path)
        stem = stem[:-3] if stem.endswith(".nn") else stem
        parts = stem.split("_")
        for i in range(1, len(parts)):
            cand = "_".join(parts[i:])
            ap = os.path.join(dirname, "A_%s.norm" % cand)
            ep = os.path.join(dirname, "E_%s.norm" % cand)
            if os.path.exists(ap) and os.path.exists(ep):
                a_norm, e_norm = a_norm or ap, e_norm or ep
                break
    if a_norm and os.path.exists(a_norm):
        in_scale = np.fromfile(a_norm, np.float32)
    else:
        in_scale = np.ones(n_in, np.float32)
    if e_norm and os.path.exists(e_norm):
        out_scale = np.fromfile(e_norm, np.float32)
    else:
        out_scale = np.ones(n_out, np.float32)
    if len(in_scale) != n_in or len(out_scale) != n_out:
        raise ValueError(
            "%s: norm-file lengths (%d, %d) do not match the network "
            "(%d in, %d out)" % (path, len(in_scale), len(out_scale),
                                 n_in, n_out))
    return dict(params=params, hidden=hidden, n_out=n_out,
                norm="ref-linear", in_scale=in_scale, out_scale=out_scale)


def nn_save(path, model_dict):
    with open(path, "wb") as fp:
        pickle.dump(jax.device_get(model_dict), fp)


def nn_load(path):
    if zipfile.is_zipfile(path):
        # a reference-trained torch checkpoint, not our pickled pytree
        return import_torch_nn(path)
    with open(path, "rb") as fp:
        return pickle.load(fp)
