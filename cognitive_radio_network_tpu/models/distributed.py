"""Multi-chip training: the full sharded wideband sense->classify train step.

Composes every parallelism style the framework defines (parallel/mesh.py):

* ``data``    — batch of IQ streams sharded across chips (DP);
* ``time``    — each stream's time axis sharded with ppermute halo exchange
                through the channelizer FIR (the SP/CP analog);
* ``channel`` — per-channel feature/classifier work sharded across the
                polyphase channel axis (the TP analog).

The classifier is the 4-5-3-shaped sigmoid MLP applied per channel with
shared weights over features [noise_floor, E_{k-1}, E_k, E_{k+1}] (the
wideband generalization of CE_Predictive_Node's [NF, CH1, CH2, CH3] input,
CE_Predictive_Node.cpp:200); output 0 is the channel-occupied probability.
Parameters are replicated; pjit inserts the gradient psum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cognitive_radio_network_tpu.models.train import TrainState
from cognitive_radio_network_tpu.parallel.wideband import WidebandConfig, wideband_sense
from cognitive_radio_network_tpu.signal.mlp import MLPParams, init_mlp, mlp_forward

__all__ = ["wideband_features", "make_sharded_train_step", "make_sharded_apply"]


def wideband_features(energy: jax.Array, noise: jax.Array) -> jax.Array:
    """Per-channel 4-feature rows: [noise, E_left, E_center, E_right].

    energy (..., C, M), noise (..., C, 1) -> (..., C, M, 4). Neighbor
    energies wrap cyclically (channel 0's left neighbor is channel M-1).
    """
    left = jnp.roll(energy, 1, axis=-1)
    right = jnp.roll(energy, -1, axis=-1)
    nf = jnp.broadcast_to(noise, energy.shape)
    return jnp.stack([nf, left, energy, right], axis=-1)


def _loss(params: MLPParams, feats, labels):
    """feats (..., 4) log-compressed; labels (...,) in {0,1}."""
    x = jnp.log1p(feats * 1e3)
    p = mlp_forward(params, x)[..., 0]
    eps = 1e-7
    p = jnp.clip(p, eps, 1 - eps)
    return -jnp.mean(labels * jnp.log(p) + (1 - labels) * jnp.log(1 - p))


def make_sharded_train_step(
    mesh: Mesh,
    cfg: WidebandConfig,
    learning_rate: float = 1e-3,
):
    """Returns (init_fn, step_fn) jitted over the mesh.

    step_fn(state, planes (B, T*M, 2), labels (B, C, M)) -> (state, loss)
    with planes sharded P('data', 'time'), labels P('data'), params
    replicated.  Works on meshes missing some axes (sizes of 1).
    """
    taps = jnp.asarray(cfg.taps())
    axes = set(mesh.axis_names)
    data_ax = "data" if "data" in axes else None
    time_ax = "time" if "time" in axes else None

    opt = optax.adam(learning_rate)

    def init_fn(key) -> TrainState:
        params = init_mlp(key, n_in=4, n_hidden=5, n_out=1)
        return TrainState(params, opt.init(params), jnp.int32(0))

    def loss_fn(params, planes, labels):
        res = wideband_sense(planes, taps, mesh, cfg, batch_axis=data_ax)
        feats = wideband_features(res["energy"], res["noise"])
        return _loss(params, feats, labels)

    planes_spec = NamedSharding(mesh, P(data_ax, time_ax))
    labels_spec = NamedSharding(mesh, P(data_ax))
    repl = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(repl, planes_spec, labels_spec),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
    def step_fn(state: TrainState, planes, labels):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, planes, labels)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return init_fn, step_fn


def make_sharded_apply(mesh: Mesh, cfg: WidebandConfig):
    """Jitted sharded inference: planes (B, T*M, 2) -> occupancy probs (B, C, M)."""
    taps = jnp.asarray(cfg.taps())
    axes = set(mesh.axis_names)
    data_ax = "data" if "data" in axes else None
    time_ax = "time" if "time" in axes else None
    planes_spec = NamedSharding(mesh, P(data_ax, time_ax))
    repl = NamedSharding(mesh, P())

    @functools.partial(jax.jit, in_shardings=(repl, planes_spec))
    def apply_fn(params: MLPParams, planes):
        res = wideband_sense(planes, taps, mesh, cfg, batch_axis=data_ax)
        feats = wideband_features(res["energy"], res["noise"])
        return mlp_forward(params, jnp.log1p(feats * 1e3))[..., 0]

    return apply_fn
