"""Occupancy-classifier training.

The reference trained its 4-5-3 MLP *offline* on ~400 labeled feature
examples and pasted the weights into C++ source (README.md:104,
CE_Predictive_Node.cpp:74-121 — "checkpointing is literally pasting weights
into source", SURVEY.md §5).  The framework makes training a first-class,
shardable pipeline instead:

    IQ scenes (synthetic env / recorded IQ)
      -> fused sense front-end (FFT + band features)   [models.sense]
      -> sigmoid MLP, per-channel BCE                  [signal.mlp]
      -> optax adam, data-parallel over a mesh axis

Data parallelism is expressed with sharding annotations under ``jax.jit``
(pjit): batches sharded over the ``data`` mesh axis, parameters replicated,
XLA inserting the gradient ``psum`` — not hand-written collectives.
Checkpointing goes through :mod:`cognitive_radio_network_tpu.io.checkpoint`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from cognitive_radio_network_tpu.env import scene as scene_mod
from cognitive_radio_network_tpu.models.sense import SenseConfig, sense_classify
from cognitive_radio_network_tpu.signal.mlp import MLPParams, init_mlp, mlp_forward

__all__ = ["TrainConfig", "TrainState", "make_dataset", "train_step", "fit"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-3
    num_steps: int = 2000
    batch_size: int = 128
    feature_scale: float = 1.0  # features are raw squared-amplitude sums
    log_features: bool = True  # compress dynamic range before the MLP


class TrainState(NamedTuple):
    params: MLPParams
    opt_state: optax.OptState
    step: jax.Array


def make_dataset(
    key: jax.Array,
    num_examples: int = 400,
    cfg: SenseConfig = SenseConfig(),
    scene_cfg: scene_mod.SceneConfig | None = None,
    signal_power: float = 0.05,
    power_jitter_decades: float = 1.5,
):
    """Labeled (features, occupancy one-hot) pairs from synthetic scenes.

    Default size mirrors the reference's ~400-example dataset (README.md:104).
    Labels are per-channel occupancy {0,1}^3 — multi-label, supporting
    simultaneously active channels (beyond the reference's single-PU traces).
    Signal power is randomized +-power_jitter_decades decades around
    signal_power so the trained detector generalizes across link gains
    (a real deployment's PU power is unknown); set 0.0 for fixed power.
    """
    scene_cfg = scene_cfg or scene_mod.SceneConfig()
    k1, k2, k3, k4 = jax.random.split(key, 4)
    # Mix of single-channel, idle, and multi-channel cycles.
    occupancy = jax.random.bernoulli(
        k1, 0.35, (num_examples, len(scene_cfg.channels_hz))
    ).astype(jnp.float32)
    jitter = 10.0 ** jax.random.uniform(
        k4,
        (num_examples, 1),
        minval=-power_jitter_decades,
        maxval=power_jitter_decades,
    )
    powers = occupancy * signal_power * jitter
    iq = scene_mod.synthesize_scene(k2, powers, cfg.samples_per_cycle, scene_cfg)
    res = sense_classify(
        iq.reshape(num_examples, cfg.averaging, cfg.fft_length),
        init_mlp(k3),  # params irrelevant; we only need features
        cfg,
    )
    return res["features"], occupancy


def _loss_fn(params: MLPParams, feats, labels, tcfg: TrainConfig):
    x = jnp.log1p(feats / tcfg.feature_scale) if tcfg.log_features else feats
    preds = mlp_forward(params, x)
    eps = 1e-7
    p = jnp.clip(preds, eps, 1 - eps)
    bce = -(labels * jnp.log(p) + (1 - labels) * jnp.log(1 - p))
    return jnp.mean(bce)


def make_optimizer(tcfg: TrainConfig):
    return optax.adam(tcfg.learning_rate)


@functools.partial(jax.jit, static_argnames=("tcfg",), donate_argnums=(0,))
def train_step(state: TrainState, feats, labels, tcfg: TrainConfig) -> tuple:
    """One SGD step; pure + jitted, shardable by annotating feats/labels."""
    loss, grads = jax.value_and_grad(_loss_fn)(state.params, feats, labels, tcfg)
    opt = make_optimizer(tcfg)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


def fit(
    key: jax.Array,
    feats,
    labels,
    tcfg: TrainConfig = TrainConfig(),
    params: MLPParams | None = None,
):
    """Full-batch training loop (the dataset is tiny); returns (params, losses)."""
    if params is None:
        params = init_mlp(key)
    opt = make_optimizer(tcfg)
    state = TrainState(params, opt.init(params), jnp.int32(0))
    losses = []
    for _ in range(tcfg.num_steps):
        state, loss = train_step(state, feats, labels, tcfg)
        losses.append(float(loss))
    return state.params, np.array(losses)
