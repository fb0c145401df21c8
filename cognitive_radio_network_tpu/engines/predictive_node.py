"""CE_Predictive_Node port — the north-star secondary-user engine.

Sense->classify loop of cognitive_engines/CE_Predictive_Node/CE_Predictive_Node.cpp:
(1) one-time config: stop tx, tune rx to fc=833 MHz / 13 MS/s, load the
    trained 4-5-3 MLP weights (:66-123);
(2) every sensing_delay_ms=100 ms: stop tx, enable the raw-sample sensing
    tap (:131-141);
(3) per USRP_RX_SAMPS event: 512-pt FFT, accumulate |X|/10 (:146-155);
(4) after 10 buffers: band energies -> features -> sigmoid MLP -> threshold
    0.8 decision -> retune tx to a free channel (:157-261), reset (:287-288).

Here steps (3)-(5) are ONE fused jitted graph (models.sense.sense_classify)
executed once per completed averaging cycle — the per-buffer FFT work is
batched instead of incremental, trading the reference's per-buffer CPU FFT
for one device dispatch per cycle.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.models.sense import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu.runtime.engine import (
    CEEvent,
    CognitiveEngine,
    register_engine,
)
from cognitive_radio_network_tpu.signal.detector import next_tx_channel
from cognitive_radio_network_tpu.signal.mlp import reference_weights

__all__ = ["CEPredictiveNode"]


@register_engine("CE_Predictive_Node")
class CEPredictiveNode(CognitiveEngine):
    desired_fc = 833e6  # CE_Predictive_Node.hpp:42
    desired_bw = 13e6  # .hpp:43

    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        self.cfg = SenseConfig()
        # ce_args: -w <checkpoint.npz> loads trained weights (the reference
        # hardcodes its weights in source, CE_Predictive_Node.cpp:78-120;
        # here training + checkpoints are first-class: models/train.py)
        self.params = reference_weights()
        a = list(args or [])
        if "-w" in a:
            import dataclasses as _dc

            from cognitive_radio_network_tpu.io.checkpoint import load_mlp_with_meta

            self.params, meta = load_mlp_with_meta(a[a.index("-w") + 1])
            self.cfg = _dc.replace(
                self.cfg, feature_transform=meta["feature_transform"]
            )
        # params stay HOST numpy: the engine is constructed outside the
        # scenario's phy-placement context, so jax-array params would
        # commit to the default device and every sense call under "host"
        # placement would copy them back across, while numpy params follow
        # the active device for free
        import jax as _jax

        self.params = _jax.tree.map(np.asarray, self.params)
        self._sense_fn = make_sense_fn(self.cfg)
        # sensing-only mode (default): stop the frame synchronizer while
        # this engine senses — the reference carries exactly this line,
        # commented, with the note that stopping rx relates to forwarding
        # samples to the CE (CE_Predictive_Node.cpp:136
        # ``//ECR->stop_rx(); /*stopping rx enables forwarding samples to
        # CE*/``), and the predictive SU never expects PHY frames (the PU
        # transmits at an incompatible rate).  ``--keep-framesync`` in
        # ce_args restores the reference's literal keep-rx-running
        # behavior (identical decisions either way; frame scanning on an
        # undecodable stream is pure cost).
        self.sense_only = "--keep-framesync" not in (args or [])
        self.configured = False
        self.next_sense_t = 0.0
        self.collecting = False
        self.buffers: list[np.ndarray] = []
        self.decisions: list[int] = []
        self.outputs: list[np.ndarray] = []

    def execute(self) -> None:
        r = self.radio
        t = r.CE_metrics.time_s
        if not self.configured:
            r.stop_tx()
            r.set_rx_freq(self.desired_fc)
            r.set_rx_rate(self.desired_bw)
            r.set_ce_usrp_rx_buffer_length(self.cfg.fft_length)
            if self.sense_only:
                r.stop_rx()  # CE_Predictive_Node.cpp:136 (see __init__)
            self.configured = True
            self.next_sense_t = t

        if t >= self.next_sense_t and not self.collecting:
            r.stop_tx()
            r.set_ce_sensing(1)
            self.collecting = True
            self.next_sense_t = t + self.cfg.sensing_delay_ms / 1e3

        if r.CE_metrics.ce_event == CEEvent.USRP_RX_SAMPS and self.collecting:
            buf = np.asarray(r.CE_metrics.payload)
            self.buffers.append(buf[: self.cfg.fft_length])
            if len(self.buffers) == self.cfg.averaging:
                r.set_ce_sensing(0)
                self.collecting = False
                self._classify_and_act()
                self.buffers.clear()

    def _classify_and_act(self) -> None:
        r = self.radio
        stack = np.stack(self.buffers)  # (A, N) complex64
        planes = jnp.asarray(
            np.stack([stack.real, stack.imag], axis=-1, dtype=np.float32)[None]
        )
        res = self._sense_fn(planes, self.params)
        decision = int(res["decision"][0])
        self.decisions.append(decision)
        self.outputs.append(np.asarray(res["outputs"][0]))
        new_freq = float(
            next_tx_channel(
                jnp.asarray(decision), jnp.float32(r.get_tx_freq()), self.cfg.channels_hz
            )
        )
        if decision != 0:
            r.set_tx_freq(new_freq)
        # else: "ALL BUSY, SENSE AND OBSERVE AGAIN" (CE_Predictive_Node.cpp:261)
