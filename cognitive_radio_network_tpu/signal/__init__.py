"""Numerics core: the sensing math of the reference, batched.

Everything here is pure-functional JAX, jit/vmap/shard_map friendly, with the
exact numerical contracts of the reference's CE_Predictive_Node sensing chain
(cognitive_engines/CE_Predictive_Node/CE_Predictive_Node.cpp:146-235).
"""

from cognitive_radio_network_tpu.signal.fft import (
    dft_matrices,
    spectrum_magnitude,
    averaged_magnitude_spectrum,
)
from cognitive_radio_network_tpu.signal.bands import (
    SensingBands,
    DEFAULT_BANDS,
    band_matrix,
    band_features,
)
from cognitive_radio_network_tpu.signal.mlp import (
    MLPParams,
    reference_weights,
    mlp_forward,
    init_mlp,
)
from cognitive_radio_network_tpu.signal.detector import (
    occupancy_decision,
    next_tx_channel,
    DECISION_ALL_BUSY,
    SU_CHANNELS_HZ,
)
from cognitive_radio_network_tpu.signal.msequence import MSequence, msequence_bytes
from cognitive_radio_network_tpu.signal.iq import to_planes, from_planes, split_iq
from cognitive_radio_network_tpu.signal import filters

__all__ = [
    "dft_matrices",
    "spectrum_magnitude",
    "averaged_magnitude_spectrum",
    "SensingBands",
    "DEFAULT_BANDS",
    "band_matrix",
    "band_features",
    "MLPParams",
    "reference_weights",
    "mlp_forward",
    "init_mlp",
    "occupancy_decision",
    "next_tx_channel",
    "DECISION_ALL_BUSY",
    "SU_CHANNELS_HZ",
    "MSequence",
    "msequence_bytes",
    "to_planes",
    "from_planes",
    "split_iq",
    "filters",
]
