"""cognitive_radio_network_tpu — a cognitive-radio sensing framework in JAX.

A from-scratch JAX/XLA/Pallas/pjit rebuild of the capabilities of
``0xastro/Cognitive-Radio-Network`` (CRTS + liquid-dsp + UHD, C++), redesigned
for batched accelerator execution (one NVIDIA GPU, or a mesh of them):

* the per-sample C++ DSP hot loops (liquid ofdmflexframe sync, FFT sensing,
  ANN inference — reference src/extensible_cognitive_radio.cpp:1258-1382,
  cognitive_engines/CE_Predictive_Node/CE_Predictive_Node.cpp:54-292) become
  **one fused batched XLA graph** over time-blocks;
* USRP hardware I/O becomes a **synthetic RF environment / recorded-IQ
  source** (:mod:`.env`, :mod:`.io`);
* the multi-process TCP/ssh control plane (reference src/crts_controller.cpp)
  becomes a host-Python orchestration layer (:mod:`.runtime`) over shards of
  one pjit-ed program;
* scale-out is via ``jax.sharding`` meshes with ``ppermute`` overlap-save halo
  exchange and ``psum`` spectrum reductions (:mod:`.parallel`), which XLA hands to NCCL.

Subpackages
-----------
signal    numerics core: windowed FFT power spectrum, band energies, energy
          detector, occupancy MLP, PRBS m-sequences, filter design
ops       the fused sense kernel (Pallas, GPU) and window extraction
phy       OFDM link: CRC, FEC, modem, subcarrier allocation, frame gen/sync
env       synthetic RF environment: Markov/random PU, interferer waveforms,
          AWGN channels, scene composition
io        recorded-IQ sources/sinks with stream-cursor checkpointing
parallel  device meshes, halo exchange, channel/time-sharded pipelines
runtime   node/scenario runtime: engines (CE), scenario controllers (SC),
          config schema, traffic models, rx statistics, structured logging
models    the sense->classify flagship pipeline and classifier training
engines   built-in cognitive-engine plug-ins (ports of reference CE_*)
controllers  built-in scenario controllers (ports of reference SC_*)
"""

__version__ = "0.1.0"

from cognitive_radio_network_tpu import signal, env, models  # noqa: F401
