"""Utilities: timers (src/timer.cc port) and profiling helpers."""

from cognitive_radio_network_tpu.utils.timer import Timer, LatencyRecorder
from cognitive_radio_network_tpu.utils.profiling import trace, device_time

__all__ = ["Timer", "LatencyRecorder", "trace", "device_time"]
