"""OFDM PHY: the batched ofdmflexframe-equivalent link.

Re-creates the capability of liquid-dsp's ``ofdmflexframegen`` /
``ofdmflexframesync`` (the external C library the reference's radio runtime is
built on — SURVEY.md §2.7 item 14): CRC, FEC, constellation mod/demod,
pilot/null subcarrier allocation, frame generation, and a batched
block-oriented frame synchronizer producing ``FrameSyncStats`` records
(the contract of the vendored framesyncstats.c:39-55).

Unlike liquid's per-sample adaptive state machines, everything here is
batched over frames/symbols and jit-compilable; streaming across block
boundaries is handled by the overlap/carry logic in :mod:`..parallel`.
"""

from cognitive_radio_network_tpu.phy import bits, crc, fec, modem, subcarriers
from cognitive_radio_network_tpu.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu.phy.framesync import OFDMFrameSync, FrameSyncStats

__all__ = [
    "bits",
    "crc",
    "fec",
    "modem",
    "subcarriers",
    "OFDMFrameConfig",
    "OFDMFrameGen",
    "OFDMFrameSync",
    "FrameSyncStats",
]
