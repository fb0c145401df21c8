"""Gather helpers for the hot paths.

* :mod:`.extract` — dynamic-offset window extraction for the OFDM receive.
"""
