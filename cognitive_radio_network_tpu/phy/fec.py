"""Forward error correction: none / rep3 / Hamming(7,4) / Hamming(12,8) / conv K=7 r=1/2.

Equivalent of the liquid-dsp ``fec_scheme`` set the reference actually uses:
LIQUID_FEC_HAMMING128 (default inner code, src/extensible_cognitive_radio.cpp:102),
LIQUID_FEC_HAMMING74 (interferer GMSK frames, src/interferer.cpp:164), and
LIQUID_FEC_CONV_V27 (predictive scenario SU link, scenarios/predictive_model.cfg:81-82).

Byte-level API mirrors liquid's (encode expands, decode corrects+contracts);
all codes also have a batched jnp decode for in-graph rx chains — the Viterbi
decoder is a ``lax.scan`` over time with all 64 states add-compare-selected in
parallel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.phy.bits import pack_bits, unpack_bits

__all__ = [
    "SCHEMES",
    "encoded_length",
    "encode",
    "decode",
    "decode_bits_jnp",
    "conv_encode_bits",
    "viterbi_decode_bits",
    "viterbi_decode_jnp",
]

SCHEMES = ("none", "rep3", "h74", "h128", "v27")

# --- Hamming(7,4) ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _h74_tables():
    # Generator: codeword = [p1 p2 d3 p4 d2 d1 d0] (positions 1..7, parity at
    # powers of two). Encode/decode via lookup tables.
    enc = np.zeros(16, np.uint8)
    for d in range(16):
        d3, d2, d1, d0 = (d >> 3) & 1, (d >> 2) & 1, (d >> 1) & 1, d & 1
        p1 = d3 ^ d2 ^ d0
        p2 = d3 ^ d1 ^ d0
        p4 = d2 ^ d1 ^ d0
        cw = (p1 << 6) | (p2 << 5) | (d3 << 4) | (p4 << 3) | (d2 << 2) | (d1 << 1) | d0
        enc[d] = cw
    dec = np.zeros(128, np.uint8)
    for cw in range(128):
        bits = [(cw >> (6 - i)) & 1 for i in range(7)]  # positions 1..7
        s1 = bits[0] ^ bits[2] ^ bits[4] ^ bits[6]
        s2 = bits[1] ^ bits[2] ^ bits[5] ^ bits[6]
        s4 = bits[3] ^ bits[4] ^ bits[5] ^ bits[6]
        syndrome = s1 | (s2 << 1) | (s4 << 2)
        fixed = list(bits)
        if syndrome:
            fixed[syndrome - 1] ^= 1
        d = (fixed[2] << 3) | (fixed[4] << 2) | (fixed[5] << 1) | fixed[6]
        dec[cw] = d
    return enc, dec


# --- Hamming(12,8): shortened Hamming(15,11) -------------------------------


@functools.lru_cache(maxsize=None)
def _h128_matrices():
    # Parity-check H for Hamming(15,11): columns are 1..15 in binary; shorten
    # the three highest data positions to get (12,8). Codeword layout: 12 bits,
    # position p (1-indexed) is a parity bit if p is a power of two.
    positions = list(range(1, 13))
    parity_pos = [1, 2, 4, 8]
    data_pos = [p for p in positions if p not in parity_pos]  # 8 positions
    enc = np.zeros(256, np.uint16)
    for d in range(256):
        bits = {p: 0 for p in positions}
        for i, p in enumerate(data_pos):
            bits[p] = (d >> (7 - i)) & 1
        for pp in parity_pos:
            s = 0
            for p in positions:
                if p != pp and (p & pp):
                    s ^= bits[p]
            bits[pp] = s
        cw = 0
        for p in positions:
            cw = (cw << 1) | bits[p]
        enc[d] = cw
    return enc, tuple(parity_pos), tuple(data_pos)


@functools.lru_cache(maxsize=None)
def _h128_decode_table():
    enc, parity_pos, data_pos = _h128_matrices()
    dec = np.zeros(4096, np.uint8)
    # Build syndrome: for received word r, syndrome = XOR of position indices
    # of set bits (classic Hamming); a nonzero syndrome <= 12 flips that bit.
    for r in range(4096):
        bits = [(r >> (12 - p)) & 1 for p in range(1, 13)]
        syn = 0
        for p in range(1, 13):
            if bits[p - 1]:
                syn ^= p
        fixed = list(bits)
        if 1 <= syn <= 12:
            fixed[syn - 1] ^= 1
        d = 0
        for p in data_pos:
            d = (d << 1) | fixed[p - 1]
        dec[r] = d
    return dec


# --- Convolutional K=7, rate 1/2 (polys 0o171, 0o133) ----------------------

_CONV_K = 7
_CONV_POLYS = (0o171, 0o133)


@functools.lru_cache(maxsize=None)
def _conv_tables():
    """next_state[state, bit], output_bits[state, bit] (2 bits packed)."""
    ns = np.zeros((64, 2), np.int32)
    out = np.zeros((64, 2), np.int32)
    for s in range(64):
        for b in range(2):
            reg = (b << 6) | s  # newest bit in MSB of the 7-bit window
            o = 0
            for g in _CONV_POLYS:
                o = (o << 1) | (bin(reg & g).count("1") & 1)
            ns[s, b] = reg >> 1
            out[s, b] = o
    return ns, out


def conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """Encode with K-1 zero tail flush; returns 2*(n+6) bits."""
    ns, out = _conv_tables()
    state = 0
    res = []
    for b in list(np.asarray(bits, np.uint8)) + [0] * (_CONV_K - 1):
        o = out[state, b]
        res.extend([(o >> 1) & 1, o & 1])
        state = ns[state, b]
    return np.array(res, np.uint8)


def conv_encode_bits_batch(bits: np.ndarray) -> np.ndarray:
    """Batched K=7 R=1/2 convolutional encode: bits (B, N) -> (B, 2*(N+6)).

    The state recursion is sequential in bit position but fully vectorized
    over the batch axis — one table lookup per position for all frames.
    """
    ns, out = _conv_tables()
    bits = np.asarray(bits, np.uint8)
    b, n = bits.shape
    full = np.concatenate(
        [bits, np.zeros((b, _CONV_K - 1), np.uint8)], axis=1
    )
    res = np.empty((b, 2 * (n + _CONV_K - 1)), np.uint8)
    state = np.zeros(b, np.int64)
    for i in range(full.shape[1]):
        o = out[state, full[:, i]]
        res[:, 2 * i] = (o >> 1) & 1
        res[:, 2 * i + 1] = o & 1
        state = ns[state, full[:, i]]
    return res


def _pad_bits_batch(bits: np.ndarray) -> np.ndarray:
    rem = (-bits.shape[-1]) % 8
    if rem:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], rem), np.uint8)], axis=-1
        )
    return bits


def encode_batch(scheme: str, data: np.ndarray) -> np.ndarray:
    """Batched encode: data (B, N) uint8 -> (B, encoded_length(scheme, N)).

    Bit-identical to per-frame :func:`encode`; vectorized over the frame
    axis (the per-frame path costs ~10 small numpy ops + python overhead
    per frame, which dominates batched frame assembly)."""
    data = np.asarray(data, np.uint8)
    if data.ndim != 2:
        raise ValueError(f"expected (B, N), got {data.shape}")
    b, n = data.shape
    if scheme == "none":
        return data.copy()
    if scheme == "rep3":
        return np.tile(data, (1, 3))
    if scheme == "h74":
        enc, _ = _h74_tables()
        hi, lo = data >> 4, data & 0xF
        cws = np.empty((b, 2 * n), np.uint8)
        cws[:, 0::2], cws[:, 1::2] = enc[hi], enc[lo]
        bits = ((cws[..., None] >> np.arange(6, -1, -1)) & 1).reshape(b, -1)
        return np.packbits(_pad_bits_batch(bits), axis=-1)
    if scheme == "h128":
        enc, _, _ = _h128_matrices()
        cws = enc[data]
        bits = (
            ((cws[..., None] >> np.arange(11, -1, -1)) & 1)
            .astype(np.uint8)
            .reshape(b, -1)
        )
        return np.packbits(_pad_bits_batch(bits), axis=-1)
    if scheme == "v27":
        bits = np.unpackbits(data, axis=-1)
        return np.packbits(
            _pad_bits_batch(conv_encode_bits_batch(bits)), axis=-1
        )
    raise ValueError(f"unknown fec scheme: {scheme}")


def viterbi_decode_bits(coded: np.ndarray, n_bits: int) -> np.ndarray:
    """Hard-decision Viterbi over 64 states; numpy vectorized over states."""
    ns, out = _conv_tables()
    coded = np.asarray(coded, np.uint8)
    t_total = n_bits + _CONV_K - 1
    pm = np.full(64, 1 << 20, np.int32)
    pm[0] = 0
    bp = np.zeros((t_total, 64), np.int8)  # input bit chosen into each state
    prev = np.zeros((t_total, 64), np.int8)  # predecessor index selector
    # Precompute inverse transitions: for each state s', list of (s, b).
    inv = [[] for _ in range(64)]
    for s in range(64):
        for b in range(2):
            inv[ns[s, b]].append((s, b))
    inv_s = np.array([[p[0] for p in lst] for lst in inv], np.int32)  # (64, 2)
    inv_b = np.array([[p[1] for p in lst] for lst in inv], np.int32)
    inv_o = out[inv_s, inv_b]  # (64, 2) expected output bits

    for t in range(t_total):
        r = (int(coded[2 * t]) << 1) | int(coded[2 * t + 1])
        # branch metric = hamming distance of 2-bit symbols
        bm = np.array(
            [[bin(r ^ int(o)).count("1") for o in row] for row in inv_o], np.int32
        )
        cand = pm[inv_s] + bm  # (64, 2)
        sel = np.argmin(cand, axis=1)
        pm = cand[np.arange(64), sel]
        bp[t] = inv_b[np.arange(64), sel]
        prev[t] = sel

    # Traceback from state 0 (tail-flushed).
    state = 0
    bits_rev = []
    for t in range(t_total - 1, -1, -1):
        sel = prev[t, state]
        b = inv_b[state, sel]
        bits_rev.append(int(bp[t, state]))
        state = int(inv_s[state, sel])
    bits = np.array(bits_rev[::-1], np.uint8)
    return bits[:n_bits]


def viterbi_decode_jnp(coded_bits: jax.Array, n_bits: int) -> jax.Array:
    """Batched in-graph Viterbi: coded_bits uint8 (..., 2*(n_bits+6)).

    lax.scan over time; per step an (…, 64, 2) add-compare-select;
    traceback is a reverse scan over stored selectors.
    """
    ns, out = _conv_tables()
    inv = [[] for _ in range(64)]
    for s in range(64):
        for b in range(2):
            inv[ns[s, b]].append((s, b))
    inv_s_np = np.array([[p[0] for p in lst] for lst in inv], np.int32)
    inv_b_np = np.array([[p[1] for p in lst] for lst in inv], np.int32)
    inv_s = jnp.asarray(inv_s_np)
    inv_b = jnp.asarray(inv_b_np)
    inv_o = jnp.asarray(out[inv_s_np, inv_b_np], jnp.int32)

    coded = jnp.asarray(coded_bits, jnp.uint8)
    batch_shape = coded.shape[:-1]
    t_total = n_bits + _CONV_K - 1
    flat = coded.reshape(-1, coded.shape[-1])
    syms = (flat[:, 0 : 2 * t_total : 2].astype(jnp.int32) << 1) | flat[
        :, 1 : 2 * t_total : 2
    ].astype(jnp.int32)  # (B, T)

    popcnt2 = jnp.asarray([0, 1, 1, 2], jnp.int32)

    def fwd(pm, r):
        # pm (B, 64); r (B,)
        bm = popcnt2[jnp.bitwise_xor(r[:, None, None], inv_o[None])]  # (B,64,2)
        cand = pm[:, inv_s] + bm
        sel = jnp.argmin(cand, axis=-1)  # (B, 64)
        pm_new = jnp.take_along_axis(cand, sel[..., None], axis=-1)[..., 0]
        return pm_new, sel.astype(jnp.int8)

    b = flat.shape[0]
    pm0 = jnp.full((b, 64), 1 << 20, jnp.int32).at[:, 0].set(0)
    _, sels = jax.lax.scan(fwd, pm0, syms.T)  # sels (T, B, 64)

    def back(state, sel_t):
        sel = jnp.take_along_axis(sel_t, state[:, None], axis=-1)[..., 0].astype(
            jnp.int32
        )  # (B,)
        bit = inv_b[state, sel]
        prev_state = inv_s[state, sel]
        return prev_state, bit.astype(jnp.uint8)

    state0 = jnp.zeros((b,), jnp.int32)
    _, bits_rev = jax.lax.scan(back, state0, sels, reverse=True)
    # reverse scan emits ys aligned with inputs: bits_rev[t] is bit at time t
    bits = bits_rev.T  # (B, T)
    return bits[:, :n_bits].reshape(*batch_shape, n_bits)


def decode_bits_jnp(scheme: str, bits: jax.Array, n_dec: int) -> jax.Array:
    """Batched in-graph decode: coded BITS (..., n_bits) -> bytes (..., n_dec).

    Bit-identical to the host :func:`decode` (which takes packed bytes); used
    by the rx graph so FEC stays on-device — table codes are one gather each,
    v27 is :func:`viterbi_decode_jnp`."""
    from cognitive_radio_network_tpu.phy.bits import pack_bits_jnp

    bits = jnp.asarray(bits, jnp.uint8)
    lead = bits.shape[:-1]
    if scheme == "none":
        return pack_bits_jnp(bits[..., : n_dec * 8])
    if scheme == "rep3":
        a = pack_bits_jnp(bits[..., : 24 * n_dec])
        x = a[..., :n_dec].astype(jnp.uint32)
        y = a[..., n_dec : 2 * n_dec].astype(jnp.uint32)
        z = a[..., 2 * n_dec : 3 * n_dec].astype(jnp.uint32)
        return ((x & y) | (x & z) | (y & z)).astype(jnp.uint8)
    if scheme == "h74":
        _, dec = _h74_tables()
        cw = bits[..., : n_dec * 14].reshape(*lead, 2 * n_dec, 7).astype(jnp.int32)
        pow2 = (1 << jnp.arange(6, -1, -1, dtype=jnp.int32))
        vals = jnp.asarray(dec)[jnp.sum(cw * pow2, axis=-1)]
        return ((vals[..., 0::2] << 4) | vals[..., 1::2]).astype(jnp.uint8)
    if scheme == "h128":
        dec = _h128_decode_table()
        cw = bits[..., : n_dec * 12].reshape(*lead, n_dec, 12).astype(jnp.int32)
        pow2 = (1 << jnp.arange(11, -1, -1, dtype=jnp.int32))
        return jnp.asarray(dec)[jnp.sum(cw * pow2, axis=-1)].astype(jnp.uint8)
    if scheme == "v27":
        return pack_bits_jnp(viterbi_decode_jnp(bits, 8 * n_dec))
    raise ValueError(f"unknown fec scheme: {scheme}")


# --- byte-level registry ----------------------------------------------------


def encoded_length(scheme: str, n_dec: int) -> int:
    """Encoded payload length in bytes for ``n_dec`` decoded bytes."""
    if scheme == "none":
        return n_dec
    if scheme == "rep3":
        return 3 * n_dec
    if scheme == "h74":
        return (n_dec * 2 * 7 + 7) // 8  # two nibbles -> 7 bits each
    if scheme == "h128":
        return (n_dec * 12 + 7) // 8
    if scheme == "v27":
        return (2 * (8 * n_dec + _CONV_K - 1) + 7) // 8
    raise ValueError(f"unknown fec scheme: {scheme}")


def encode(scheme: str, data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    if scheme == "none":
        return data.copy()
    if scheme == "rep3":
        return np.tile(data, 3)
    if scheme == "h74":
        enc, _ = _h74_tables()
        hi, lo = data >> 4, data & 0xF
        cws = np.empty(2 * len(data), np.uint8)
        cws[0::2], cws[1::2] = enc[hi], enc[lo]
        bits = ((cws[:, None] >> np.arange(6, -1, -1)) & 1).reshape(-1)
        return pack_bits(_pad_bits(bits))
    if scheme == "h128":
        enc, _, _ = _h128_matrices()
        cws = enc[data]
        bits = ((cws[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8).reshape(-1)
        return pack_bits(_pad_bits(bits))
    if scheme == "v27":
        bits = unpack_bits(data)
        return pack_bits(_pad_bits(conv_encode_bits(bits)))
    raise ValueError(f"unknown fec scheme: {scheme}")


def decode(scheme: str, coded: np.ndarray, n_dec: int) -> np.ndarray:
    coded = np.asarray(coded, np.uint8)
    if scheme == "none":
        return coded[:n_dec].copy()
    if scheme == "rep3":
        a = coded[:n_dec].astype(np.uint16)
        b = coded[n_dec : 2 * n_dec].astype(np.uint16)
        c = coded[2 * n_dec : 3 * n_dec].astype(np.uint16)
        return ((a & b) | (a & c) | (b & c)).astype(np.uint8)  # bitwise majority
    if scheme == "h74":
        _, dec = _h74_tables()
        bits = unpack_bits(coded)[: n_dec * 14]
        cws = bits.reshape(-1, 7)
        vals = dec[np.dot(cws, 1 << np.arange(6, -1, -1))]
        return ((vals[0::2] << 4) | vals[1::2]).astype(np.uint8)
    if scheme == "h128":
        dec = _h128_decode_table()
        bits = unpack_bits(coded)[: n_dec * 12]
        cws = bits.reshape(-1, 12)
        return dec[np.dot(cws, 1 << np.arange(11, -1, -1))].astype(np.uint8)
    if scheme == "v27":
        bits = unpack_bits(coded)
        return pack_bits(viterbi_decode_bits(bits, 8 * n_dec))
    raise ValueError(f"unknown fec scheme: {scheme}")


def _pad_bits(bits: np.ndarray) -> np.ndarray:
    rem = (-len(bits)) % 8
    if rem:
        bits = np.concatenate([bits, np.zeros(rem, np.uint8)])
    return bits
