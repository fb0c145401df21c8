"""Time-sharded OFDM link: frame-sync state across shard boundaries.

SURVEY §7.5's declared hard part (a): liquid's synchronizer carries opaque
streaming state across every recv boundary
(src/extensible_cognitive_radio.cpp:1307), so a frame straddling two blocks
still decodes.  In the sharded world the analog is OVERLAP-SAVE AT FRAME
SCALE: each time shard of the IQ stream ppermutes the HEAD of its segment
(one maximum-frame-length halo) to its LEFT ring neighbor, so a frame that
starts near the end of shard i and spills into shard i+1 is decoded wholly
by shard i.  Ownership is by frame START (``0 <= best < shard_len``), which
also dedups detections between neighbors.

The per-shard receive is the fused one-dispatch fixed-config block receiver
(phy/framesync.py::_receive_block_graph) run under ``shard_map``; the only
cross-shard communication is the single ppermute of the halo.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cognitive_radio_network_tpu.phy.framegen import (
    OFDMFrameConfig,
    gen_for,
    unpack_phy_header,
)
from cognitive_radio_network_tpu.phy.framesync import (
    OFDMFrameSync,
    _receive_block_graph,
    _scan_block_graph,
    _to_np_planes,
)

__all__ = ["ShardedFrameReceiver", "ShardedStreamReceiver"]


class ShardedFrameReceiver:
    """Fixed-config OFDM receiver sharded over a mesh 'time' axis.

    The stream is split into equal contiguous segments, one per device on
    ``time_axis``; each shard decodes every frame that STARTS inside its
    segment, including frames that straddle into the next shard (via the
    frame-length halo).  Decodes bit-match the single-device receiver.
    """

    def __init__(
        self,
        cfg: OFDMFrameConfig,
        payload_len: int,
        mesh: Mesh,
        *,
        time_axis: str = "time",
        k_per_shard: int = 16,
    ):
        self.cfg = cfg
        self.sync = OFDMFrameSync(cfg, payload_len)
        self.mesh = mesh
        self.time_axis = time_axis
        self.k_per_shard = k_per_shard
        gen = self.sync.gen
        # halo: enough for a frame starting at the last owned sample PLUS the
        # detector's correlation lookahead (win + half ~ 2.5m) and the
        # refinement span (2m)
        self.halo = gen.frame_len + 8 * cfg.num_subcarriers
        self._fn_cache: dict[int, callable] = {}

    def _sharded_fn(self, shard_len: int):
        """Builds the jitted shard_map receive for a given per-shard length."""
        if shard_len in self._fn_cache:
            return self._fn_cache[shard_len]
        gen = self.sync.gen
        halo = self.halo
        axis = self.time_axis
        k = self.k_per_shard
        d = self.mesh.shape[axis]

        def local(rr_l, ri_l):
            # send my HEAD to my LEFT neighbor: shard i receives shard i+1's
            # first `halo` samples (frames spilling rightward stay decodable)
            head_r = jax.lax.slice_in_dim(rr_l, 0, halo, axis=0)
            head_i = jax.lax.slice_in_dim(ri_l, 0, halo, axis=0)
            perm = [(i, (i - 1) % d) for i in range(d)]
            halo_r = jax.lax.ppermute(head_r, axis, perm)
            halo_i = jax.lax.ppermute(head_i, axis, perm)
            ext_r = jnp.concatenate([rr_l, halo_r])
            ext_i = jnp.concatenate([ri_l, halo_i])
            idx = jax.lax.axis_index(axis)
            # the last shard's "right neighbor" is shard 0 (ring wrap): its
            # halo is not stream data, so its valid length stops at the end
            n_valid = jnp.where(idx == d - 1, shard_len, shard_len + halo)
            bests, peaks, cfos, out, ok = _receive_block_graph(
                gen, ext_r, ext_i, n_valid, k=k
            )
            ok = ok & (bests < shard_len)  # ownership: frame starts here
            out = dict(out)
            out["bests"] = bests + idx * shard_len  # absolute offsets
            out["peaks"] = peaks
            out["ok"] = ok
            return out

        specs_out = {
            "headers": P(axis, None),
            "phy": P(axis, None),
            "payloads": P(axis, None),
            "hdr_ok": P(axis),
            "pay_ok": P(axis),
            "evm_db": P(axis),
            "rssi_db": P(axis),
            "cfo": P(axis),
            "bests": P(axis),
            "peaks": P(axis),
            "ok": P(axis),
        }
        fn = jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=specs_out,
                check_vma=False,
            )
        )
        self._fn_cache[shard_len] = fn
        return fn

    def receive(self, iq, threshold: float = 0.2):
        """Decode every frame in ``iq`` (complex or planes, length divisible
        by the mesh's time-axis size).  Returns frames like
        :meth:`OFDMFrameSync.receive_block`: a list of
        {offset, stats, header, payload}, sorted by offset."""
        re_np, im_np = _to_np_planes(iq)
        n = re_np.shape[0]
        d = self.mesh.shape[self.time_axis]
        if n % d:
            pad = d - n % d
            re_np = np.concatenate([re_np, np.zeros(pad, np.float32)])
            im_np = np.concatenate([im_np, np.zeros(pad, np.float32)])
            n += pad
        fn = self._sharded_fn(n // d)
        out = fn(jnp.asarray(re_np), jnp.asarray(im_np))
        out = {kk: np.asarray(v) for kk, v in out.items()}
        frames, consumed_end = [], 0
        for i in np.argsort(out["bests"], kind="stable"):
            off = int(out["bests"][i])
            if out["peaks"][i] < threshold or not out["ok"][i]:
                continue
            if off < consumed_end:
                continue
            frames.append(
                {
                    "offset": off,
                    "stats": self.sync._stats_from(out, int(i)),
                    "header": out["headers"][i],
                    "payload": out["payloads"][i],
                }
            )
            consumed_end = off + self.sync.gen.frame_len
        return frames


class ShardedStreamReceiver:
    """Adaptive (liquid-style) STREAMING receiver over a time-sharded mesh.

    The sharded counterpart of :class:`phy.framesync.StreamReceiver`, with
    both properties liquid's synchronizer has and the fixed-config
    :class:`ShardedFrameReceiver` lacks:

    * **adaptive**: each frame's payload length / modulation / FEC / CRC
      ride its coded PHY header (liquid's ofdmflexframe internal header,
      applied per frame in rxCallback,
      src/extensible_cognitive_radio.cpp:1385-1415), so only the OFDM
      geometry is fixed at construction;
    * **streaming**: a residual buffer carries stream state across
      successive :meth:`receive` calls, so frames straddling BLOCK
      boundaries survive to the next call (liquid keeps equivalent state
      inside ofdmflexframesync across recv boundaries,
      src/extensible_cognitive_radio.cpp:1307).

    Design: detection — the O(N) work — is sharded: one fused per-shard
    scan (top-K Schmidl&Cox + header demod + header FEC/CRC) under
    ``shard_map``, with a HEADER-PREFIX halo ppermuted from the right
    neighbor so candidates near shard seams still decode their headers;
    ownership is by frame start, deduping seam detections.  Decode — the
    O(frames) work — is one batched gather+demod+FEC+CRC dispatch per
    distinct payload config over the whole block, so a frame body may span
    any number of shards without a frame-length halo.
    """

    def __init__(
        self,
        cfg: OFDMFrameConfig,
        mesh: Mesh,
        *,
        time_axis: str = "time",
        k_per_shard: int = 16,
    ):
        self.cfg = cfg
        self.layout = gen_for(cfg, 1)
        m, cp = cfg.num_subcarriers, cfg.cp_len
        self.prefix_len = (
            2 * m + (m + cp) + self.layout.n_header_syms * (m + cp)
        )
        # halo: header prefix + the detector's correlation lookahead
        # (win + half ~ 2.5m) + refinement span (2m)
        self.scan_halo = self.prefix_len + 8 * m
        self.mesh = mesh
        self.time_axis = time_axis
        self.k_per_shard = k_per_shard
        self._syncs: dict[tuple, OFDMFrameSync] = {}
        self._scan_cache: dict[int, callable] = {}
        self._decode_cache: dict[tuple, callable] = {}
        self._residual = np.zeros(0, np.complex64)
        self._residual_offset = 0  # absolute sample index of residual[0]
        # device-resident streaming state (receive_device): replicated
        # residual planes; length tracked host-side (the sharded path's
        # host resolution already has the scan results in hand)
        self._res_r_d = None
        self._res_i_d = None
        self._res_cap = 0
        self._res_len = 0
        self._concat_cache: dict[tuple, callable] = {}
        self._slice_cache: dict[tuple, callable] = {}
        # same contract as StreamReceiver.pending_frame
        self.pending_frame = False

    @property
    def max_residual(self) -> int:
        return 4 * (self.prefix_len + 64 * self.cfg.symbol_len)

    def _sync_for(self, payload_len, mod, f0, f1, check) -> OFDMFrameSync:
        import dataclasses

        key = (payload_len, mod, f0, f1, check)
        if key not in self._syncs:
            cfg = dataclasses.replace(
                self.cfg, mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=check
            )
            self._syncs[key] = OFDMFrameSync(cfg, payload_len)
        return self._syncs[key]

    def _sharded_scan(self, shard_len: int):
        if shard_len in self._scan_cache:
            return self._scan_cache[shard_len]
        layout = self.layout
        halo = self.scan_halo
        axis = self.time_axis
        k = self.k_per_shard
        d = self.mesh.shape[axis]

        def local(rr_l, ri_l, n_global):
            # my HEAD goes to my LEFT neighbor (candidates near the seam
            # need the right neighbor's first `halo` samples to finish
            # their header region)
            head_r = jax.lax.slice_in_dim(rr_l, 0, halo, axis=0)
            head_i = jax.lax.slice_in_dim(ri_l, 0, halo, axis=0)
            perm = [(i, (i - 1) % d) for i in range(d)]
            ext_r = jnp.concatenate([rr_l, jax.lax.ppermute(head_r, axis, perm)])
            ext_i = jnp.concatenate([ri_l, jax.lax.ppermute(head_i, axis, perm)])
            idx = jax.lax.axis_index(axis)
            start = idx * shard_len
            # valid-length clip also masks the LAST shard's ring-wrapped
            # halo (shard 0's head is not stream data there)
            n_valid = jnp.clip(n_global - start, 0, shard_len + halo)
            bests, peaks, cfos, headers, phy, hdr_ok = _scan_block_graph(
                layout, ext_r, ext_i, n_valid, k=k
            )
            own = bests < shard_len  # ownership: frame starts in my segment
            return {
                "bests": bests + start,
                "peaks": jnp.where(own, peaks, -1.0),
                "cfos": cfos,
                "headers": headers,
                "phy": phy,
                "hdr_ok": hdr_ok & own,
            }

        spec = {
            "bests": P(axis),
            "peaks": P(axis),
            "cfos": P(axis),
            "headers": P(axis, None),
            "phy": P(axis, None),
            "hdr_ok": P(axis),
        }
        fn = jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P()),
                out_specs=spec,
                check_vma=False,
            )
        )
        self._scan_cache[shard_len] = fn
        return fn

    def _sharded_decode(self, key: tuple, shard_len: int, gpad: int):
        """Sharded window-gather + batched decode for one payload config.

        The decode stage consumes the SHARDED stream planes, not a
        replicated full buffer: each shard extracts the slice of every
        frame window that overlaps its own segment (one contiguous DMA per
        frame), zero-masks the rest, and a single psum over the time axis
        assembles complete (G, frame_len) windows — the only cross-shard
        traffic, O(G * frame_len).  Per-device live memory is
        O(n/d + G * frame_len) instead of the previous full-buffer
        O(n) `decode_at` (round-3 review item #2), and a frame body may
        still span ANY number of shards.  Decodes bit-match `decode_at`:
        the gathered windows are sample-identical.
        """
        ck = (key, shard_len, gpad)
        if ck in self._decode_cache:
            return self._decode_cache[ck]
        from cognitive_radio_network_tpu.ops.extract import extract_windows
        from cognitive_radio_network_tpu.phy.framesync import _rx_graph

        sync = self._syncs[key]
        gen = sync.gen
        flen = gen.frame_len
        axis = self.time_axis

        def local(rr_l, ri_l, offs, cfs):
            start = jax.lax.axis_index(axis) * shard_len
            pad_r = jnp.pad(rr_l, (flen, flen))
            pad_i = jnp.pad(ri_l, (flen, flen))
            rel = jnp.clip(offs - start + flen, 0, shard_len + flen)
            wr, wi = extract_windows(pad_r, pad_i, rel, flen)  # (G, flen)
            gpos = offs[:, None] + jnp.arange(flen)[None, :]
            owned = (gpos >= start) & (gpos < start + shard_len)
            wr = jax.lax.psum(jnp.where(owned, wr, 0.0), axis)
            wi = jax.lax.psum(jnp.where(owned, wi, 0.0), axis)
            return _rx_graph(gen, wr, wi, cfs)

        fn = jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        self._decode_cache[ck] = fn
        return fn

    def skip(self, n: int) -> None:
        """Advance past ``n`` squelched samples (same contract as
        :meth:`StreamReceiver.skip`)."""
        self._residual_offset += len(self._residual) + int(n)
        self._residual = np.zeros(0, np.complex64)
        self.pending_frame = False

    def carry(self, iq) -> None:
        """Advance past a squelched block keeping an eighth-block + prefix
        residual tail (same contract as :meth:`StreamReceiver.carry`)."""
        re_np, im_np = _to_np_planes(iq)
        block = (re_np + 1j * im_np).astype(np.complex64)
        buf = np.concatenate([self._residual, block])
        keep = min(self.prefix_len + len(block) // 8, len(buf))
        self._residual_offset += len(buf) - keep
        self._residual = buf[len(buf) - keep :]

    def receive(self, iq, threshold: float = 0.2):
        """Append a block of IQ and extract every decodable frame.

        Returns a list of {offset, stats, header, payload} with ``offset``
        the ABSOLUTE sample index in the stream (across calls).  Host-loop
        semantics (candidate ordering, dedup, config grouping, residual
        carry) match :meth:`StreamReceiver.process`, so decodes bit-match
        the single-device receiver."""
        re_np, im_np = _to_np_planes(iq)
        block = re_np + 1j * im_np
        buf = np.concatenate([self._residual, block.astype(np.complex64)])
        base = self._residual_offset
        n = len(buf)
        keep_from = max(n - self.prefix_len, 0)
        if n < self.prefix_len + 4 * self.cfg.num_subcarriers:
            self._residual = buf
            return []

        d = self.mesh.shape[self.time_axis]
        # shard-length buckets (eighth-octave granularity, >= halo so the
        # head slice is in range) bound compilations with ~12.5% typical /
        # ~25% worst-case padding (see framesync._bucket_len) — a full
        # power-of-two round-up wasted up to ~2x per-shard memory and scan
        # compute
        from cognitive_radio_network_tpu.phy.framesync import _bucket_len

        min_len = max(-(-n // d), self.scan_halo, 4 * self.cfg.num_subcarriers)
        shard_len = _bucket_len(min_len)
        tot = d * shard_len
        rr = np.zeros(tot, np.float32)
        ri = np.zeros(tot, np.float32)
        rr[:n] = buf.real
        ri[:n] = buf.imag
        # shard the stream planes across the mesh UP FRONT: both the scan
        # and the windowed decode consume P(time)-sharded inputs, so no
        # device ever materializes the whole block
        sharding = jax.NamedSharding(self.mesh, P(self.time_axis))
        rr_d = jax.device_put(jnp.asarray(rr), sharding)
        ri_d = jax.device_put(jnp.asarray(ri), sharding)

        # dispatch 1: the sharded scan (all shards in one jit call)
        out = self._sharded_scan(shard_len)(rr_d, ri_d, jnp.int32(n))
        bests, peaks, cfos, headers, phys, hdr_ok = (
            np.asarray(out[kk])
            for kk in ("bests", "peaks", "cfos", "headers", "phy", "hdr_ok")
        )

        # host: order candidates by position, resolve configs, group
        # (identical discipline to StreamReceiver.process)
        accepted, consumed_end, keep_from = self._resolve_candidates(
            bests, peaks, hdr_ok, phys, n, threshold, keep_from
        )
        frames = self._decode_accepted(
            accepted, cfos, rr_d, ri_d, shard_len, base
        )

        keep_from = max(keep_from, consumed_end)
        keep_from = max(keep_from, n - self.max_residual)
        self._residual = buf[keep_from:]
        self._residual_offset = base + keep_from
        return frames

    def _resolve_candidates(
        self, bests, peaks, hdr_ok, phys, n, threshold, keep_from
    ):
        """Host side of the adaptive receive: THE SAME resolution loop as
        the single-device receiver, shared by delegation (this class has
        the same _sync_for/prefix_len/pending_frame surface) — the
        sharded and unsharded receivers are tested to bit-match, so the
        acceptance rules must live in exactly one place."""
        from cognitive_radio_network_tpu.phy.framesync import StreamReceiver

        return StreamReceiver._resolve_candidates(
            self, bests, peaks, hdr_ok, phys, n, threshold, keep_from
        )

    def _decode_accepted(self, accepted, cfos, rr_d, ri_d, shard_len, base):
        """Dispatch 2..: one batched sharded gather+demod+decode per
        payload config over the P(time)-sharded stream planes."""
        frames = []
        for parsed, items in accepted.items():
            sync = self._sync_for(*parsed)
            g = len(items)
            # pad to a multiple of k_per_shard so decode-batch shapes bucket
            # (a sharded scan can return up to d*k candidates; padding to
            # exactly g would compile a fresh decode graph per count)
            kpad = -(-g // self.k_per_shard) * self.k_per_shard
            offs = np.zeros(kpad, np.int32)
            cf = np.zeros(kpad, np.float32)
            offs[:g] = [off for off, _ in items]
            cf[:g] = [float(cfos[i]) for _, i in items]
            dec = self._sharded_decode(parsed, shard_len, kpad)(
                rr_d, ri_d, jnp.asarray(offs), jnp.asarray(cf)
            )
            dec = {kk: np.asarray(v) for kk, v in dec.items()}
            for j, (off, _i) in enumerate(items):
                frames.append(
                    {
                        "offset": base + off,
                        "stats": sync._stats_from(dec, j),
                        "header": dec["headers"][j],
                        "payload": dec["payloads"][j],
                    }
                )
        frames.sort(key=lambda f: f["offset"])
        return frames

    # -- device-resident streaming (round-5: no host concat / re-upload) --

    def _device_concat(self, r_cap: int, b: int, tot: int):
        """Jitted [residual | block | zero-pad] assembly, output
        P(time)-sharded: the block is uploaded (or produced on device)
        ONCE and never round-trips the host; the residual chains from the
        previous call's device output."""
        key = (r_cap, b, tot)
        if key in self._concat_cache:
            return self._concat_cache[key]
        import functools

        sh = jax.NamedSharding(self.mesh, P(self.time_axis))

        @functools.partial(jax.jit, out_shardings=(sh, sh))
        def fn(res_r, res_i, blk_r, blk_i):
            pad = jnp.zeros(tot - (r_cap + b), jnp.float32)
            return (
                jnp.concatenate([res_r, blk_r, pad]),
                jnp.concatenate([res_i, blk_i, pad]),
            )

        self._concat_cache[key] = fn
        return fn

    def _device_res_slice(self, n: int, r_cap: int):
        """Jitted residual re-slice: the stream's last r_cap samples
        (buffer index n-r_cap..n), live only past the keep point, output
        replicated (the residual is small; the next concat re-shards)."""
        key = (n, r_cap)
        if key in self._slice_cache:
            return self._slice_cache[key]
        import functools

        rep = jax.NamedSharding(self.mesh, P())

        @functools.partial(jax.jit, out_shardings=(rep, rep))
        def fn(buf_r, buf_i, res_len):
            tail_r = jax.lax.slice_in_dim(buf_r, n - r_cap, n)
            tail_i = jax.lax.slice_in_dim(buf_i, n - r_cap, n)
            live = jnp.arange(r_cap) >= r_cap - res_len
            return jnp.where(live, tail_r, 0.0), jnp.where(live, tail_i, 0.0)

        self._slice_cache[key] = fn
        return fn

    def receive_device(self, blk_r, blk_i, threshold: float = 0.2):
        """Device-resident sharded streaming receive: like
        :meth:`receive`, but the block planes are ALREADY on device and
        the residual carry stays on device — the residual||block
        concatenation happens in a jitted P(time)-sharded assembly, so no
        call ever re-uploads the full buffer from the host (round-4
        verdict #4: the previous `receive` concatenated in host numpy and
        `device_put` the whole padded buffer every block).  Scan and
        decode consume the P(time)-sharded planes exactly as
        :meth:`receive`; decodes bit-match it.  Buffer layout:
        [zeros | residual (right-aligned, r_cap) | block | shard pad]."""
        b = int(blk_r.shape[0])
        from cognitive_radio_network_tpu.phy.framesync import _bucket_len

        r_cap = _bucket_len(self.max_residual)
        if self._res_r_d is None or self._res_cap != r_cap:
            self._res_cap = r_cap
            self._res_len = 0
            rep = jax.NamedSharding(self.mesh, P())
            self._res_r_d = jax.device_put(jnp.zeros(r_cap, jnp.float32), rep)
            self._res_i_d = jax.device_put(jnp.zeros(r_cap, jnp.float32), rep)
        n = r_cap + b  # true stream extent inside the padded buffer
        d = self.mesh.shape[self.time_axis]
        min_len = max(
            -(-n // d), self.scan_halo, 4 * self.cfg.num_subcarriers
        )
        shard_len = _bucket_len(min_len)
        tot = d * shard_len
        buf_r, buf_i = self._device_concat(r_cap, b, tot)(
            self._res_r_d, self._res_i_d, blk_r, blk_i
        )
        lead = r_cap - self._res_len  # leading zeros (not stream data)
        base2 = self._residual_offset - lead
        n_live = self._res_len + b
        keep_from = max(n - self.prefix_len, lead)
        if n_live < self.prefix_len + 4 * self.cfg.num_subcarriers:
            # too short to scan: the whole live region becomes the residual
            self._res_r_d, self._res_i_d = self._device_res_slice(n, r_cap)(
                buf_r, buf_i, jnp.int32(n_live)
            )
            self._res_len = n_live
            return []

        out = self._sharded_scan(shard_len)(buf_r, buf_i, jnp.int32(n))
        bests, peaks, cfos, headers, phys, hdr_ok = (
            np.asarray(out[kk])
            for kk in ("bests", "peaks", "cfos", "headers", "phy", "hdr_ok")
        )
        accepted, consumed_end, keep_from = self._resolve_candidates(
            bests, peaks, hdr_ok, phys, n, threshold, keep_from
        )
        frames = self._decode_accepted(
            accepted, cfos, buf_r, buf_i, shard_len, base2
        )
        keep_from = max(keep_from, consumed_end)
        keep_from = max(keep_from, n - self.max_residual)
        res_len = n - keep_from
        self._res_r_d, self._res_i_d = self._device_res_slice(n, r_cap)(
            buf_r, buf_i, jnp.int32(res_len)
        )
        self._res_len = res_len
        self._residual_offset = base2 + keep_from
        return frames
