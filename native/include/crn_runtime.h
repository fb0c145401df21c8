/* crn_runtime — native runtime library for cognitive_radio_network_tpu.
 *
 * Native equivalents of the reference's C++ runtime units
 * (0xastro/Cognitive-Radio-Network, mounted read-only at /root/reference):
 *
 *  - IQ stream loader   <- the UHD recv loop + rx buffering of
 *                          src/extensible_cognitive_radio.cpp:1258-1382
 *                          (hardware I/O replaced by recorded-IQ captures):
 *                          mmap'd capture file, slab ring buffer, background
 *                          prefetch thread, resumable sample cursor.
 *  - Binary log engine  <- the raw-struct binary logs + offline converter
 *                          (src/extensible_cognitive_radio.cpp:1844-1864,
 *                          src/convert_logs_bin_to_octave.cpp): CRC32-framed
 *                          append-only record streams, buffered writes,
 *                          integrity-checked reads.
 *  - Framed transport   <- the raw-memcpy TCP star on port 4444
 *                          (src/crts_controller.cpp:245-267,
 *                          src/crts_cognitive_radio.cpp:533-553):
 *                          [u32 len][u8 type] framed messages, listen /
 *                          accept / connect / timeout recv.
 *  - Packet engine      <- liquid msequence + the UDP traffic loop
 *                          (src/crts_cognitive_radio.cpp:750-764, :826-910):
 *                          LFSR PRBS payloads, packet fill with 4-byte
 *                          masked packet numbers, popcount BER oracle.
 *
 * Plain C ABI for ctypes binding; no Python dependency.
 */
#ifndef CRN_RUNTIME_H
#define CRN_RUNTIME_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------- version ---------------- */

uint32_t crn_version(void);

/* ---------------- IQ stream loader ----------------
 * File format: raw interleaved float32 I/Q pairs (8 bytes per sample),
 * matching io/iq.py's IQWriter.  The stream mmaps the capture, and a
 * prefetch thread stages fixed-size blocks into a slab ring so the host
 * loop (feeding the device) never waits on page faults.
 */

typedef struct crn_iq_stream crn_iq_stream;

/* Open a capture.  block_samples: samples per block; depth: ring slots;
 * start_sample: initial cursor; loop: wrap at EOF (1) or stop (0).
 * Returns NULL on error. */
crn_iq_stream *crn_iq_open(const char *path, uint64_t block_samples,
                           uint32_t depth, uint64_t start_sample, int loop);

/* Copy the next block into out (block_samples * 2 floats, interleaved).
 * Returns the number of samples written (== block_samples), 0 at end of
 * stream, or -1 on error.  Blocks until the prefetcher has data. */
int64_t crn_iq_next(crn_iq_stream *s, float *out);

/* Planar variant: copy the next block's I samples into out_i and Q samples
 * into out_q (block_samples floats each).  The de-interleave happened on
 * the prefetch thread, so this is two memcpys.  Same return contract. */
int64_t crn_iq_next_planar(crn_iq_stream *s, float *out_i, float *out_q);

/* Sample index of the NEXT block to be returned (resumable cursor). */
uint64_t crn_iq_cursor(const crn_iq_stream *s);

/* Total samples in the underlying capture. */
uint64_t crn_iq_num_samples(const crn_iq_stream *s);

void crn_iq_close(crn_iq_stream *s);

/* ---------------- Binary log engine ----------------
 * Record framing: [u32 payload_len][u32 crc32(payload)][payload].
 * File header: magic "CRNL", u32 version, u32 stream-name length, name.
 */

typedef struct crn_binlog crn_binlog;

crn_binlog *crn_binlog_create(const char *path, const char *stream_name);
crn_binlog *crn_binlog_open(const char *path); /* read mode */

/* Append one record (write mode).  0 on success, -1 on error. */
int crn_binlog_append(crn_binlog *l, const void *payload, uint32_t len);

/* Flush buffered records to disk (write mode). */
int crn_binlog_flush(crn_binlog *l);

/* Number of records (read mode; scans once at open). */
uint64_t crn_binlog_num_records(const crn_binlog *l);

/* Copy record idx's payload into out (cap bytes).  Returns payload length,
 * -1 on bad index, -2 on CRC mismatch. */
int64_t crn_binlog_record(crn_binlog *l, uint64_t idx, void *out,
                          uint64_t cap);

/* Stream name of an opened log (NUL-terminated, valid until close). */
const char *crn_binlog_stream_name(const crn_binlog *l);

void crn_binlog_close(crn_binlog *l);

/* CRC32 (IEEE, reflected) of a buffer — exposed for the Python fallback
 * and for tests. */
uint32_t crn_crc32(const void *data, uint64_t len);

/* ---------------- Framed TCP transport ---------------- */

/* Listen on 0.0.0.0:port.  Returns server fd or -1. */
int crn_tcp_listen(uint16_t port);

/* Accept with timeout.  Returns connection fd, -2 on timeout, -1 error. */
int crn_tcp_accept(int server_fd, int timeout_ms);

/* Connect to host:port (numeric or name).  Returns fd or -1. */
int crn_tcp_connect(const char *host, uint16_t port, int timeout_ms);

/* Send one framed message: [u32 len][u8 type][payload].  0 / -1. */
int crn_msg_send(int fd, uint8_t type, const void *payload, uint32_t len);

/* Send one framed message whose payload is the concatenation a||b, gathered
 * with writev so neither part is copied on the sending side (the medium
 * block path ships ~0.5 MB numpy buffers: a is the small step header, b the
 * raw sample buffer).  0 / -1. */
int crn_msg_send2(int fd, uint8_t type, const void *a, uint32_t na,
                  const void *b, uint32_t nb);

/* Receive one framed message.  On success returns payload length and sets
 * *type.  Returns -2 on timeout (no message started), -3 if the peer
 * closed cleanly, -4 if payload exceeds cap, -1 on error. */
int64_t crn_msg_recv(int fd, uint8_t *type, void *buf, uint64_t cap,
                     int timeout_ms);

void crn_tcp_close(int fd);

/* ---------------- Packet engine ---------------- */

/* Generate n bytes of an m-sequence PRBS from an m-bit Fibonacci LFSR with
 * the given feedback polynomial (tap mask over the m-bit state; x^m term
 * implicit) and nonzero initial state.  Per step: out_bit = msb(state);
 * feedback = parity(state & gen_poly); state = ((state<<1)|feedback) & mask.
 * Bits pack MSB-first within each byte — bit-identical to
 * signal/msequence.py. */
void crn_msequence_bytes(uint32_t m, uint32_t gen_poly, uint32_t init_state,
                         uint8_t *out, uint64_t n);

/* Fill num_packets packets of packet_len bytes each from payload_template
 * (packet_len bytes), overwriting bytes [0,4) of each with the packet
 * number little-endian (bit-identical to runtime/traffic.py; the reference
 * instead ORs marker bits per byte, src/crts_cognitive_radio.cpp:757-763).
 * Packets are laid out back to back in out. */
void crn_fill_packets(uint8_t *out, uint32_t num_packets, uint32_t packet_len,
                      uint32_t first_num, const uint8_t *payload_template);

/* Recover the packet number from a filled packet header. */
uint32_t crn_packet_number(const uint8_t *packet);

/* Bit errors between two buffers (XOR + popcount — the BER oracle of
 * src/extensible_cognitive_radio.cpp:1586-1594). */
uint64_t crn_bit_errors(const uint8_t *a, const uint8_t *b, uint64_t n);

#ifdef __cplusplus
}
#endif

#endif /* CRN_RUNTIME_H */
