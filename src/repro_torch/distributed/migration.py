"""Cross-replica paged-KV migration: the transfer channel and its failure
semantics.

MorphServe's promise is *state-preserving* transitions under pressure; this
module extends that promise across replica boundaries (BanaServe's unified
KV treated as a migratable resource). A request's computed state — its
paged-KV block contents plus scheduling/identity metadata, exported by
``MorphServeEngine.export_request_state`` — is streamed to a peer replica in
fixed-size block chunks over a modeled inter-replica link:

  * **cost** is fed through :class:`repro_torch.engine.cost_model.CostModel`
    (per-transfer setup latency + wire bytes over the link), so the control
    plane can weigh a migration against the re-prefill it replaces;
  * **optional int8 compression** of in-flight blocks (KVServe's
    observation that compressed KV makes transfers cheap enough to use
    routinely) halves/quarters wire bytes — at the cost of bit-identity of
    the migrated KV, so it is off by default and benches opt in;
  * **per-chunk checksums** (CRC32 over the wire encoding) catch in-flight
    corruption; decoded chunks are buffered and committed only when every
    checksum verifies, so a corrupt transfer aborts with *nothing* written
    at the destination;
  * **explicit failure semantics**: a transfer that stalls past
    ``stall_timeout_s``, fails a checksum, or loses its destination
    mid-import aborts cleanly and the cluster falls back to the
    recompute-redispatch path — a migration can be wasted work, but it can
    never strand a request or double-run it.

Fault injection at this seam lives in ``faults.MigrationFaults``
(``migration_stall`` / ``migration_corrupt`` / ``migration_dest_kill``),
drawn from a dedicated seeded stream so chaos replays stay bit-identical.

The channel runs on the host, on numpy arrays, as the JAX package's does:
a real-compute payload is ``PagedKVPool.gather_blocks``'s device → host
copy, and the importer's ``scatter_blocks`` copies it back to its card.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import kv_codec
from repro_torch.engine.cost_model import CostModel


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs of the inter-replica KV transfer fabric."""
    link_gbps: float = 26.0          # NVLink/PCIe-class inter-replica link
    latency_s: float = 2e-3          # per-transfer setup cost
    chunk_blocks: int = 8            # KV blocks streamed per checksummed chunk
    compress_int8: bool = False      # quantize in-flight blocks (lossy!)
    stall_timeout_s: float = 1.5     # abort a transfer stalled past this
    # replica-crossing prefix-cache lookups: migrate a peer's cached prefix
    # blocks to the dispatch target instead of recomputing them there
    prefix_migration: bool = True
    min_prefix_blocks: int = 2       # don't bother below this many blocks


@dataclasses.dataclass
class MigrationResult:
    """Outcome of one transfer attempt (request KV or prefix blocks)."""
    ok: bool
    reason: str                      # ok|stall|corrupt|no_slot|no_capacity|
    #                                  dest_dead|no_target|not_exportable
    time_s: float = 0.0              # modeled wall time spent on the wire
    bytes: int = 0
    chunks: int = 0
    # checksummed pass-through of a pre-quantized sidecar payload (blocks
    # the quantize-cold tier already compressed travel as-is — see
    # ``MigrationChannel.transfer``'s ``quant`` kwarg); None otherwise
    quant: Optional[tuple] = None


class MigrationChannel:
    """The modeled transfer fabric between two replicas' KV pools.

    ``transfer`` moves a block payload (numpy arrays from
    ``PagedKVPool.gather_blocks``, or None in simulated compute where only
    the byte volume is modeled) and returns the received payload plus a
    :class:`MigrationResult`. All failure modes surface in the result —
    nothing raises — so callers always take an explicit fallback branch.
    """

    def __init__(self, cfg: MigrationConfig, cost: CostModel,
                 dtype_bytes: int = 2):
        self.cfg = cfg
        self.cost = cost
        self.dtype_bytes = max(dtype_bytes, 1)
        self.link_bps = cfg.link_gbps * 1e9
        # lifetime counters (bench/test observability)
        self.transfers = 0
        self.aborted_stall = 0
        self.aborted_corrupt = 0
        self.total_bytes = 0
        self.total_time_s = 0.0
        self.chunks_verified = 0

    def compress_ratio(self) -> float:
        return (1.0 / self.dtype_bytes) if self.cfg.compress_int8 else 1.0

    def transfer_time(self, n_blocks: int) -> float:
        return self.cost.kv_migration_time(
            n_blocks, self.link_bps, self.cfg.latency_s,
            self.compress_ratio())

    # ------------------------------------------------------------------
    def transfer(self, n_blocks: int, k: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None, *, quant=None,
                 quant_bits: int = 8, quant_blocks: int = 0, faults=None,
                 now: float = 0.0):
        """Stream ``n_blocks`` of KV over the link in checksummed chunks.

        Returns ``(result, k_recv, v_recv)``. On any abort the received
        payload is None — the destination commits nothing.

        ``quant`` carries blocks the quantize-cold tier already holds in
        int8/int4 form (a ``PagedKVPool.gather_quant_blocks`` tuple; the
        matching positions in ``k``/``v`` are fp zeros). They cross the
        wire *as-is* — codec payload plus per-block scale/zero sidecar in
        one extra checksummed chunk, int4 nibble-packed — and come back on
        ``result.quant`` for direct scatter at the destination, with no
        dequantize/requantize round trip. Sim-compute callers pass
        ``quant_blocks`` instead to model the reduced wire bytes."""
        self.transfers += 1
        cb = max(self.cfg.chunk_blocks, 1)
        n_chunks = -(-n_blocks // cb) if n_blocks else 0
        nq = quant[0].shape[1] if quant is not None else int(quant_blocks)
        nq = min(max(nq, 0), n_blocks)
        # pre-quantized blocks ship at their codec width; the fp remainder
        # at the channel's own (optional) in-flight compression ratio
        q_ratio = (quant_bits / 8.0) / self.dtype_bytes
        wire_bytes = (self.cost.kv_migration_bytes(n_blocks - nq,
                                                   self.compress_ratio())
                      + self.cost.kv_migration_bytes(nq, q_ratio))
        full = self.cost.kv_migration_bytes(n_blocks, 1.0)
        eff_ratio = (wire_bytes / full) if full else self.compress_ratio()
        t = self.cost.kv_migration_time(n_blocks, self.link_bps,
                                        self.cfg.latency_s, eff_ratio)
        stall_s = faults.stall_seconds(now) if faults is not None else 0.0
        if stall_s:
            if t + stall_s > self.cfg.stall_timeout_s:
                # transfer wedged (fabric congestion, dead peer link):
                # abandon after the timeout, state stays at the source
                self.aborted_stall += 1
                self.total_time_s += self.cfg.stall_timeout_s
                return (MigrationResult(False, "stall",
                                        self.cfg.stall_timeout_s,
                                        0, 0), None, None)
            t += stall_s
        corrupt = (faults.corrupt_should_fire(now)
                   if faults is not None else False)
        if k is None:
            # simulated compute: no real payload; model the verify/abort
            if corrupt:
                self.aborted_corrupt += 1
                self.total_time_s += t
                return MigrationResult(False, "corrupt", t, 0, 0), None, None
            self.chunks_verified += n_chunks
            self.total_bytes += wire_bytes
            self.total_time_s += t
            return (MigrationResult(True, "ok", t, wire_bytes, n_chunks),
                    None, None)
        # real payload: encode → (maybe corrupt) → verify → decode, buffered
        recv_k: List[np.ndarray] = []
        recv_v: List[np.ndarray] = []
        for ci in range(n_chunks):
            a, b = ci * cb, min((ci + 1) * cb, n_blocks)
            parts = [("k", k[:, a:b])]
            if v is not None:
                parts.append(("v", v[:, a:b]))
            decoded = {}
            chunk_ok = True
            for name, x in parts:
                if self.cfg.compress_int8:
                    q, scale = kv_codec.symmetric_quantize_np(x)
                    blob = q.tobytes()
                    out = kv_codec.symmetric_dequantize_np(q, scale, x.dtype)
                else:
                    blob = np.ascontiguousarray(x).tobytes()
                    out = x
                crc = zlib.crc32(blob)
                if corrupt and ci == 0 and name == "k":
                    blob = bytearray(blob)
                    blob[0] ^= 0xFF             # one flipped wire byte
                    blob = bytes(blob)
                if zlib.crc32(blob) != crc:
                    chunk_ok = False
                    break
                decoded[name] = out
            if not chunk_ok:
                self.aborted_corrupt += 1
                self.total_time_s += t
                return MigrationResult(False, "corrupt", t, 0, ci), None, None
            self.chunks_verified += 1
            recv_k.append(decoded["k"])
            if v is not None:
                recv_v.append(decoded["v"])
        quant_out = None
        if quant is not None:
            quant_out, q_chunks, ok = self._transfer_quant(quant, quant_bits)
            n_chunks += q_chunks
            if not ok:
                self.aborted_corrupt += 1
                self.total_time_s += t
                return (MigrationResult(False, "corrupt", t, 0, n_chunks),
                        None, None)
        k_out = np.concatenate(recv_k, axis=1) if recv_k else k
        v_out = (np.concatenate(recv_v, axis=1) if recv_v else None) \
            if v is not None else None
        self.total_bytes += wire_bytes
        self.total_time_s += t
        return (MigrationResult(True, "ok", t, wire_bytes, n_chunks,
                                quant=quant_out), k_out, v_out)

    def _transfer_quant(self, quant, bits: int):
        """Wire-encode a pre-quantized sidecar payload as one checksummed
        chunk: int8 codes travel raw, int4 nibble-packed, scale/zero planes
        as f32 — then decode back to the gather tuple shape. Returns
        ``(quant_out, n_chunks, ok)``."""
        out = []
        for a in quant:
            if a is None:
                out.append(None)
                continue
            a = np.asarray(a)
            packed4 = a.dtype == np.int8 and bits == 4
            blob = (kv_codec.pack_int4(a) if packed4
                    else np.ascontiguousarray(a).tobytes())
            crc = zlib.crc32(blob)
            if zlib.crc32(blob) != crc:
                return None, 1, False
            if packed4:
                out.append(kv_codec.unpack_int4(blob, a.shape))
            else:
                out.append(np.frombuffer(
                    blob, dtype=a.dtype).reshape(a.shape).copy())
        self.chunks_verified += 1
        return tuple(out), 1, True

    def stats(self) -> dict:
        return {"transfers": self.transfers,
                "aborted_stall": self.aborted_stall,
                "aborted_corrupt": self.aborted_corrupt,
                "bytes": self.total_bytes,
                "time_s": self.total_time_s,
                "chunks_verified": self.chunks_verified}
