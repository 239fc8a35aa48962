"""Device-memory ledger: the single budget that LayerSwapper and KVResizer
trade against (paper Fig. 3f — freed weight bytes become KV blocks).

Invariant (tested, incl. property-based):
    weights(level) + kv_pool + activation_reserve <= hbm_budget
and KV growth beyond the baseline pool is only backed by swap-freed bytes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MemoryLedger:
    hbm_budget: int                    # device bytes available to the worker
    activation_reserve: int            # headroom for activations/temps
    weight_bytes: int                  # current (level-dependent) weights
    kv_block_bytes: int                # bytes of one paged-KV block (all layers)
    kv_blocks: int = 0                 # current pool size in blocks
    # quantize-cold relief tier: blocks compressed in place account at the
    # reduced byte width, so the freed delta is real budget the resizer can
    # turn into extra fp blocks without touching weights or live KV
    kv_quant_blocks: int = 0           # blocks currently held quantized
    kv_quant_block_bytes: int = 0      # bytes of one quantized block

    @property
    def kv_bytes(self) -> int:
        fp = self.kv_blocks - self.kv_quant_blocks
        return fp * self.kv_block_bytes + self.kv_quant_blocks * self.kv_quant_block_bytes

    @property
    def used(self) -> int:
        return self.weight_bytes + self.kv_bytes + self.activation_reserve

    @property
    def free(self) -> int:
        return self.hbm_budget - self.used

    @property
    def bytes_relieved(self) -> int:
        """Budget freed by the quantize-cold tier vs holding fp blocks."""
        return self.kv_quant_blocks * (self.kv_block_bytes - self.kv_quant_block_bytes)

    def ok(self) -> bool:
        return self.free >= 0 and 0 <= self.kv_quant_blocks <= self.kv_blocks

    def max_kv_blocks(self, weight_bytes: int = None) -> int:
        """Largest pool that fits with the given (or current) weight bytes.

        Quantized blocks occupy less than a full block's bytes, so the
        quant savings buy `bytes_relieved // kv_block_bytes` extra fp
        blocks of pool on top of the unquantized capacity.
        """
        wb = self.weight_bytes if weight_bytes is None else weight_bytes
        avail = self.hbm_budget - wb - self.activation_reserve
        avail -= self.kv_quant_blocks * self.kv_quant_block_bytes
        return max(avail // self.kv_block_bytes, 0) + self.kv_quant_blocks

    def set_weights(self, weight_bytes: int) -> None:
        self.weight_bytes = weight_bytes
        assert self.ok(), ("ledger violation: weights grew past budget; "
                           "shrink KV first")

    def quantize_kv(self, blocks: int) -> None:
        """Account `blocks` pool blocks moving fp -> quantized storage."""
        assert blocks >= 0
        assert self.kv_quant_block_bytes > 0 or blocks == 0, \
            "quantize_kv without a configured quant block width"
        self.kv_quant_blocks += blocks
        assert self.ok(), "ledger violation: quantize overran pool size"

    def dequantize_kv(self, blocks: int) -> None:
        """Account `blocks` pool blocks restored quantized -> fp storage."""
        assert 0 <= blocks <= self.kv_quant_blocks
        old = self.kv_quant_blocks
        self.kv_quant_blocks -= blocks
        if not self.ok():
            self.kv_quant_blocks = old
            raise ValueError(
                f"dequantizing {blocks} blocks would exceed budget "
                f"(free={self.free})")

    def resize_kv(self, blocks: int) -> None:
        assert blocks >= 0
        assert self.kv_quant_blocks <= blocks, \
            "ledger violation: shrinking pool below its quantized-block count"
        old = self.kv_blocks
        self.kv_blocks = blocks
        if not self.ok():
            self.kv_blocks = old
            raise ValueError(
                f"KV resize to {blocks} blocks would exceed budget "
                f"(free={self.free + (blocks - old) * self.kv_block_bytes})")
