"""Request lifecycle for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Cheap deterministic 64-bit mixer (splitmix64 finalizer)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def sim_token(token_seed: int, position: int, vocab: int) -> int:
    """Simulated-compute 'model': the token at absolute context position
    ``position`` is a pure function of the request's ``token_seed``.

    This is what makes failover comparable bit-for-bit: a request that is
    preempted, re-dispatched to another replica, or migrated mid-decode
    regenerates exactly the token stream the uninterrupted run would have
    produced — engine-local rng state never leaks into token content."""
    return _splitmix64(token_seed ^ _splitmix64(position)) % max(vocab, 1)


def derive_token_seed(prompt: List[int]) -> int:
    """Deterministic token seed from the original prompt content — the sim
    'model identity' of a request (identical prompts generate identically)."""
    h = 0x243F6A8885A308D3
    for t in prompt:
        h = _splitmix64(h ^ (int(t) & _M64))
    return h


class RState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"        # holds a slot; prompt partially paged
    RUNNING = "running"
    PREEMPTED = "preempted"          # blocks freed; must re-prefill
    FINISHED = "finished"
    FAILED = "failed"                # terminal: rejected / unservable
    # terminal: refused by admission control under overload — the estimated
    # queue delay exceeded the request's class deadline with no morph-relief
    # headroom left, so the engine said "no" at the front door instead of
    # letting the request time out silently in the queue
    SHED = "shed"


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt: List[int]                 # token ids
    max_new_tokens: int
    state: RState = RState.QUEUED
    slot: int = -1                    # decode slot when RUNNING/PREFILLING
    block_ids: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    # chunked prefill: prompt tokens already written to the paged KV pool.
    # Preemption frees the blocks (recompute policy), so it resets to 0; the
    # request resumes as a fresh PREFILLING admission.
    prefill_pos: int = 0
    prefill_chunks: int = 0           # chunk calls spent on the prompt
    # --- prefix cache ------------------------------------------------------
    # leading block_ids borrowed read-only from the PrefixCache (COW share
    # boundary: the request's own writes start at block ``shared_blocks``)
    shared_blocks: int = 0
    # swap level each full prompt block's KV was written under (None =
    # unwritten, -1 = chunks at mixed levels — unpublishable)
    block_write_levels: List[Optional[int]] = dataclasses.field(
        default_factory=list)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    # morphing bookkeeping: swap level under which each token was generated
    token_levels: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # consecutive transient KV-allocation failures ridden out (reset on the
    # first successful allocation); past the engine's retry limit the
    # request escalates to the preemption path
    alloc_retries: int = 0
    # cluster-wide logical request id: preserved across re-dispatch so the
    # control plane can cap retries per *logical* request and the chaos
    # bench can assert every trace request reached a terminal state
    cluster_id: Optional[int] = None
    # sim-compute token stream seed: fixed at first submit and preserved
    # verbatim across preemption / re-dispatch / migration, so the logical
    # request's token stream is a pure function of (seed, position)
    token_seed: int = 0
    # identity as originally submitted: preemption and re-dispatch fold
    # generated tokens into the prompt and shrink max_new_tokens, so the
    # originals must ride along for faithful terminal records and for
    # reconstructing the logical token stream (prompt[orig_prompt_len:]
    # + generated)
    orig_prompt_len: int = -1
    orig_max_new_tokens: int = -1
    # SLO class name (keys traces.SLO_CLASSES): drives deadline-slack
    # ordering, admission control, preemption victim selection, and
    # per-class reporting
    slo_class: str = "interactive"
    # starvation-bounded aging: set once the request's queue wait crosses
    # its class's age_after_s — from then on its priority rises until it
    # outranks fresh interactive work (the scheduler gates on never
    # bypassing an aged request)
    aged: bool = False
    # first time the scheduler gave this request prefill work (slot +
    # blocks) — per-class queue-wait accounting; preserved across
    # preemption (unlike prefill_pos)
    sched_first_s: Optional[float] = None
    # quantized-KV tolerance tag: set when this request adopted a prefix
    # cache entry whose KV is (or was re-)quantized below fp precision,
    # e.g. "int8" — surfaces the approximation in terminal records
    tol: Optional[str] = None

    def __post_init__(self):
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = len(self.prompt)
        if self.orig_max_new_tokens < 0:
            self.orig_max_new_tokens = self.max_new_tokens

    def logical_stream(self) -> List[int]:
        """Every token generated on behalf of the *logical* request,
        including generations folded into the prompt by recompute."""
        return list(self.prompt[self.orig_prompt_len:]) + list(self.generated)

    def note_prefill_levels(self, start: int, end: int, level: int,
                            block_size: int) -> None:
        """Record the swap level whose weights produced the KV for prompt
        positions [start, end) — per full prompt block, for publishing to
        the prefix cache. A block touched by chunks at different levels is
        marked mixed (-1) and never published."""
        n_full = len(self.prompt) // block_size
        if end <= start or n_full == 0:
            return
        if len(self.block_write_levels) != n_full:
            self.block_write_levels = [None] * n_full
        b1 = min((end - 1) // block_size, n_full - 1)
        for b in range(start // block_size, b1 + 1):
            cur = self.block_write_levels[b]
            if cur is None:
                self.block_write_levels[b] = level
            elif cur != level:
                self.block_write_levels[b] = -1

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prefill_pos

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    def tpots(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    def degraded_token_frac(self) -> float:
        """Fraction of generated tokens produced under any swapped layer —
        the paper's token-level degradation confinement metric."""
        if not self.token_levels:
            return 0.0
        return sum(1 for l in self.token_levels if l > 0) / len(self.token_levels)
