"""Mutability — race-free, stream-ordered live mutation of running components.

Re-creation of the reference's L1 (``mutable/mutable.go:10-122``,
``mutable/pusher.go:5-57``) as a host-side control plane. The invariant the
reference enforces with goroutine ownership — a mutation only ever executes
inside the execution context that owns the component (``mutable/doc.go:4-7``)
— holds here structurally: mutation functions run on the executor thread at a
block boundary, never concurrently with the block step. Parameters are
tensors the step reads each block, so a mutation is just a new value.

Semantics preserved from the reference:

- A ``Context`` is an identity token; the zero/immutable context cannot be
  mutated (``mutable.go:41-43`` panics; we raise).
- ``Mutations`` is an ordered multimap context -> [fns]; ``apply_to`` runs the
  fns for one context in push order, stops at the first error (leaving the
  entry in place, as ``mutable.go:79-94`` does), and removes the entry on
  success.
- ``Pusher`` accumulates mutations per destination and delivers batches;
  unknown contexts are a programming error (``pusher.go:41`` panics; we raise).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

MutatorFunc = Callable[[], None]  # raises on error


class ImmutableContextError(RuntimeError):
    """Raised when mutating the immutable context (reference panics,
    ``mutable/mutable.go:41-43``)."""


class UnknownContextError(KeyError):
    """Raised when pushing a mutation for a context the pusher doesn't know
    (reference panics, ``mutable/pusher.go:41``)."""


class LateTargetError(RuntimeError):
    """A block-indexed mutation arrived after its target block was already
    dispatched, under strict delivery (multi-host pipes): applying it at a
    host-local later block would silently desynchronize the replicated
    streams, so the run fails loudly instead. Push with more headroom
    (target comfortably past the current ``Pipe.block_index`` plus
    ``lookahead * batch_blocks``)."""


class Context:
    """Identity token for a mutable component (``mutable/mutable.go:12``).

    Instances are compared by identity of their random id. The singleton
    :data:`IMMUTABLE` plays the zero-value role.
    """

    __slots__ = ("_id",)

    def __init__(self, _id: Optional[bytes] = None):
        self._id = _id if _id is not None else os.urandom(16)

    def is_mutable(self) -> bool:
        return self._id != b"\x00" * 16

    def mutate(self, fn: MutatorFunc) -> "Mutation":
        if not self.is_mutable():
            raise ImmutableContextError("mutate immutable context")
        return Mutation(self, fn)

    def __eq__(self, other) -> bool:
        return isinstance(other, Context) and self._id == other._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        if not self.is_mutable():
            return "Context(immutable)"
        return f"Context({self._id.hex()[:8]})"


IMMUTABLE = Context(b"\x00" * 16)


def mutable() -> Context:
    """New mutable context (``mutable.Mutable()``)."""
    return Context()


def immutable() -> Context:
    """The immutable context (``mutable.Immutable()``)."""
    return IMMUTABLE


class Mutation:
    """A mutator function bound to a context (``mutable/mutable.go:15-19``)."""

    __slots__ = ("context", "_fn")

    def __init__(self, context: Context, fn: MutatorFunc):
        self.context = context
        self._fn = fn

    def apply(self) -> None:
        self._fn()

    def __repr__(self) -> str:
        return f"Mutation({self.context!r})"


class Mutations:
    """Ordered multimap ``Context -> [MutatorFunc]``
    (``mutable/mutable.go:22``). A fresh empty instance is falsy."""

    __slots__ = ("_m",)

    def __init__(self):
        self._m: Dict[Context, List[MutatorFunc]] = {}

    def put(self, m: Mutation) -> "Mutations":
        """Add one mutation; no-op for the immutable context
        (``mutable.go:61-76``)."""
        if not m.context.is_mutable():
            return self
        self._m.setdefault(m.context, []).append(m._fn)
        return self

    def apply_to(self, ctx: Context) -> None:
        """Run all mutators for ``ctx`` in push order. On an exception the
        entry stays (matching ``mutable.go:79-94``: error returns before the
        delete); on success it is removed."""
        if ctx not in self._m or not ctx.is_mutable():
            return
        for fn in self._m[ctx]:
            fn()  # raises through, leaving the entry in place
        del self._m[ctx]

    def append(self, other: Optional["Mutations"]) -> "Mutations":
        """Merge another set into this one, preserving per-context order
        (``mutable.go:97-109``)."""
        if other is None:
            return self
        for ctx, fns in other._m.items():
            self._m.setdefault(ctx, []).extend(fns)
        return self

    def detach(self, ctx: Context) -> Optional["Mutations"]:
        """Remove and return the mutations for one context
        (``mutable.go:112-122``)."""
        if ctx not in self._m:
            return None
        d = Mutations()
        d._m[ctx] = self._m.pop(ctx)
        return d

    def contexts(self):
        return list(self._m.keys())

    def __bool__(self) -> bool:
        return bool(self._m)

    def __len__(self) -> int:
        return sum(len(v) for v in self._m.values())


class Destination:
    """Per-executor mutation mailbox.

    The reference uses a cap-1 channel (``pusher.go:29-31``) polled
    non-blockingly by the source each buffer (``pipe.go:382-392``). Here the
    mailbox merges pending batches under a lock and the executor thread swaps
    the whole batch out at each block boundary — same delivery point, no drops,
    no blocking.

    **Block-indexed delivery**: a batch may be tagged with a target stream
    block index (the owning executor's dispatch counter). The executor
    applies it exactly before dispatching that block — under any
    ``lookahead``/``batch_blocks`` setting it splits a dispatch batch at the
    boundary — restoring the reference's deterministic sample-stream
    ordering (``pipe.go:381-413``) when the perf knobs are on. Untagged
    batches apply at the next dispatch, the reference's next-buffer
    guarantee.
    """

    __slots__ = ("_lock", "_pending", "_targeted")

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Optional[Mutations] = None
        # ordered [(target_block, Mutations)]; applied when the executor's
        # dispatch frontier reaches target_block
        self._targeted: List = []

    def put(self, ms: Mutations, at_block: Optional[int] = None) -> None:
        with self._lock:
            if at_block is None:
                if self._pending is None:
                    self._pending = Mutations().append(ms)
                else:
                    self._pending.append(ms)
            else:
                self._targeted.append((int(at_block), Mutations().append(ms)))

    def take(self) -> Optional[Mutations]:
        """Returns and clears EVERYTHING pending (untargeted and targeted
        alike) in target order — ``take_due`` at an infinite frontier. The
        runtime delivers through ``take_due``; this is the drain-all seam."""
        return self.take_due(float("inf"))

    def take_due(self, frontier: int, strict: bool = False) -> Optional[Mutations]:
        """Batches due at dispatch frontier ``frontier``: every untargeted
        batch plus targeted batches with ``target <= frontier``.

        ``strict`` (multi-host delivery): a target STRICTLY below the
        frontier raises :class:`LateTargetError` instead of merging — a
        late landing would be host-local and silently desynchronize the
        replicated streams; deterministic-or-fail is the contract that
        makes batched dispatch splits replicated across hosts.
        (``target == frontier`` is an exact landing: the executor capped
        its previous dispatch right there.)"""
        with self._lock:
            if strict and self._targeted:
                # check BEFORE popping the pending batch: the raise must be
                # side-effect-free (nothing silently dropped)
                late = [e[0] for e in self._targeted if e[0] < frontier]
                if late:
                    raise LateTargetError(
                        f"targeted mutation(s) at block(s) {late} arrived "
                        f"after the dispatch frontier ({frontier})"
                    )
            ms, self._pending = self._pending, None
            if self._targeted:
                due = [e for e in self._targeted if e[0] <= frontier]
                if due:
                    self._targeted = [
                        e for e in self._targeted if e[0] > frontier
                    ]
                    merged = ms if ms is not None else Mutations()
                    for _, t in sorted(due, key=lambda e: e[0]):
                        merged.append(t)
                    return merged
            return ms

    def next_target(self, frontier: int) -> Optional[int]:
        """The nearest pending target block strictly past ``frontier`` (the
        executor caps its dispatch batch there)."""
        with self._lock:
            future = [b for b, _ in self._targeted if b > frontier]
            return min(future) if future else None

    def pending_targets(self) -> List[int]:
        """Target block indices of undelivered block-indexed batches (the
        multi-host end-of-stream audit reads this: a target the stream
        never reached must fail loudly, not vanish)."""
        with self._lock:
            return [b for b, _ in self._targeted]

    def clear_targeted(self) -> None:
        """Drop undelivered block-indexed batches. A restarted pipe is a NEW
        stream (reference ``pipe_test.go:108-131``): an ``at_block=N`` push
        is a coordinate of the stream it was pushed into, so a target the
        previous stream never reached must not fire at block N of the next
        one. Untargeted batches survive — they mean "the next dispatched
        block", whichever stream that is."""
        with self._lock:
            self._targeted = []


def new_destination() -> Destination:
    return Destination()


class Pusher:
    """Routes mutations to the destination owning each context
    (``mutable/pusher.go:5-57``). Thread-safe: the control thread and —
    since r4's untargeted-push agreement — the executor thread's health
    rounds both stage/deliver concurrently, so staging is lock-protected
    (the reference's Pusher is single-goroutine and needs none)."""

    def __init__(self):
        self._destinations: Dict[Context, Destination] = {}
        # per destination: ordered [(at_block | None, Mutations)]
        self._staged: Dict[Destination, List] = {}
        self._plock = threading.Lock()

    def add_destination(self, ctx: Context, dest: Destination) -> None:
        with self._plock:
            self._destinations[ctx] = dest

    def clear_targeted(self) -> None:
        """Drop undelivered block-indexed batches in every destination (see
        :meth:`Destination.clear_targeted`; called on pipe restart)."""
        with self._plock:
            dests = set(self._destinations.values())
        for dest in dests:
            dest.clear_targeted()

    def has_destination(self, ctx: Context) -> bool:
        with self._plock:
            return ctx in self._destinations

    def put(self, *mutations: Mutation, at_block: Optional[int] = None) -> None:
        """Stage mutations; raises on unknown context (``pusher.go:41``).
        ``at_block`` tags them for block-indexed delivery (see
        :class:`Destination`)."""
        with self._plock:
            for m in mutations:
                dest = self._destinations.get(m.context)
                if dest is None:
                    raise UnknownContextError(
                        f"unknown mutable context {m.context!r}"
                    )
                entries = self._staged.setdefault(dest, [])
                if entries and entries[-1][0] == at_block:
                    entries[-1][1].put(m)
                else:
                    entries.append((at_block, Mutations().put(m)))

    def push(self) -> None:
        """Deliver all staged batches to their destinations."""
        with self._plock:
            staged, self._staged = self._staged, {}
        for dest, entries in staged.items():
            for at_block, ms in entries:
                if ms:
                    dest.put(ms, at_block=at_block)
