"""The program's one span recorder: named host spans and integer counters
of a ``generate()`` call (``core.engine``), on ``torch.profiler``'s clock.

``generate()`` opens the root span ``generate`` (``call``); every span
opened until it closes, in any module, belongs to that call.  A span
(``span(name)``):

  * opens the profiler range ``sdf_torch.<name>``, in or outside a call;
  * inside a call, adds its wall time in seconds (a monotonic clock,
    unrounded) to the call's ``stats[name]``, summed over its occurrences;
  * inside a call under ``engine.PROFILE``, appends ``(name, start_ns,
    end_ns, parent)`` to the call's list of spans, a new list each call
    (``stats["spans"]``): ``parent`` is the index of the enclosing span,
    None for the root.  The times are nanoseconds since the Unix epoch, the
    clock ``torch.profiler`` stamps its events with: the monotonic readings
    are mapped onto it through one pair of readings of both clocks taken
    when the call opens.

Counters (``count``) are integers of the call's ``stats``, always on and
zero when the call opens (``COUNTERS``).  Outside a call a span opens only
its profiler range and a counter counts nothing, except a span opened with
``hold=True`` (the host build of a texture, ``ops.textures``, which a
script makes before it calls ``generate()``): the recorder holds its
times, and the next call opened on the same thread takes them.  That call
adds their seconds to its ``stats[name]`` and, under ``engine.PROFILE``,
appends them to its list of spans with their own times and parent None,
after the call's own spans, so no span of the call names them as its
parent; a later call does not see them again.

On a card each round of the bounds refinement is a host wait of its own
(one ``node.fetch`` of the round's values): it counts in ``host_waits``
and, under ``engine.PROFILE``, is timed in ``wait``.
"""

from __future__ import annotations

import contextvars
import threading
import time

import torch

# host_waits: node.fetch calls (each waits for the card once, a bounds round
# evaluated on the card among them); bounds_rounds: probe grids the bounds
# refinement evaluated, on the card or the CPU (engine._estimate_bounds_host);
# bounds_fallbacks: rounds of the card that a near-tie sent to the CPU, whose
# values decide them, so the bounds equal the CPU's wherever the card's
# values lie within engine.BOUNDS_GUARD ulps of them; bounds_cpu_rounds: rounds
# whose values the CPU evaluated (every round without the card's probe, and
# each fallback); kernel_sources: kernel sources generated by the eval
# kernels' launch wrappers and the bounds probe; recorded_fields: the fields
# of gather-bearing subtrees that kernel B1's pre-pass recorded
# (eval_classify.record_fields); card_decodes: meshes decoded on the card by
# kernel D1 (mc.decode_on_card), 0 where the host decodes.
COUNTERS = ("host_waits", "bounds_rounds", "bounds_fallbacks",
            "bounds_cpu_rounds", "kernel_sources", "recorded_fields",
            "card_decodes")

# The open call's _Call, or None: one per thread (and asyncio task).
_CALL = contextvars.ContextVar("sdf_torch_spans_call", default=None)

# The held spans of each thread, ``(name, start_ns, end_ns)`` on the
# profiler's clock, until a call takes them (``span(hold=True)``).
_HELD = threading.local()


def _held():
    """This thread's list of held spans."""
    if not hasattr(_HELD, "spans"):
        _HELD.spans = []
    return _HELD.spans


def _take_held():
    held = _held()
    _HELD.spans = []
    return held


class _Call:
    __slots__ = ("stats", "spans", "stack", "offset")

    def __init__(self, stats, profile):
        self.stats = stats
        self.spans = [] if profile else None
        self.stack = [None]  # indices of the open spans; the root's parent
        # Unix-epoch ns minus monotonic ns, read once for the call.
        self.offset = time.time_ns() - time.perf_counter_ns()


class span:
    """Context manager: the span ``name`` (see the module docstring).
    ``key=False`` keeps the span out of the call's ``stats`` keys (its
    range and its entry in the list of spans stay); ``hold=True`` hands a
    span that closes outside any call to the next call."""

    __slots__ = ("name", "key", "hold", "_rf", "_t0", "_t1", "_at")

    def __init__(self, name, key=True, hold=False):
        self.name = name
        self.key = key
        self.hold = hold

    def __enter__(self):
        self._rf = torch.profiler.record_function("sdf_torch." + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        c = _CALL.get()
        if c is not None and c.spans is not None:
            self._at = len(c.spans)
            c.spans.append((self.name, self._t0 + c.offset, None,
                            c.stack[-1]))
            c.stack.append(self._at)
        return self

    def __exit__(self, *exc):
        self._t1 = time.perf_counter_ns()
        c = _CALL.get()
        if c is not None:
            if self.key:
                c.stats[self.name] = (c.stats.get(self.name, 0.0)
                                      + (self._t1 - self._t0) * 1e-9)
            if c.spans is not None:
                c.stack.pop()
                name, start, _, parent = c.spans[self._at]
                c.spans[self._at] = (name, start, self._t1 + c.offset, parent)
        elif self.hold:
            offset = time.time_ns() - time.perf_counter_ns()
            _held().append((self.name, self._t0 + offset,
                            self._t1 + offset))
        self._rf.__exit__(*exc)
        return False


class call(span):
    """The root span ``generate`` of one call, recording into ``stats``
    (``profile``: ``engine.PROFILE``, which keeps the list of spans).  Its
    length in seconds is ``seconds`` once it has closed; it writes no key
    of its own (``generate()`` reports it as ``total``)."""

    __slots__ = ("stats", "profile", "seconds", "_call", "_token", "_held")

    def __init__(self, stats, profile):
        super().__init__("generate", key=False)
        self.stats = stats
        self.profile = profile

    def __enter__(self):
        self.stats.update(dict.fromkeys(COUNTERS, 0))
        self._held = _take_held()
        for name, start, end in self._held:
            self.stats[name] = self.stats.get(name, 0.0) + (end - start) * 1e-9
        self._call = _Call(self.stats, self.profile)
        self._token = _CALL.set(self._call)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _CALL.reset(self._token)
        self.seconds = (self._t1 - self._t0) * 1e-9
        if self._call.spans is not None:
            self._call.spans.extend((name, start, end, None)
                                    for name, start, end in self._held)
            self.stats["spans"] = self._call.spans
        return False


def count(name, n=1):
    """Add ``n`` to the open call's counter ``name``."""
    c = _CALL.get()
    if c is not None:
        c.stats[name] += n


def put(key, value):
    """Set ``stats[key]`` of the open call."""
    c = _CALL.get()
    if c is not None:
        c.stats[key] = value


def profiling():
    """Whether the open call records its spans (``engine.PROFILE``)."""
    c = _CALL.get()
    return c is not None and c.spans is not None


def clock():
    """The recorder's monotonic clock, ns (for ``since``)."""
    return time.perf_counter_ns()


def since(t0):
    """Seconds from the ``clock()`` reading ``t0`` to now."""
    return (time.perf_counter_ns() - t0) * 1e-9


def fence(device):
    """Wait for the card to finish its queued work, in a ``wait`` span
    (PROFILE's fence before a mesh readback; nothing on the CPU)."""
    if device.type == "cuda":
        with span("wait"):
            torch.cuda.synchronize(device)
