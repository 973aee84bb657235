"""Mean host time a request spends under no span but the root, ms: the
self time of the root span ``generate`` in ``LAST_STATS["spans"]``
(``engine.PROFILE`` keeps the list), its length less the union of its
children's intervals, requests outside the profiled stretch.  Host work a
change adds outside every span shows here."""


def self_ns(spans):
    """The root's length less what its children cover, ns; ``spans`` are
    ``(name, start_ns, end_ns, parent)`` with the root's parent None."""
    (root,) = [i for i, s in enumerate(spans) if s[3] is None]
    a, b = spans[root][1], spans[root][2]
    covered, edge = 0, a
    for s, e in sorted((max(s[1], a), min(s[2], b)) for s in spans
                       if s[3] == root):
        s = max(s, edge)
        if e > s:
            covered += e - s
            edge = e
    return (b - a) - covered


def read(ctx):
    vals = [self_ns(s["spans"]) for s in ctx["stats"] if s.get("spans")]
    return 1e-6 * sum(vals) / len(vals) if vals else None
