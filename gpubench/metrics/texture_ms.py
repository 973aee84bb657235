"""Mean host time of the texture build a request, ms:
``LAST_STATS["texture"]``, the ``texture`` spans of ``ops.textures``
(the image loaded, both exact distance transforms, the signed texture and
its parameter leaf) built before the call and taken into its stats,
requests outside the profiled stretch."""


def read(ctx):
    vals = [s["texture"] for s in ctx["stats"] if "texture" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
