"""``d2h_ms`` in the cells that report ``mesh_p95_ms`` and not
``mesh_ms`` (the interactive cells): the same reading, moving the tail."""

import harness

read = harness.reader("d2h_ms").read
