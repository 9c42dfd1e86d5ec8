"""Generators of the configurations' inputs, one module a ``kind``: each
``generate(cfg, seed, device)`` builds its matrix on ``device`` from the
seed and returns it as CSR arrays (``indptr`` and ``indices`` int32,
``data`` or ``None`` for a 0/1 pattern, ``shape``).

A generator for a cell on several cards takes ``rank`` and ``world`` as
keywords too (the harness passes them only there) and builds this rank's
rows alone, on its card: the same arrays with global column indices,
``shape`` ``(its rows, n)`` and ``row0``, its first row."""
