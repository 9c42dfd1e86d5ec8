"""Generators of the configurations' inputs, one module a ``kind``: each
``generate(cfg, seed, device)`` builds its matrix on ``device`` from the
seed and returns it as CSR arrays (``indptr`` and ``indices`` int32,
``data`` or ``None`` for a 0/1 pattern, ``shape``)."""
