"""The general solve loops that a traffic mix's data file names by
``"solver"``: each module's ``Solves(inputs, params, seed, device,
spans, control=False)`` builds the port's objects (``build``), runs solve
``i`` of the window (``solve``), frees the port's state (``release``) and
then holds what it kept to the plain reference (``compare``).

``control=True`` builds the port's own lower-precision path instead
(``params["control"]``), for :mod:`portbench.control` only.

A loop for a cell on several cards takes ``rank`` and ``world`` as
keywords too (only there), gets this rank's rows from the generator, and
runs in the default process group that the harness started: every rank
makes the same calls, solve ``i`` on every rank at once, and each rank's
``compare`` holds its own rows to the reference."""
