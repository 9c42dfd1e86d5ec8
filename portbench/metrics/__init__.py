"""One reader a metric, ``<metric name>.py``, each with ``read(rec)``:
the metric's value from the run's record, or None where the record holds
nothing to read (the harness then leaves the metric out of the line).

``rec`` holds ``setup_s``, ``times`` (each solve's seconds in the window),
``window_s``, ``plan_s`` (the port's set-up calls), ``info`` (the solve loop's
``iterations``, mean a solve), ``spans`` (``calls`` and ``least_s`` by
range, over the traced solves) and ``trace`` (:func:`portbench.trace.
summarize`, or None).

In a cell on several cards (:mod:`portbench.launch`) ``rec`` is rank 0's,
but for ``plan_s``, the slowest rank's, and it holds ``ranks`` too: every
rank's own record, in rank order, for a metric that reads the worst rank.
A reader runs in rank 0's process: what it takes from the port's own
tracing (:mod:`portbench.port_trace`) is rank 0's."""
