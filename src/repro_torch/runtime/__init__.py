"""Pilot runtime (own copy of ``repro.runtime``): task states, the executor
(real threads and the discrete-event ``sim`` mode), faults, the journal and
the adaptive resize strategy."""
