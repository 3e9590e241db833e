"""Serving as an ensemble workload: only the SLA classes so far
(``serving.sla``, own copy of ``repro.serving.sla``), which the PST layer
reads; the traffic model and the serving pipelines wait for ROADMAP A3."""
