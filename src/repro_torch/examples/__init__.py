"""The JAX package's examples that call JAX (``examples/
replica_exchange_pbt.py``, ``serve_batched.py``, ``train_100m.py``) on
the port: each runs as ``python -m repro_torch.examples.<name>`` with the
reference's options, defaults and printed lines, plus ``--device``
(``cuda`` unless ``cpu`` is asked for).  The examples that use only the
runtime run on the port as they are (their ``from repro.`` imports read
``from repro_torch.``)."""
