"""The port's invariant tooling.

  * static half — ``python -m repro_torch.analysis --check``: the
    port of the reference's greenlint (``engine``, ``rules``, ``drift``)
    over ``src/repro_torch``, with line-scoped ``# greenlint: <marker>``
    suppressions and a committed (empty) baseline;
  * dynamic half — ``runtime``: lock-held, owner-thread and
    monotonic-clock assertions the port's modules arm on request;
  * ``digest``: stable structural hashing for same-seed bit-identity.
"""
