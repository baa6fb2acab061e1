"""Host-side distributed substrate: the ring collective's cost
(``collectives``) and fault tolerance (``fault_tolerance``)."""
