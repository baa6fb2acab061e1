"""The paper's evaluation harness on the port: Table I, Table II, Figs. 1
and 5-9 and the pipeline-overlap check, one module per file of the
reference's ``benchmarks/`` (``python -m repro_torch.paper.run``)."""
