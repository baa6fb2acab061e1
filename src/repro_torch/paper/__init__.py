"""The paper's evaluation harness on the port: Table I, Table II, Figs. 1
and 5-9, the pipeline-overlap check and the roofline report
(``python -m repro_torch.paper.run``), and the scenario, cluster and
policy sweeps (``python -m repro_torch.paper.{scenario_sweep,
cluster_sweep,policy_gauntlet}``), one module per file of the
reference's ``benchmarks/``."""
