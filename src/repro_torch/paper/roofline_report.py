"""Roofline table aggregation: the dry-run's records as
``name,value,derived`` rows.

Port of ``benchmarks/roofline_report.py``. It reads the records that
``python -m repro_torch.launch.dryrun`` writes,
``<records_dir>/<arch>__<shape>__<device>.json`` (default
``results/dryrun_torch/``): counts and roofline terms at the H100's
peaks, no time. A row a cell, ``roofline/<arch>/<shape>`` with its
compute share of the bound and its terms, then the cell counts and the
histogram of dominant terms.

Divergence from the reference: one card has no single-pod or multi-pod
mesh, so the reference's two record sets, ``*__single.json`` and
``*__multi.json`` (every cell compiled on 256 and on 512 devices), are
the port's ``*__meta.json`` (every cell counted on the ``meta`` device,
the 44 of them; the table's rows) and ``*__cuda.json`` (the cells the
card ran, ``--device cuda``). The count rows are ``roofline/cells_meta``
and ``roofline/cells_cuda`` accordingly.

    python -m repro_torch.paper.roofline_report [--records DIR]

Without records it prints the reference's error row and raises nothing.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN_DIR
from repro_torch.paper.common import fmt_row


def load_records(device: str = "meta",
                 records_dir: str | os.PathLike = DRYRUN_DIR) -> list[dict]:
    """The records of ``device`` (``meta`` or ``cuda``) in
    ``records_dir``, in file-name order."""
    recs = []
    for path in sorted(glob.glob(os.path.join(str(records_dir),
                                              f"*__{device}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def main(sw=None, records_dir: str | os.PathLike = DRYRUN_DIR) -> list[str]:
    """The report's rows over ``records_dir``; ``sw`` (the harness's
    sweep, which ``run.py`` hands every module) is not read."""
    rows = []
    recs = load_records("meta", records_dir)
    if not recs:
        return [fmt_row("roofline/error", "no dry-run results",
                        "run python -m repro_torch.launch.dryrun --all "
                        "first")]
    for r in recs:
        t = r["roofline"]
        rows.append(fmt_row(
            f"roofline/{r['arch']}/{r['shape']}",
            f"{t['roofline_fraction']:.3f}",
            f"dom={t['dominant']};compute={t['compute_s']:.2e}s;"
            f"memory={t['memory_s']:.2e}s;collective={t['collective_s']:.2e}s;"
            f"peak={r['memory']['peak_estimate_gb']}GB",
        ))
    cuda = load_records("cuda", records_dir)
    rows.append(fmt_row("roofline/cells_meta", len(recs), "expect 44"))
    rows.append(fmt_row("roofline/cells_cuda", len(cuda),
                        "the cells the card ran"))
    doms = {}
    for r in recs:
        doms[r["roofline"]["dominant"]] = doms.get(
            r["roofline"]["dominant"], 0) + 1
    rows.append(fmt_row("roofline/dominant_histogram",
                        "|".join(f"{k}={v}" for k, v in sorted(doms.items()))))
    return rows


def cli(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", default=str(DRYRUN_DIR),
                    help="the dry-run's records (default: %(default)s)")
    args = ap.parse_args(argv)
    rows = main(records_dir=args.records)
    print("\n".join(rows))
    return rows


if __name__ == "__main__":
    cli()
