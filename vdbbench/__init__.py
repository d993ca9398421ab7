"""The benchmark of ``vectordb_tpu_torch`` on one NVIDIA card.

``python3 -m vdbbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by its name:

  configs/<config>.json     the deployment: rows, width, metric, data, store
  traffic/<traffic>.json    the mix: driver, queries a call, k, pool, warm-up
  cells/<workload>.json     the limits that decide ``correct``, and the
                            readings they were set from
  data/<generator>.py       makes rows and queries on the card from a seed
  stores/<kind>.py          builds and loads the store under test
  drivers/<driver>.py       drives the measured window
  references/<name>.py      the plain reference of the store's semantics
  metrics/<metric>.py       reads one metric from the run

Nothing here imports ``jax`` or ``vectordb_tpu``; only ``stores/``
imports ``vectordb_tpu_torch``.
"""
