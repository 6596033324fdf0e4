"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the model configuration as it is run (its
  published keys, what was cut under ``reduced``, sizes set under
  ``assumed``, the ``repro_torch`` arch and the ``ModelConfig`` overrides);
* ``workloads/<cell>.json``: the configuration, the driver, the traffic's
  parameters, the limits of the correctness check and why the cell exists;
* ``drivers/<driver>.py``: one way of driving the program (set-up, the
  timed window, the check against the plain reference);
* ``metrics/<metric>.py``: one reader a per-layer metric;
* ``reference/``: the plain float32 PyTorch reference, which imports
  nothing of the program;
* ``flops.py`` and ``kinds.py``: the FLOP arithmetic and the kernel-kind
  classifier the metrics divide by and sort with.

Nothing here imports JAX or the JAX package ``repro``.
"""
