"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the model configuration as it is run (its
  published keys, what was cut under ``reduced``, sizes set under
  ``assumed``, the ``repro_torch`` arch, the ``ModelConfig`` overrides
  and, for an architecture of its own, its ``reference`` module);
* ``workloads/<cell>.json``: the configuration, the driver, the traffic's
  parameters, the limits of the correctness check and why the cell exists;
* ``drivers/<driver>.py``: one way of driving the program (set-up, the
  timed window, the check against the plain reference);
* ``metrics/<metric>.py``: one reader a per-layer metric;
* ``reference/<stem>.py``: the plain float32 PyTorch reference of one
  architecture, named by the configuration's ``reference`` key (default
  ``model``), with its layer check and its FLOP count; it imports nothing
  of the program (the contract is in ``reference/__init__.py``);
* ``flops.py`` and ``kinds.py``: the chip's peaks and the FLOP counts the
  metrics divide by, and the kernel-kind classifier they sort with.

Nothing here imports JAX or the JAX package ``repro``.
"""
