"""The benchmark of the PyTorch/CUDA port (``trackdlo_tpu_torch``) on one card.

One command runs one cell once (``python -m portbench.run --help``). Every
cell, configuration, traffic mix, step entry and per-layer metric is a file
of its own that the harness finds by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment's tracker and camera settings;
- ``traffic/<traffic>.json``: the parameters of the one traffic generator
  (:mod:`portbench.traffic`);
- ``workloads/<cell>.json``: the step entry, its options, the sample the
  correctness check draws and the limits of each number it compares;
- ``entries/<entry>.py``: how a cell calls the program;
- ``metrics/<metric>.py``: one per-layer metric, read from the trace, the
  launch counters or the step's outputs (:mod:`portbench.layers`).

The yardstick lives here too: the renderer (:mod:`portbench.render`), the
peaks and the kernels' operation and byte counts (:mod:`portbench.roofline`),
the trace reduction (:mod:`portbench.trace`), the float64 reference
(:mod:`portbench.reference`) and the comparison that decides ``correct``
(:mod:`portbench.check`). Nothing here imports JAX or the JAX package.
"""
