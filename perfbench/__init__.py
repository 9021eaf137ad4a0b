"""The benchmark of the PyTorch and CUDA port (``amq_tpu_torch``).

One command runs one cell once::

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell, metric
or kernel group is a file of its own, found by name:

* ``configs/<config>.json``    model shape, source, quantization, cuts
* ``traffic/<traffic>.json``   a traffic mix: its ``kind`` and parameters
* ``workloads/<cell>.json``    a cell: config, traffic, chips, why, metrics
* ``loops/<kind>.py``          the general generator and loop of a traffic kind
* ``metrics/<metric>.py``      one metric: unit, layer, what it moves, its reader
* ``kernels/<group>.json``     profiler kernel-name patterns of one kernel group
* ``work/``                    FLOPs and bytes reckoned from shapes
* ``reference/``               the plain PyTorch reference that decides ``correct``

Nothing here imports ``jax``, ``amq_tpu`` or anything of the repository
outside this folder but the port, and ``reference/`` imports nothing of
the port.
"""
