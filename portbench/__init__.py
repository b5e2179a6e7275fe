"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` serves one cell of `BENCHMARK.json` on one card and prints
one JSON line. Everything that belongs to one configuration, traffic mix
or metric lives in a file of its own that the harness finds by name:

* `configs/<config>.json`   the configuration as it is run (sizes,
                            serving options, its plain reference);
* `traffic/<mix>.json`      a mix's parameters, read by `traffic.py`;
* `metrics/<metric>.py`     one metric's reader (`read(run)`);
* `reference/<name>.py`     a configuration's plain reference.

The yardstick (traffic generation, FLOP and byte counts, the table of
peaks, the plain reference and the comparison that decides `correct`)
lives here; from the port the benchmark takes only the system under test
and its counters and kernel names.
"""
