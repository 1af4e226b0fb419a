"""The benchmark of the PyTorch and CUDA port, ``mind_the_gaps_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line: ``python -m gpbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (or ``python3 gpbench/run.py ...``), from the root of a
checkout, on a machine with as many CUDA cards as the cell asks for.

The harness is driven by data.  A cell names a configuration
(``configs/<config>.json``: the deployment and its stated precisions) and
a traffic mix (``traffic/<traffic>.json``: the driver that issues the
calls and its parameters); its comparison limits are in
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``; each
covariance term of the plain reference by ``terms/<kind>.py``.  The
yardstick (data, reference, operation counts and peaks, the profiler
reading) lives here; from the port it takes only the calls under test,
their timings and counters, and kernel names.

A cell that the harness runs but ``BENCHMARK.json`` leaves out, because
its runs spread too widely for a bound, is kept in ``parked/<cell>.json``:
its entries, and the metrics whose cells it ``joins``.  Putting it back is
copying those entries; the tests drive it from a copy of the file that has
it back.
"""
