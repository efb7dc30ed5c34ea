"""The benchmark harness's own tests, run on the CPU (see port_bench/README.md)."""
