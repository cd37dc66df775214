"""Drivers and measurements of the port: `convergence`, the coord net trained
from scratch through the unchanged bash harness; `parallel_check`, the
2-rank checks; `bench`, image -> pose throughput; `loader_bench`, the host
data path."""
