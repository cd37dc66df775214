"""Drivers that run the port end to end: `convergence`, the coord net trained from
scratch through the unchanged bash harness."""
