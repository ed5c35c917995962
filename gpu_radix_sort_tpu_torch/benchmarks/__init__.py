"""Runners of the port (port of the JAX package's ``benchmarks/`` folder):
``run_out_of_core``, the storage-plane sort at scales beyond device memory."""
