"""Plain references of the port's results, each a file that imports
``torch`` alone: no module of the port, no JAX.  Tests and the benchmark
hold the port's fast paths against them."""
