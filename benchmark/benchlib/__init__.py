"""The benchmark's harness: cells, traffic, drivers, tracing and the
result line. Nothing here imports JAX or the JAX package; the program
under test is imported by the drivers only."""
