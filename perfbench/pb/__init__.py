"""The benchmark's own code: the general traffic generator, the frozen
yardstick (costs, peaks, Poisson arithmetic), weights made from the
seed, the measured window, the trace reduction and the check that
decides ``correct``.  Nothing here imports JAX or the JAX package."""
