"""The benchmark's shared parts: the spec loader, seeded weights and
inputs, the measured window, the profiler reading, the operation and byte
counters, the comparison with the plain reference and the result line."""
