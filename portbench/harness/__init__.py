"""The benchmark's own yardstick: data and traffic generation, the record of
a run, the profiler's reading, the peaks and byte counts, the comparison."""
