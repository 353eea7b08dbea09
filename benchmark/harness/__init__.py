"""The benchmark's harness: the cell's files, the traffic generator, the
timed loop, the profiler's reduction, the frozen work counts and peaks,
and the comparison that decides `correct`."""
