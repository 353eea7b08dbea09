"""`solve_ms_p95` again, in the cells at K=4096, where the card sets the
pace and runs spread less: a name of its own, so that it holds a tighter
bound than `solve_ms_p95`, which the host-paced cells at K=256 set."""

from harness import manifest

read = manifest.reader("solve_ms_p95")
