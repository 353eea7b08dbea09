"""`solves_per_s` again, in the cells at K=4096, where the card sets the
pace and runs spread less: a name of its own, so that it holds a tighter
bound than `solves_per_s`, which the host-paced cells at K=256 set."""

from harness import manifest

read = manifest.reader("solves_per_s")
