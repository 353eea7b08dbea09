"""K2's share of its roofline, in %: the least time the card could take
for the algorithm's work in one solve (harness/work.py, frozen: operations
over the FP32 peak, or the controls read and the totals written over HBM
bandwidth, whichever is larger; one K2 launch a solve iteration) over K2's
device time per solve."""

import sys

from harness import manifest, work


def read(run):
    device_ms = manifest.reader("k2.device_ms")(run)
    if device_ms is None:
        return None
    c = run.cfg
    flops, nbytes = work.rollout_pick_work(run.robot, c.n_samples, c.horizon, c.n_substeps,
                                           c.contact)
    flops, nbytes = flops * c.n_iters, nbytes * c.n_iters
    share, bound = work.roofline_share(flops, nbytes, device_ms * 1e-3)
    print(f"K2 work per solve: {flops} operations, {nbytes} bytes; bound by {bound}; "
          f"card: {run.power}", file=sys.stderr)
    return share
