"""lqr_iters.host_paced: lqr_iters' reading, in the cells whose host path
paces the rate; there it moves ``examples_per_s.host_paced``."""

from benchmark import spec

read = spec.metric_reader("lqr_iters").read
