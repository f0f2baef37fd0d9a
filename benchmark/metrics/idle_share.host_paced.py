"""idle_share.host_paced: idle_share.serve's reading, in the cells whose
host path paces the rate; there it moves ``examples_per_s.host_paced``."""

from benchmark import spec

read = spec.metric_reader("idle_share.serve").read
