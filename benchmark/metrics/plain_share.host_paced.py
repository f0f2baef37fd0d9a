"""plain_share.host_paced: plain_share's reading, in the cells whose host
path paces the rate; there it moves ``examples_per_s.host_paced``."""

from benchmark import spec

read = spec.metric_reader("plain_share").read
