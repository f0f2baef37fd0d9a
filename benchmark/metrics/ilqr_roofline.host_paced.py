"""ilqr_roofline.host_paced: ilqr_roofline's reading, in the cells whose
host path paces the rate; there it moves ``examples_per_s.host_paced``."""

from benchmark import spec

read = spec.metric_reader("ilqr_roofline").read
