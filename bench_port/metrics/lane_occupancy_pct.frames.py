"""Share of the lane slots the bounce blocks ran over that held an
unfinished lane in a preview-frame cell: 100 × ``lanes.live`` /
``lanes.slots`` (``lane_occupancy_pct.final``'s reader), over the whole
run."""
from bench_port import spec

read = spec.reader("lane_occupancy_pct.final")
