"""Share of the lane slots the bounce blocks ran over that held an
unfinished lane in a final-frame cell: 100 × ``lanes.live`` /
``lanes.slots``, the program's counters (each bounce of each block: the
unfinished lanes before it / the bucket's lanes), over the whole run
(``bench_port/record.py``)."""
from bench_port import record


def read(run):
    rec = record.of(run)
    slots = rec.get("lanes.slots", (0, 0))[0]
    return 100.0 * rec.get("lanes.live", (0, 0))[0] / slots if slots else None
