"""Throughput of the window: W·H·samples·depth over every request that
returned, divided by the wall time from the window's start to the last
answer (the reference's ray-counting formula)."""


def read(run):
    done = [r for r in run.requests if r.ok]
    if not done or run.shape.entry != "render_sums":
        return None
    end = max(r.t1 for r in run.requests)
    return sum(r.rays for r in done) / (end - run.window_start) / 1e6
