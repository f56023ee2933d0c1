"""setup_first_run_s: host seconds the set-up spends in the eager first run
of the captured step, up to the end of its device work: the first call
of the train step's program, summed by the program (`bench.phases`,
`graph.setup_seconds`)."""
from bench import phases

LAYER = "first call of a captured program (graph.Program of dist.step: eager run, cache releases, capture)"
MOVES = "setup_s"


def read(trace):
    return phases.setup_s("first_run")
