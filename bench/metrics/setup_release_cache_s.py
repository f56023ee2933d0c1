"""setup_release_cache_s: host seconds the set-up spends in the allocator's
cache releases before and after the eager first run: the first call of
the train step's program, summed by the program (`bench.phases`,
`graph.setup_seconds`)."""
from bench import phases

LAYER = "first call of a captured program (graph.Program of dist.step: eager run, cache releases, capture)"
MOVES = "setup_s"


def read(trace):
    return phases.setup_s("release_cache")
