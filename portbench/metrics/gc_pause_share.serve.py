"""gc_pause_share.serve: the share of time the interpreter's garbage
collections held the serving process.

The collections' own durations (``gc.callbacks``, every generation) that
start in the traced run's quiet part (from a second after collecting the
profiler's trace let the process go, to the window's end), over its length.
While one runs, no thread of the process (the client, the batcher) runs
Python.
"""

LAYER = "the serving process's Python runtime (garbage collection)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    if trace.kind != KIND or "quiet_gc_share" not in trace.data:
        return None
    return 100.0 * trace.data["quiet_gc_share"]
