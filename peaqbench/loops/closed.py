"""The closed loop: one client keeps the card fed.  It dispatches while
fewer than the traffic's `in_flight` units are outstanding, else waits for
the oldest.  At the close, the units whose answers are on the host count
for the window; the rest are then waited for (late, not lost).

The host's time in `submit` is the window's enqueue time; what the host is
doing sits in `record_function` ranges named `peaqbench.*`, so that a trace
can name the idle gaps by it.
"""

from __future__ import annotations

import collections
import time

from torch.profiler import record_function

from peaqbench.client import Window


def run(submit, seconds: float, traffic: dict) -> Window:
    in_flight = traffic["in_flight"]
    pending = collections.deque()
    handles, done = [], []
    enqueue = 0.0
    start = time.perf_counter()
    end = start + seconds
    m = 0
    while True:
        if len(pending) >= in_flight:
            with record_function("peaqbench.wait"):
                h = pending.popleft()
                h.wait()
            h.finish(time.perf_counter())
            done.append(h)
        now = time.perf_counter()
        if now >= end:
            break
        t = time.perf_counter()
        with record_function("peaqbench.submit"):
            h = submit(m)
        enqueue += time.perf_counter() - t
        pending.append(h)
        handles.append(h)
        m += 1
    close = now
    while pending and pending[0].ready():
        h = pending.popleft()
        h.finish(close)
        done.append(h)
    in_window = list(done)
    with record_function("peaqbench.drain"):
        for h in pending:
            h.wait()
            h.finish(time.perf_counter())
    return Window(start, close, handles, in_window, enqueue)
