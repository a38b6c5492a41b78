"""Host ms to enqueue one microbatch (the batch layer's `dispatch` and
`results` and the copy of the results to the host, no wait): the window's
enqueue time over its microbatches, on the loop's host clock."""


def read(run):
    if not run.window.handles:
        return None
    return run.window.enqueue_s * 1e3 / len(run.window.handles)
