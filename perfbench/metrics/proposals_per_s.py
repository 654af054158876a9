"""Candidate transforms scored per second: the program's
``search_proposals_total`` counter, read at the window's two edges, over
the window's seconds (host clock)."""


def read(rec):
    if rec.kind != "search":
        return None
    return rec.proposals / rec.window_s
