"""Candidate build: ``transform_quant``'s device time per proposal in the
profiled job against its bytes bound (``_yardstick.tq_bytes`` of each
launch a fused build makes: up, the gate where the FFN is gated, down),
in %."""
from perfbench.metrics._devtime import trace_ms
from perfbench.metrics._yardstick import bound_ms


def read(rec):
    if rec.kind != "search" or rec.trace is None \
            or not rec.proposals_in_stretch:
        return None
    ms, _, _ = trace_ms(rec.trace.kernels, ("transform_quant",),
                        int(rec.proposals_in_stretch))
    if not ms:
        return None
    return bound_ms(rec.tq_bytes_per_proposal, 0)[0] / ms * 100
