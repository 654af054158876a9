"""Forward + objective over the whole search: the model FLOPs of the
proposals scored in the window (one forward of the calibration batch
each, ``_yardstick.forward_flops``), over the window's time, against the
card's peak in the configuration's compute type (fp32 67 TFLOP/s, bf16
989), in %. The profiled job and its time are left out."""
from perfbench.metrics._window import unprofiled_s
from perfbench.window import spans_inside


def read(rec):
    if rec.kind != "search" or rec.step_spans is None:
        return None
    steps = spans_inside(rec.step_spans, *rec.window, exclude=rec.stretch)
    flops = len(steps) * rec.population * rec.flops_per_proposal
    return flops / unprofiled_s(rec) / rec.peak_ops * 100
