"""The plain reference of an InvarExplore job's scores.

A job quantises the model with RTN (group fake-quant of every projection),
then hill-climbs per-FFN transforms (π, s, φ); every candidate is the
transformed FFN fake-quantised again, scored by one calibration forward
with the objective CE + α · MSE over the first ``n_match`` block outputs
against the full-precision model's, α = CE_0 / (ce_weight · MSE_0) fixed by
the untransformed model. Here the reference works all of that out again
from the original weights: the fake-quant of every weight, the transformed
FFNs (from the transforms the job accepted: its decisions are its own, and
the reference follows them), the forwards and the objective.

The fake-quant follows the quantiser's stated types: a weight left as it
was takes its group range in the model's type, a transformed FFN weight in
float32, as the transform itself is computed.
"""
from __future__ import annotations

from perfbench.reference import model as M
from perfbench.reference import quant as Q
from perfbench.weights import layer as layer_of

ATTN = ("wq", "wk", "wv", "wo")


def _layer_fn(params, arch, bits, group, transforms=None):
    """layer(i) -> float32 leaves of layer i, every projection fake-quantised;
    FFN i transformed first where ``transforms`` moves it."""
    rdt = params["blocks"]["attn"]["wq"].dtype

    def layer(i):
        lp = layer_of(params, i)
        out = {"ln1": {k: v.float() for k, v in lp["ln1"].items()},
               "ln2": {k: v.float() for k, v in lp["ln2"].items()}}
        out["attn"] = {k: (Q.fake_quant(v, bits, group, rdt) if k in ATTN
                           else v.float()) for k, v in lp["attn"].items()}
        m = lp["mlp"]
        t = None
        if transforms is not None:
            t = tuple(x[i] for x in transforms)
            if Q.is_identity(*t):
                t = None
        if t is None:
            mlp = {k: (Q.fake_quant(v, bits, group, rdt) if v.ndim == 2
                       else v.float()) for k, v in m.items()}
        else:
            pi, s, phi = t
            mlp = {"up": Q.fake_quant(Q.transform_up(m["up"], pi, s, phi),
                                      bits, group),
                   "down": Q.fake_quant(Q.transform_down(m["down"], pi, s,
                                                         phi), bits, group)}
            if "gate" in m:
                mlp["gate"] = Q.fake_quant(m["gate"].float()[:, pi], bits,
                                           group)
            if "b_up" in m:
                mlp["b_up"] = Q.transform_bias(m["b_up"], pi, s, phi)
            if "b_gate" in m:
                mlp["b_gate"] = m["b_gate"].float()[pi]
            if "b_down" in m:
                mlp["b_down"] = m["b_down"].float()
        out["mlp"] = mlp
        return out

    return layer


def _fp_layer_fn(params):
    def layer(i):
        lp = layer_of(params, i)
        return {k: {n: t.float() for n, t in v.items()} for k, v in lp.items()}
    return layer


class SearchReference:
    """Scores of quantised states of one model on one calibration batch."""

    def __init__(self, params, arch, calib, *, bits, group, n_match,
                 ce_weight, precision="float32"):
        self.params, self.arch, self.calib = params, arch, calib
        self.bits, self.group = bits, group
        self.n_match = min(n_match, arch.n_layers)
        self.ce_weight, self.precision = ce_weight, precision
        _, self.taps_fp = M.forward(params, arch, _fp_layer_fn(params), calib,
                                    n_taps=self.n_match, precision=precision)
        ce0, self.mse0 = self._terms(None)
        self.alpha = ce0 / (ce_weight * self.mse0) if self.mse0 > 0 else 0.0
        self.loss0 = ce0 + self.alpha * self.mse0

    def _terms(self, transforms):
        logits, taps = M.forward(
            self.params, self.arch,
            _layer_fn(self.params, self.arch, self.bits, self.group,
                      transforms),
            self.calib, n_taps=self.n_match, precision=self.precision)
        ce = float(M.lm_ce(logits, self.calib))
        del logits
        mse = float(((taps - self.taps_fp) ** 2).mean()) if self.n_match \
            else 0.0
        return ce, mse

    def score(self, transforms):
        """(loss, activation MSE) of the model the transforms give."""
        ce, mse = self._terms(transforms)
        return ce + self.alpha * mse, mse


def search_numbers(ref: SearchReference, initial, jobs):
    """The numbers a search run is judged by. ``initial``: every job's
    (loss, activation MSE) of the untransformed model; ``jobs``: (loss,
    activation MSE, transforms) of the best state of each job sampled, as
    the program reported them.

    - ``loss0_rel`` / ``mse0_rel``: the untransformed model's score and its
      activation MSE, the program's against the reference's, relative; the
      largest over the jobs;
    - ``lossf_rel`` / ``msef_rel``: each sampled job's best score and its
      MSE against the reference's of the transforms it returned, relative
      to the reference's untransformed ones; the largest over the jobs.

    The score is a mean over every calibration token and averages rounding
    away; the MSE of the block outputs against the full-precision model's
    adds the rounding of both, and so tells a lower precision apart."""
    out = {"loss0_rel": max(abs(x - ref.loss0) for x, _ in initial)
           / abs(ref.loss0),
           "mse0_rel": max(abs(a - ref.mse0) for _, a in initial)
           / abs(ref.mse0)}
    lossf = msef = gain = mgain = 0.0
    loss0 = sum(x for x, _ in initial) / len(initial)
    mse0 = sum(a for _, a in initial) / len(initial)
    for loss, mse, transforms in jobs:
        r_loss, r_mse = ref.score(transforms)
        lossf = max(lossf, abs(loss - r_loss) / abs(ref.loss0))
        msef = max(msef, abs(mse - r_mse) / abs(ref.mse0))
        gain = max(gain, abs((loss0 - loss) - (ref.loss0 - r_loss))
                   / abs(ref.loss0))
        mgain = max(mgain, abs((mse0 - mse) - (ref.mse0 - r_mse))
                    / abs(ref.mse0))
    out.update(lossf_rel=lossf, msef_rel=msef, gain_rel=gain,
               mgain_rel=mgain)
    return out
