"""The train step in the hybrid config's (Zamba2-7B: Mamba blocks with a
shared attention + FFN block) own bf16: one step's loss and every gradient
leaf, the shared block's included, against the reference's jitted
``value_and_grad`` at the bars of ``tests/helpers/bf16_train.py`` (the
reduced config in bf16 with ``test_torch_bf16.py::_pair``'s weights, 2 x
32 calibration tokens). Measured: the loss 3.0e-5 relative off, the worst
leaf at 0.60 of its bar (``shared/ln1/w``), the largest RMS ratio 1.08
(``ssm/A_log``); the reference's own spreads 1.5-9.7 ulps of a bf16
leaf's scale. The Mamba block's rounding fault and the rest of the
step's checks are in ``test_torch_bf16_train_ssm.py``.
"""
import pytest

from helpers import bf16_train as H
from helpers.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_grads_within_the_reference_spread():
    fam = H.family("zamba2-7b")
    print(H.summary(H.grad_report(*fam.port_grads(fam.tp),
                                  fam.reference_grads(fam.jp))))
