"""The train step in the encoder-decoder (SeamlessM4T-medium, 16 bf16 stub
frames in the batch) and vision (InternVL2-1B, 8 bf16 stub patches, whose
logits the loss drops) configs' own bf16 against the reference's jitted
step, at the bars of ``tests/helpers/bf16_train.py`` (the reduced configs
in bf16 with ``test_torch_bf16.py::_pair``'s weights, 2 x 32 calibration
tokens).

- One step's loss and every gradient leaf (the encoder's, the
  cross-attention's and the frontend-fed blocks') at the grad bars. The
  loss 7e-7 (SeamlessM4T) and 0 (InternVL2) relative off; the worst leaf
  as a share of its bar, then the largest RMS ratio: SeamlessM4T 0.62
  (``ln1/w``) / 1.08, InternVL2 0.58 / 1.02. The reference's own spreads
  run 0.5-10.9 (SeamlessM4T) and 1.25-5.0 (InternVL2) ulps of a bf16
  leaf's scale, except the key biases (exact
  gradient 0, held elementwise only: up to 192.5 ulps of their noise's
  scale; the port read 0.41-0.57 x the reference's RMS there).
- Three teacher-forced steps of ``make_train_step`` on InternVL2 (worst
  shares 0.58 / 0.70 / 0.55, RMS ratios up to 1.19; ``attn/bk`` read
  0.57 / 1.46 / 1.01 x, where the reference's own embedding draws read
  1.38-1.61 x its unmoved run at the second step).
"""
import pytest

from helpers import bf16_train as H
from helpers.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-1b"


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL],
                         ids=["seamless", "internvl2"])
def test_grads_within_the_reference_spread(arch):
    fam = H.family(arch)
    print(H.summary(H.grad_report(*fam.port_grads(fam.tp),
                                  fam.reference_grads(fam.jp))))


def test_three_steps_teacher_forced():
    for report in H.assert_three_steps_teacher_forced(H.family(INTERNVL)):
        print(H.summary(report))
