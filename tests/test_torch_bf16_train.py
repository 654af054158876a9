"""The train step in the zoo configs' own bf16, dense (Qwen3-4B) and MoE
(Phi-3.5-MoE) families, against the reference's jitted step; and
``train()`` in bf16 through a checkpoint. The reduced configs in bf16 with
``test_torch_bf16.py::_pair``'s weights on both sides, 2 x 32 calibration
tokens; the bars and the reference's spread are defined in
``tests/helpers/bf16_train.py``.

- One step's loss and gradients against the reference's jitted
  ``value_and_grad``: the loss within 1e-4 relative, each leaf
  elementwise within 2 x the reference's own spread (floor one ulp of the
  leaf's scale), and no farther from the fp32 model's gradients than
  1.25 x the reference's by RMS. Measured on this data: the loss 1.7e-5
  (Qwen3-4B) and 2.6e-5 (Phi-3.5-MoE) relative off; the worst leaf at
  0.55 of its bar (Qwen3-4B ``attn/wk``) and 0.50 (Phi ``final_norm/w``),
  the largest RMS ratio 1.10 (``attn/k_norm``) and 1.08 (``moe/up``). The
  reference's own spreads run 1.0-12.0 ulps of a bf16 leaf's scale on
  Qwen3-4B (``attn/q_norm`` 12 under reversed rows, 5 under one-ulp
  embedding moves) and 1.2-5.0 on Phi-3.5-MoE.
- AdamW on bf16 leaves, teacher-forced (the reference's state after one
  step and its gradients there, fed to both updates): m and v at rtol
  1e-6, the bf16 leaves equal except one ulp on fewer than 0.1 % of their
  elements.
- Three steps of ``make_train_step``, teacher-forced (each from the
  reference's params and state after the step before, lr 1e-3, one
  warm-up step): each step's gradients at the grad bars (worst shares of
  the bar 0.55 / 0.50 / 0.54 on Qwen3-4B, RMS ratios up to 1.10), its
  update at the AdamW bars against the reference's update fed the port's
  gradients, and at least 10 % of every bf16 weight matrix moved.
- ``accum_steps=2``: the microbatch gradients summed into f32 zeros (the
  reference's scan promotes so, and the clip and update then see f32
  gradients), the accumulated gradients at the grad bars against the
  reference's accumulating step (worst share 0.74, RMS ratio 1.04), the
  update at the AdamW bars.
- ``train()`` in bf16 for 6 steps, saving every 3: a run restored from
  its step-3 checkpoint (as saved, format 1, or re-saved as format 2)
  ends bit for bit where the uninterrupted run ends, with the same
  losses, bf16 params and f32 m / v.
"""
import json
import shutil

import pytest
import torch

from helpers import bf16_train as H
from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.optim import adamw as ja
from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                        save_sharded_checkpoint)
from repro_torch.launch.train import train as ttrain

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QWEN, MOE = "qwen3-4b", "phi3.5-moe-42b-a6.6b"


@pytest.mark.parametrize("arch", [QWEN, MOE], ids=["qwen3", "phi3.5-moe"])
def test_grads_within_the_reference_spread(arch):
    fam = H.family(arch)
    print(H.summary(H.grad_report(*fam.port_grads(fam.tp),
                                  fam.reference_grads(fam.jp))))


def test_adamw_on_bf16_leaves_teacher_forced():
    fam = H.family(QWEN)
    jp, js, _ = fam.jstep(fam.jp, ja.adamw_init(fam.jp), fam.jb)
    _, jg = fam.vg(jp, fam.jb)
    tout = H.ta.adamw_update(H.to_torch(jp), H.to_torch(jg),
                             H.state_to_torch(js), H.ta.AdamWConfig(**H.OPT))
    H.assert_adamw_like(tout, jp, jg, js)
    assert min(H.moved_share(tout[0], H.to_torch(jp)).values()) >= 0.1


def test_three_steps_teacher_forced():
    for report in H.assert_three_steps_teacher_forced(H.family(QWEN)):
        print(H.summary(report))


def test_accum_steps_2_within_the_bars():
    print(H.summary(H.assert_accum_within_bars(H.family(QWEN))))


@pytest.mark.parametrize("fmt", [1, 2], ids=["format1", "format2"])
def test_train_bf16_resumes_bit_for_bit(tmp_path, fmt, capsys):
    fam = H.family(QWEN)
    run = dict(cfg=fam.tcfg, params=fam.tp, steps=6, batch=2, seq=32,
               lr=1e-3, save_every=3, log_every=100, device="cpu")
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    p_whole, l_whole, _ = ttrain(ckpt_dir=str(whole), **run)
    # the run as it stood after step 3: its step-3 checkpoint only, as
    # saved (format 1) or re-saved as addressable shards (format 2)
    if fmt == 1:
        shutil.copytree(whole / "step_00000003", cut / "step_00000003")
    else:
        state, _ = restore_checkpoint(whole, 3, device="cpu")
        save_sharded_checkpoint(cut, 3, state)
    assert json.loads((cut / "step_00000003" / "manifest.json").read_text()
                      ).get("format", 1) == fmt
    p_cut, l_cut, _ = ttrain(ckpt_dir=str(cut), **run)
    assert "resumed from step 3" in capsys.readouterr().out
    assert l_cut == l_whole[3:]
    moved = H.moved_share(p_whole, fam.tp)
    assert min(moved.values()) > 0, moved
    for (k, a), (_, b) in zip(H.leaves(p_cut), H.leaves(p_whole)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    (_, sw), mw = restore_checkpoint(whole, device="cpu")
    (pc, sc), mc = restore_checkpoint(cut, device="cpu")
    assert mw["step"] == mc["step"] == 6
    for name in ("m", "v"):
        for (k, a), (_, b) in zip(H.leaves(sc[name]), H.leaves(sw[name])):
            assert a.dtype == torch.float32 and torch.equal(a, b), (name, k)
    for (k, a), (_, b) in zip(H.leaves(pc), H.leaves(p_whole)):
        assert torch.equal(a, b), k
