"""The train step in the SSM config's (Mamba2-2.7B) own bf16 against the
reference's jitted step, with the bars, data and the
reference's spread of ``tests/helpers/bf16_train.py`` (the reduced configs
in bf16 with ``test_torch_bf16.py::_pair``'s weights, 2 x 32 calibration
tokens). A Mamba block's ``A_log``, ``D`` and ``dt_bias`` stay f32 in a
bf16 model, in both packages, and their gradients are f32.

The fault (ROADMAP Queue 3): the port's Mamba block rounded two
cotangents of its gated RMSNorm to bf16 that the reference's compiled VJP
keeps in f32 (XLA drops the bf16 convert pair): the SSD output's, after the
gate, and the normalised value's, after the norm weight. The SSD output's
cotangent then reached the D skip, the scan and ``dt_bias`` rounded. Read
from ``jax.jit(vjp).lower(...).compile().as_text()``: in the fusion that
feeds ``D``'s gradient the gate's cotangent times ``silu(z)`` enters the
product with the conv output unrounded. ``models/ssm.py::_gate_out`` now
rounds where that VJP does. Before the repair, one Mamba block's VJP on the
same bf16 input and cotangent gave ``A_log`` / ``D`` / ``dt_bias``
gradients 4e-4 to 7e-3 of their scale off the reference's, ``w_dt``'s
equal on 30-40 % of its elements, and ``D`` / ``dt_bias`` at 1.29 x /
1.23 x the reference's RMS distance from the fp32 block; after it, at most
2.3e-6 of their scale off, ``w_dt`` equal on every element, both at
1.00 x. The whole model on this data read ``D`` / ``dt_bias`` at 0.88 x /
1.10 x before and 0.74 x / 1.10 x after: its 2 x 32 tokens hide what one
block shows.

- The fault's pin: each Mamba2 block's VJP, ``A_log``, ``D`` and
  ``dt_bias`` gradients within 1e-5 of their scale of the reference's
  jitted VJP, ``w_dt``'s equal on at least 99 % of its elements.
- One step's loss (7e-8 relative off) and gradients at the grad bars: the
  worst leaf at 1.0 of its bar (``conv_C`` 6 ulps of its scale against a
  spread of 3, ``conv_b_B`` 4 against 2, ``w_C`` 2 against 1: the
  reference sums a conv weight's gradient over the batch and sequence in
  bf16), the largest RMS ratio 1.10 (``dt_bias``); the reference's own
  spreads 1.0-4.0 ulps of a bf16 leaf's scale. The hybrid family
  (Zamba2-7B) is in ``test_torch_bf16_train_hybrid.py``.
- AdamW teacher-forced on Mamba2 (bf16 leaves and the f32 ``A_log``,
  ``D``, ``dt_bias``), three teacher-forced steps of ``make_train_step``
  (worst shares 1.0 / 0.67 / 0.83, RMS ratios up to 1.10) and
  ``accum_steps=2`` (0.57, 1.01), at the bars of
  ``test_torch_bf16_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import bf16_train as H
from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.models import ssm as jssm
from repro.optim import adamw as ja
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAMBA = "mamba2-2.7b"


def test_mamba_block_vjp_rounds_where_the_reference_does():
    fam = H.family(MAMBA)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, fam.jcfg.d_model)).astype(jnp.bfloat16)
    ct = (0.1 * rng.standard_normal(x.shape)).astype(jnp.bfloat16)

    @jax.jit
    def jvjp(p, x, ct):
        return jax.vjp(lambda p, x: jssm.ssm_forward(p, fam.jcfg, x), p,
                       x)[1](ct)

    for u in range(fam.jcfg.n_layers):
        jg, _ = jvjp(jax.tree.map(lambda a: a[u], fam.jp["blocks"]["ssm"]),
                     jnp.asarray(x), jnp.asarray(ct))
        tb = {k: v[u].detach().clone().requires_grad_(True)
              for k, v in fam.tp["blocks"]["ssm"].items()}
        tssm.ssm_forward(tb, fam.tcfg, params_from_numpy(x, "cpu")).backward(
            params_from_numpy(ct, "cpu"))
        for k in ("A_log", "D", "dt_bias"):
            got, want = to_np(tb[k].grad), np.asarray(jg[k])
            assert got.dtype == want.dtype == np.float32
            off = np.abs(got - want).max() / np.abs(want).max()
            assert off <= 1e-5, (u, k, off)
        same = np.mean(to_np(tb["w_dt"].grad) == to_np(jg["w_dt"]))
        assert same >= 0.99, (u, same)


def test_grads_within_the_reference_spread():
    fam = H.family(MAMBA)
    print(H.summary(H.grad_report(*fam.port_grads(fam.tp),
                                  fam.reference_grads(fam.jp))))


def test_adamw_on_bf16_and_f32_leaves_teacher_forced():
    fam = H.family(MAMBA)
    jp, js, _ = fam.jstep(fam.jp, ja.adamw_init(fam.jp), fam.jb)
    _, jg = fam.vg(jp, fam.jb)
    assert jg["blocks"]["ssm"]["D"].dtype == jnp.float32
    tout = H.ta.adamw_update(H.to_torch(jp), H.to_torch(jg),
                             H.state_to_torch(js), H.ta.AdamWConfig(**H.OPT))
    H.assert_adamw_like(tout, jp, jg, js)
    assert min(H.moved_share(tout[0], H.to_torch(jp)).values()) >= 0.1


def test_three_steps_teacher_forced():
    for report in H.assert_three_steps_teacher_forced(H.family(MAMBA)):
        print(H.summary(report))


def test_accum_steps_2_within_the_bars():
    print(H.summary(H.assert_accum_within_bars(H.family(MAMBA))))
