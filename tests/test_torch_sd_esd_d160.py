"""The port's SD1/SD2 ESD step against the JAX package's on a tiny SD UNet
whose mid block has one head of 160 — the head dim of SD1.5's 1280-channel
level — so that the step's attention there takes the k-grid route: K4a
forward, K4b/K4c backward through the autograd Function (their plain
versions on the CPU). Two DDIM steps at ``train.cfg`` 1 and 2; loss, grad
norm and every factor within 2e-4, as tests/test_torch_sd_esd.py holds the
tiny UNet."""

import pytest

from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from test_torch_sd_esd import esd_steps_match_jax
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("train_cfg", [1.0, 2.0])
def test_sd_ddim_esd_steps_with_a_d160_mid_block_match_jax(monkeypatch, train_cfg):
    calls = []
    real = kg.kgrid_bwd_dkv_reference
    monkeypatch.setattr(kg, "kgrid_bwd_dkv_reference", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    esd_steps_match_jax("d160", "epsilon", train_cfg)
    # the student's mid-block self- and cross-attention backward, once per step
    assert calls and all(s[-1] == 192 for s in calls) and len(calls) == 2 * 2
