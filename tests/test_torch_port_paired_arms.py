"""scripts/paired_arms.py: the rule it applies to the arms' epochs, and
the trained parameters it exports for the side-by-side run on the CPU."""

import numpy as np
import pytest
import torch

from count_pipnet_tpu_torch.scripts import paired_arms


def _results(tanh):
    """Arm results as the workers write them: ``tanh[arm][seed]`` lists
    one raw tanh loss a main epoch 2-6."""
    return {arm: {seed: {"epochs": [{"epoch": e, "tanh": t}
                                    for e, t in enumerate(values, 2)]}
                  for seed, values in seeds.items()}
            for arm, seeds in tanh.items()}


@pytest.mark.parametrize("shift,moves", [(0.5, False), (2.5, True),
                                         (-2.5, True)])
def test_decide_applies_twice_the_control_spread(shift, moves):
    control = {1: [15.0] * 5, 2: [16.0] * 5, 3: [17.0] * 5}  # spread 1.0
    tanh = {arm: control for arm in paired_arms.ARMS}
    tanh["gumbel"] = {s: [v + shift for v in vals]
                      for s, vals in control.items()}
    table = paired_arms.decide(_results(tanh))
    assert table["control"]["mean"] == pytest.approx(16.0)
    assert table["control"]["spread"] == pytest.approx(1.0)
    assert table["gumbel"]["diff"] == pytest.approx(shift)
    assert table["gumbel"]["moves"] is moves
    assert not any(table[a]["moves"] for a in paired_arms.ARMS
                   if a != "gumbel")


def test_export_keeps_the_trained_parameters_in_bf16(tmp_path):
    state = {"backbone.features.5.0.weight": torch.ones(2),
             "backbone.features.6.1.weight": torch.full((2,), 1.5),
             "backbone.features.7.0.layer_scale": torch.full((3,), 0.25),
             "add_on.conv1x1.weight": torch.ones(4),
             "classification.normalization_multiplier": torch.ones(1)}
    ckpt = tmp_path / "run" / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save({"model": state}, ckpt / "net_trained_last")
    out = tmp_path / "trained.pt"
    n = paired_arms.export_trained(str(tmp_path / "run"), str(out))
    got = torch.load(out, weights_only=True)
    assert set(got) == set(state) - {"backbone.features.5.0.weight"}
    assert n == 10
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), state[k].numpy())


def test_loglog_gumbel_is_gumbel():
    g = paired_arms.loglog_gumbel((200_000,),
                                  torch.Generator().manual_seed(5), "cpu")
    assert torch.isfinite(g).all()
    assert abs(g.double().mean().item() - 0.5772156649) < 5 * 1.2825 / 447
    assert abs(g.double().var().item() - np.pi ** 2 / 6) < 0.04
