"""The port's chunked trainer (count_pipnet_tpu_torch/scripts/
train_chunked.py), the counterpart of test_chunked.py: a two-epoch run
with --chunk_epochs 1 takes two processes of the port's CLI on the CPU
(32x32, one stage), the first stopping with checkpoints/CHUNK_CONTINUE,
the second resuming; its log_epoch_overview.csv equals a one-process
run's within 1e-4 (the resumed process restores the model, the optimizer,
the temperature and the random streams); and the stall watchdog kills a
child whose output stops growing."""

import csv
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from count_pipnet_tpu_torch import main as cli
from count_pipnet_tpu_torch.data.generate_shapes import \
    GeometricShapesGenerator
from count_pipnet_tpu_torch.scripts import train_chunked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [
    "--dataset", "geometric_shapes", "--model", "count_pipnet",
    "--image_size", "32", "--net", "convnext_tiny_26", "--use_mid_layers",
    "--num_stages", "1", "--num_features", "4", "--max_count", "3",
    "--use_ste", "True", "--intermediate_layer", "onehot",
    "--batch_size", "4", "--batch_size_pretrain", "4", "--epochs", "2",
    "--epochs_pretrain", "1", "--epochs_finetune", "0",
    "--freeze_epochs", "0", "--lr", "0.01", "--lr_block", "0.001",
    "--lr_net", "0.001", "--num_workers", "0", "--seed", "1",
    "--dtype", "float32", "--tanh_loss_coeff", "0.1",
    "--disable_pretrained", "--disable_cuda",
    "--viz_prototype_maps", "False",
]


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunked_port")
    GeometricShapesGenerator({
        "output_dir": str(root / "data/geometric_shapes/dataset"),
        "img_size": 32, "train_samples_per_class": 4,
        "test_samples_per_class": 2, "seed": 0,
        "class_definitions": [("circle", 1), ("triangle", 2)],
        "size_mean": 6, "size_std": 1, "min_object_size": 4,
        "max_object_size": 8,
    }).generate_dataset()
    return root


def _rows(log_dir):
    with open(os.path.join(log_dir, "log_epoch_overview.csv")) as f:
        return list(csv.reader(f))


def test_two_chunks_equal_one_process(shapes_root, monkeypatch, capfd):
    chunked = str(shapes_root / "runs/chunked")
    monkeypatch.chdir(shapes_root)
    # the wrapper in this process; each chunk is a process of its own
    assert train_chunked.main(
        ["--chunk_epochs", "1", "--max_chunks", "4", "--chunk_cooldown",
         "0", "--", *ARGS, "--log_dir", chunked]) == 0
    out = capfd.readouterr().out
    assert "chunk 1:" in out and "--resume_training" in out
    assert "Chunk budget of 1 epochs reached at epoch 1/2" in out
    assert "chunk 2:" not in out and "run complete" in out
    assert not os.path.exists(
        os.path.join(chunked, "checkpoints", "CHUNK_CONTINUE"))
    assert any(d.startswith("visualised_prototypes_topk_best_model")
               for d in os.listdir(chunked))

    one = str(shapes_root / "runs/one")
    assert cli.main([*ARGS, "--log_dir", one]) == 0
    got, ref = _rows(chunked), _rows(one)
    assert got[0] == ref[0] and len(got) == len(ref) == 4  # pre, 1, 1, 2
    for g, r in zip(got[1:], ref[1:]):
        assert [a == "n.a." for a in g] == [b == "n.a." for b in r]
        g = np.array([float(a) for a in g if a != "n.a."])
        r = np.array([float(b) for b in r if b != "n.a."])
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


def test_log_dir_of_reads_flag_then_yaml(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("log_dir: ./runs/from_yaml\nepochs: 3\n")
    assert train_chunked.log_dir_of(["--config", str(cfg)]) == \
        "./runs/from_yaml"
    assert train_chunked.log_dir_of(
        ["--config", str(cfg), "--log_dir", "x/y"]) == "x/y"


def test_watchdog_kills_a_stalled_child(tmp_path):
    tee = tmp_path / "out.txt"
    tee.write_text("started\n")
    t0 = time.time()
    rc, stalled = train_chunked._run_watched(
        [sys.executable, "-c", "import time; time.sleep(60)"], str(tee),
        stall_timeout=0.5, poll_s=0.1)
    assert stalled and rc == -1
    assert time.time() - t0 < 30
    # a child that exits on its own is not touched
    rc, stalled = train_chunked._run_watched(
        [sys.executable, "-c", "raise SystemExit(3)"], str(tee),
        stall_timeout=5.0, poll_s=0.1)
    assert (rc, stalled) == (3, False)


def test_rng_state_from_another_device_type_is_left(capsys):
    """A stream saved by a generator of another device type (its state of
    another size: a CPU run resumed on the card) is not restored; the
    others are."""
    import torch
    from count_pipnet_tpu_torch.train.trainer import Trainer
    gens = SimpleNamespace(generator=torch.Generator().manual_seed(3),
                           aug_generator=torch.Generator().manual_seed(4))
    want = torch.Generator().manual_seed(5).get_state()
    Trainer.set_rng_state(gens, {
        "generator": want,
        "aug_generator": torch.zeros(16, dtype=torch.uint8)})
    assert torch.equal(gens.generator.get_state(), want)
    assert torch.equal(gens.aug_generator.get_state(),
                       torch.Generator().manual_seed(4).get_state())
    assert "aug_generator not restored" in capsys.readouterr().out
