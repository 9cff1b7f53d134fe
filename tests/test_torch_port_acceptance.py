"""The canonical experiment's runner (count_pipnet_tpu_torch/scripts/
acceptance_run.py) reads a run as it is written: the main phase's CSV
rows (pretraining's n.a. rows skipped), the epoch times of each phase
and the visualisations' wall times from out.txt, the steady state taken
after the frozen epochs; the steady step times from the host-clock marks
around train_step; and the profiled epoch's device time and idle share."""

import textwrap

import pytest

from count_pipnet_tpu_torch.scripts import acceptance_run as acc


def test_summarize_reads_csv_and_log(tmp_path):
    (tmp_path / "log_epoch_overview.csv").write_text(textwrap.dedent("""\
        epoch,test_top1_acc,local_size_for_true_class,prototypes_per_class,num_nonzero_prototypes
        1,n.a.,n.a.,n.a.,n.a.
        1,0.25,3.0,5.0,16
        2,0.75,2.5,4.0,9
        3,0.5,2.0,3.0,8
        """))
    (tmp_path / "out.txt").write_text(textwrap.dedent("""\
        Pretrain Epoch 1 with batch size 128
          Epoch time: 4.0s (2.00 steps/s)
          pretrain prototype visualization took 2.5s
         Epoch 1 finetune: False
          Epoch time: 9.0s (1.00 steps/s)
         Epoch 2 finetune: False
          Epoch time: 2.0s (8.00 steps/s)
         Epoch 3 finetune: False
          Epoch time: 3.0s (4.00 steps/s)
          prototype visualization took 3.5s
        """))
    got = acc.summarize(str(tmp_path), freeze_epochs=1)
    assert (got["best_top1"], got["best_epoch"], got["last_top1"]) == (
        0.75, 2, 0.5)
    assert (got["local_size_true"], got["protos_per_class"],
            got["nonzero_protos"]) == (2.5, 4.0, 9.0)
    assert (got["main_epochs"], got["pretrain_epochs"]) == (3, 1)
    assert got["epoch_s_median"] == 2.5 and got["epoch_s_first"] == 9.0
    assert got["pretrain_epoch_s_median"] == 4.0
    assert got["visualization_s"] == {
        "pretrain prototype visualization": 2.5,
        "prototype visualization": 3.5}


def test_step_times_take_the_steady_main_epochs():
    # main epochs 1 (frozen), 2 (steady) and 3 (steady but profiled); a
    # pretraining epoch; marks are (call, return) on the host clock
    epochs = {
        ("pretrain", 2): (0.0, [(1.0, 2.0), (3.0, 9.0)], 10.0),
        ("main", 1): (0.0, [(1.0, 2.0), (3.0, 9.0)], 10.0),
        ("main", 2): (10.0, [(10.5, 10.6), (10.7, 10.9), (11.2, 11.3)],
                      11.7),
        ("main", 3): (20.0, [(21.0, 22.0), (23.0, 29.0)], 30.0),
    }
    got = acc.step_times(epochs, freeze_epochs=1, skip=(3,))
    assert got["steady_epochs"] == 1
    # intervals 0.3, 0.4; inside 0.2, 0.1; before 0.1, 0.3 (medians)
    assert got["step_ms"] == pytest.approx(350.0)
    assert got["in_train_step_ms"] == pytest.approx(150.0)
    assert got["before_step_ms"] == pytest.approx(200.0)
    assert got["epoch_start_ms"] == pytest.approx(500.0)
    assert got["epoch_tail_ms"] == pytest.approx(400.0)
    assert acc.step_times(epochs, freeze_epochs=3) is None


def test_read_profile_sums_device_time():
    class Ev:
        def __init__(self, key, us, count):
            self.key, self.self_device_time_total = key, us
            self.count = count

    class Prof:
        def key_averages(self):
            return [Ev("gemm", 3000.0, 10), Ev("cpu op", 0.0, 5),
                    Ev("ln", 1000.0, 20)]

    got = acc.Instrument.read_profile(Prof(), epoch=12, wall=0.05, steps=4)
    assert got["device_busy_ms"] == 4.0 and got["device_ms_per_step"] == 1.0
    assert got["idle_share"] == pytest.approx(0.92)
    assert [k["name"] for k in got["top_kernels"]] == ["gemm", "ln"]
    assert got["top_kernels"][0] == {"name": "gemm", "ms": 3.0, "calls": 10}
