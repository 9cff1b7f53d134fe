"""The canonical experiment's runner (count_pipnet_tpu_torch/scripts/
acceptance_run.py) reads a run as it is written: the main phase's CSV
rows (pretraining's n.a. rows skipped), the epoch times of each phase
and the visualisations' wall times from out.txt, the steady state taken
after the frozen epochs; the steady step times from the host-clock marks
around train_step; and the profiled epoch's device time and idle share.
A schedule that never unfreezes the trunk (configs/flagship_200_wide.yaml)
takes its steady epochs after the first two main epochs and profiles main
epoch 12; a run whose visualisation was skipped, or that never launched K5
or K6, fails; a config runs as written, with --seed only where it
differs."""

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
    got = acc.summarize(str(tmp_path), steady_after=1)
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
    assert got["visualization_skipped"] == {}


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
    got = acc.step_times(epochs, steady_after=1, skip=(3,))
    assert got["steady_epochs"] == 1
    # intervals 0.3, 0.4; inside 0.2, 0.1; before 0.1, 0.3 (medians)
    assert got["step_ms"] == pytest.approx(350.0)
    assert got["in_train_step_ms"] == pytest.approx(150.0)
    assert got["before_step_ms"] == pytest.approx(200.0)
    assert got["epoch_start_ms"] == pytest.approx(500.0)
    assert got["epoch_tail_ms"] == pytest.approx(400.0)
    assert acc.step_times(epochs, steady_after=3) is None


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


def test_schedule_of_a_trunk_that_never_unfreezes():
    # the canonical experiment: 10 frozen epochs of 100, profile epoch 12
    assert acc.schedule(10, 100) == (10, 12)
    # flagship_200_wide: freeze_epochs 60 of 60 main epochs
    assert acc.schedule(60, 60) == (2, 12)
    assert acc.schedule(80, 60) == (2, 12)
    assert acc.schedule(60, 5) == (2, 5)
    assert acc.schedule(4, 5) == (4, 5)


def _frozen_run(tmp_path, vis_line):
    rows = "\n".join(f"{e},{a},2.0,8.0,255" for e, a in
                     ((1, 0.1), (2, 0.3), (3, 0.4), (4, 0.35), (5, 0.38)))
    (tmp_path / "log_epoch_overview.csv").write_text(
        "epoch,test_top1_acc,local_size_for_true_class,"
        "prototypes_per_class,num_nonzero_prototypes\n1,n.a.,n.a.,n.a.,n.a."
        "\n" + rows + "\n")
    times = (20.0, 12.0, 5.0, 7.0, 6.0)
    (tmp_path / "out.txt").write_text(
        "Pretrain Epoch 1 with batch size 96\n"
        "  Epoch time: 30.0s (3.00 steps/s)\n"
        "lr plot skipped: No module named 'matplotlib'\n"
        + "".join(f" Epoch {e} finetune: False\n"
                  f"  Epoch time: {t}s (9.00 steps/s)\n"
                  for e, t in enumerate(times, 1))
        + vis_line + "  prototype visualization took 40.0s\n")


def test_summarize_a_trunk_that_never_unfreezes(tmp_path):
    _frozen_run(tmp_path, "")
    steady_after, _ = acc.schedule(60, 60)
    got = acc.summarize(str(tmp_path), steady_after)
    # the steady epochs are main epochs 3-5 (5.0, 7.0, 6.0), not every
    # epoch (the first two are the slowest) and not none
    assert got["epoch_s_median"] == 6.0 and got["epoch_s_first"] == 20.0
    assert (got["best_top1"], got["best_epoch"], got["last_top1"]) == (
        0.4, 3, 0.38)
    assert got["visualization_skipped"] == {}
    epochs = {("main", e): (10.0 * e, [(10.0 * e + 1, 10.0 * e + 1.5),
                                        (10.0 * e + 2, 10.0 * e + 2.5 + e)],
                            10.0 * e + 9) for e in range(1, 6)}
    got = acc.step_times(epochs, steady_after, skip=(5,))
    assert got["steady_epochs"] == 2          # main epochs 3 and 4
    # intervals 1 + e s: 4 s and 5 s
    assert got["step_ms"] == pytest.approx(4500.0)


def test_a_skipped_visualisation_fails_the_run(tmp_path):
    _frozen_run(tmp_path, "(prototype visualization skipped: No module "
                          "named 'PIL')\n")
    got = acc.summarize(str(tmp_path), 2)
    # the lr plot's skip (matplotlib) is not a visualisation's
    assert got["visualization_skipped"] == {
        "prototype visualization": "No module named 'PIL'"}
    res = {**got, "launches": {"fused_ln_mlp_residual": 5,
                               "fused_mlp_bwd": 3}}
    assert acc.run_faults(res) == [
        "prototype visualization skipped: No module named 'PIL'"]


def test_k5_or_k6_never_launched_fails_the_run():
    res = {"visualization_skipped": {},
           "launches": {"fused_ln_mlp_residual": 5, "fused_block": 2}}
    assert acc.run_faults(res) == ["fused_mlp_bwd launched 0 times"]
    res["launches"]["fused_mlp_bwd"] = 1
    assert acc.run_faults(res) == []


def test_run_argv_runs_the_config_as_written():
    from count_pipnet_tpu_torch.config import get_args
    canon = acc.run_argv(acc.CONFIG, 2, "out/r", [], get_args)
    assert canon[1].endswith("configs/sweep_r2/onehot_seed2.yaml")
    assert canon[2:] == ["--log_dir", "out/r", "--viz_prototype_maps",
                         "False"]
    wide = "configs/flagship_200_wide.yaml"
    assert acc.run_argv(wide, 1, "out/w", [], get_args)[2:] == [
        "--log_dir", "out/w", "--viz_prototype_maps", "False"]
    assert acc.run_argv(wide, 2, "out/w", [], get_args)[-2:] == [
        "--seed", "2"]
    args = get_args(acc.run_argv(wide, 1, "out/w", [], get_args))
    assert (args.freeze_epochs, args.epochs, args.num_features) == (
        60, 60, 256)
