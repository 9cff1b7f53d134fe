"""The port's interpret_idg (count_pipnet_tpu_torch/interpret/
interpret_idg.py) against the JAX package's on one trained-run directory
written by the JAX package (its ``save_args`` and ``CheckpointManager``,
flax msgpack, random parameters from a seed) over a tiny shapes dataset
made by the port's generator:

* ``load_model_for_interpretation`` gives the same model from the JAX
  run and from a port run of the same parameters (``torch.save``), the
  device being the caller's; its forward equals the JAX loader's model's
  (same injected Gumbel noise) within tests/test_torch_port_model.py's
  RTOL/ATOL;
* ``interpret_prototypes`` (IG, 16 steps): the same active prototypes and
  attributions within RTOL, ATOL times the largest attribution;
* ``interpret()`` (IDG) and the logits mode write the same file names.
A gumbel Count-PIPNet (the virtual weights select the prototypes) and a
PIP-Net, one stage, 4 prototypes, 64x64 images."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from count_pipnet_tpu.config import build_parser as j_build_parser
from count_pipnet_tpu.config import save_args as j_save_args
from count_pipnet_tpu.interpret import interpret_idg as jidg
from count_pipnet_tpu.models.pipnet import get_count_network as j_count_net
from count_pipnet_tpu.models.pipnet import get_pipnet as j_pipnet
from count_pipnet_tpu.utils import checkpoint as jck
from count_pipnet_tpu_torch.config import build_parser, save_args
from count_pipnet_tpu_torch.data.generate_shapes import main as shapes_main
from count_pipnet_tpu_torch.interpret import interpret_idg as tidg
from count_pipnet_tpu_torch.ops import gumbel as tgumbel
from count_pipnet_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_port_model import ATOL, RTOL

SIDE, P, LAT = 64, 4, 16   # one stage: 64 px -> 16x16 latent
NC = 9                     # the shapes dataset's classes
CFG = {"steps": 8, "batch_size": 8}
# weighted activations past which one to two prototypes an image stay
# active (the attributions, not their count, are what the tests hold)
THRESHOLD = {"count": 9.5, "pipnet": 0.6, "names": 0.75}


def run_flags(kind, log_dir):
    flags = ["--dataset", "geometric_shapes", "--net", "convnext_tiny_26",
             "--use_mid_layers", "--num_stages", "1", "--num_features",
             str(P), "--image_size", str(SIDE), "--dtype", "float32",
             "--disable_cuda", "--seed", "3", "--log_dir", str(log_dir)]
    if kind == "count":
        flags += ["--model", "count_pipnet", "--max_count", "3",
                  "--use_ste", "True", "--activation", "gumbel_softmax"]
    return flags


def make_dataset(root):
    """The tiny shapes dataset of the geometric_shapes recipe under
    ``root``: 2 train and 1 test images a class."""
    shapes_main(["--output_dir", str(root / "data/geometric_shapes/dataset"),
                 "--img_size", str(SIDE), "--train_samples_per_class", "2",
                 "--test_samples_per_class", "1", "--seed", "3"])


def make_jax_run(root, kind, seed=5):
    """A JAX run directory: metadata/args.pickle and net_best, with layer
    scales 0.2, a stem bias of N(0, 0.5) and the trainer's classifier
    init. Returns (run dir, flax model, params, JAX args)."""
    run = root / f"jax_{kind}"
    args = j_build_parser().parse_args(run_flags(kind, run))
    model, _ = (j_count_net(NC, args, max_count=3, use_ste=True)
                if kind == "count" else j_pipnet(NC, args))
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3)))["params"])
    rng = np.random.default_rng(seed)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    stem = bb["features_0"]
    bb["features_0"] = dict(stem, conv=dict(stem["conv"], bias=(
        0.5 * rng.normal(size=stem["conv"]["bias"].shape)).astype(
            np.float32)))
    clf = dict(params["classification"], weight=(1.0 + 0.1 * rng.normal(
        size=params["classification"]["weight"].shape)).astype(np.float32))
    params = dict(params, backbone=bb, classification=clf)
    j_save_args(args, str(run / "metadata"))
    jck.CheckpointManager(args).save_best_checkpoint(params, {}, {}, 1, 0.5)
    return run, model, params, args


def inject_noise(monkeypatch, seed=11):
    """The same Gumbel noise on both sides for a batch of any size."""
    noise = np.random.default_rng(seed).gumbel(size=(32, LAT, LAT, P)) \
        .astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise[:shape[0]], dtype))
    monkeypatch.setattr(tgumbel, "sample_gumbel",
                        lambda shape, generator=None, device=None:
                        torch.from_numpy(noise[:shape[0]]))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads a test process, as the CLI tests' subprocesses
    run, so that parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("interp_idg")
    make_dataset(root)
    return root, {k: make_jax_run(root, k) for k in ("count", "pipnet")}


def _x(seed=0):
    return np.random.default_rng(seed).normal(
        size=(2, SIDE, SIDE, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["count", "pipnet"])
def test_loader_reads_port_and_jax_runs(monkeypatch, runs, kind):
    inject_noise(monkeypatch)
    root, by_kind = runs
    run = by_kind[kind][0]
    model, args = tidg.load_model_for_interpretation(str(run),
                                                     device="cpu")
    assert args.log_dir == str(run) and args.disable_cuda
    assert next(model.parameters()).device.type == "cpu"
    # a port run of the same parameters
    port = root / f"port_{kind}"
    pargs = build_parser().parse_args(run_flags(kind, port))
    save_args(pargs, str(port / "metadata"))
    CheckpointManager(pargs).save_best_checkpoint(model.state_dict(), {}, 1,
                                                  0.5)
    again, _ = tidg.load_model_for_interpretation(str(port), device="cpu")
    assert type(again) is type(model)
    a, b = model.state_dict(), again.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the forward against the JAX loader's model
    jmodel, jparams, jstats, _ = jidg.load_model_for_interpretation(
        str(run))
    x = _x()
    want = jmodel.apply({"params": jparams}, jnp.asarray(x), inference=True,
                        train=False, rngs={"gumbel": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = again(torch.from_numpy(x), inference=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("kind", ["count", "pipnet"])
def test_interpret_prototypes_matches_jax(monkeypatch, runs, kind):
    inject_noise(monkeypatch)
    root, by_kind = runs
    run = by_kind[kind][0]
    jmodel, jparams, jstats, jargs = jidg.load_model_for_interpretation(
        str(run))
    model, args = tidg.load_model_for_interpretation(str(run),
                                                     device="cpu")
    path = sorted((root / "data/geometric_shapes/dataset/train").rglob(
        "*.png"))[4]
    img = Image.open(path).convert("RGB")
    cfg = dict(CFG, method="IG", steps=16,
               prototype_threshold=THRESHOLD[kind])
    j_overlay, want = jidg.interpret_prototypes(jmodel, jparams, jstats,
                                                img, jargs, cfg)
    overlay, got = tidg.interpret_prototypes(model, img, args, cfg)
    assert got.keys() == want.keys() and want
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL,
                                   atol=ATOL * np.abs(want[p]).max(),
                                   err_msg=str(p))
    assert overlay.size == j_overlay.size == (SIDE, SIDE)


@pytest.mark.parametrize("mode", ["prototypes", "logits"])
def test_interpret_writes_the_jax_file_names(monkeypatch, runs, mode):
    """interpret() (IDG, one image a class, on the PIP-Net run: none or
    one prototype an image past the threshold) and the logits mode (IG,
    the first 3 projection images, on the Count-PIPNet run); 8 steps."""
    inject_noise(monkeypatch)
    root, by_kind = runs
    run = str(by_kind["pipnet" if mode == "prototypes" else "count"][0])
    monkeypatch.chdir(root)
    names = {}
    for side, mod, kw in (("jax", jidg, {}), ("port", tidg,
                                             {"device": "cpu"})):
        cfg = dict(CFG, run_dir=run, images_per_class=1,
                   prototype_threshold=THRESHOLD["names"],
                   output_dir=f"attr_{side}")
        if mode == "prototypes":
            mod.interpret(dict(cfg, method="IDG"), **kw)
            out = os.path.join(run, f"attr_{side}")
        else:
            mod.interpret_logits_for_dataset(dict(cfg, method="IG"),
                                             max_images=3, **kw)
            out = os.path.join(run, f"attr_{side}_logits")
        names[side] = sorted(os.listdir(out))
    assert names["port"] == names["jax"]
    assert len(names["port"]) == (NC if mode == "prototypes" else 3)


def test_cli_needs_a_card_without_disable_cuda(runs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tidg._cli(["--run_dir", str(runs[1]["count"][0])]) == 2
    assert "--disable_cuda" in capsys.readouterr().err


def test_live_model_and_args_skip_the_loader(monkeypatch, runs):
    """interpret() on a live model and its args (as run_pipnet hands them
    over) writes the files of the loaded run, and leaves every
    parameter's .grad None."""
    inject_noise(monkeypatch)
    root, by_kind = runs
    run = str(by_kind["pipnet"][0])
    model, args = tidg.load_model_for_interpretation(run, device="cpu")
    monkeypatch.chdir(root)
    monkeypatch.setattr(tidg, "load_model_for_interpretation",
                        lambda *a, **k: pytest.fail("loaded from disk"))
    tidg.interpret(dict(CFG, images_per_class=1, method="IG",
                        prototype_threshold=THRESHOLD["names"],
                        output_dir="attr_live"), model=model,
                   args=types.SimpleNamespace(**vars(args)))
    assert len(os.listdir(os.path.join(run, "attr_live"))) == NC
    assert all(p.grad is None for p in model.parameters())


def test_cli_with_disable_cuda_writes_overlays(monkeypatch, runs):
    """``python -m count_pipnet_tpu_torch.interpret.interpret_idg
    --disable_cuda`` on the PIP-Net run: one overlay a class."""
    root, by_kind = runs
    run = str(by_kind["pipnet"][0])
    monkeypatch.chdir(root)
    assert tidg._cli(["--run_dir", run, "--disable_cuda", "--steps", "8",
                      "--images_per_class", "1", "--method", "IG",
                      "--prototype_threshold", str(THRESHOLD["names"]),
                      "--output_dir", "attr_cli"]) == 0
    names = os.listdir(os.path.join(run, "attr_cli"))
    assert len(names) == NC and all(n.endswith("_IG.png") for n in names)
