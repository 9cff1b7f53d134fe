"""The port's prototype visualisation (count_pipnet_tpu_torch/interpret/)
against the JAX package's on the same parameters and projection set:

* ``get_patch_size`` and ``get_img_coordinates`` equal over every latent
  cell of several grids, the 26x26 special case among them;
* ``score_projection_set`` (and the histograms' ``collect_activations``)
  for a Count-PIPNet under the same injected Gumbel noise and for a
  PIP-Net: values within tests/test_torch_port_model.py's RTOL/ATOL,
  argmax patches equal;
* ``vizualize_network`` with the prototype maps on (and, for the PIP-Net,
  the histograms), two prototypes past the importance filter: the same
  top-k picks and so the same file names.
The projection set is a tiny shapes dataset from the port's generator;
small widths; parameters from numpy seeds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.interpret import histograms as jhist
from count_pipnet_tpu.interpret import vis_pipnet as jvis
from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu.models.pipnet import PIPNet as JPIPNet
from count_pipnet_tpu.utils.func import get_patch_size as j_patch_size
from count_pipnet_tpu_torch.data.datasets import (ImageFolder,
                                                  TransformedDataset)
from count_pipnet_tpu_torch.data.generate_shapes import main as shapes_main
from count_pipnet_tpu_torch.data.loader import DataLoader
from count_pipnet_tpu_torch.data.registry import _no_augment
from count_pipnet_tpu_torch.interpret import histograms, vis_pipnet
from count_pipnet_tpu_torch.models.convert import from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet, PIPNet
from count_pipnet_tpu_torch.ops import gumbel as tgumbel
from count_pipnet_tpu_torch.utils.func import get_patch_size
from test_torch_port_model import ATOL, RTOL
from test_torch_port_trajectory import LAT, NUM_STAGES, P, STAGES

NC = 9        # the shapes dataset's classes: counts 1, 2, 3 by class
N = 18        # projection images, two a class
PAD = 64      # the JAX scorer's batch: it pads the set up to it


@pytest.mark.parametrize("img_size,wshape", [
    (224, 26), (224, 28), (224, 13), (192, 24), (64, 7)])
def test_patch_geometry_matches_jax(img_size, wshape):
    assert get_patch_size(img_size, wshape) == j_patch_size(img_size, wshape)
    patchsize, skip = get_patch_size(img_size, wshape)
    shape = (P, wshape, wshape)
    for h in range(wshape):
        for w in range(wshape):
            assert vis_pipnet.get_img_coordinates(
                img_size, shape, patchsize, skip, h, w) == \
                jvis.get_img_coordinates(img_size, shape, patchsize, skip,
                                         h, w), (h, w)


@pytest.fixture(scope="module")
def projectloader(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    shapes_main(["--output_dir", str(root), "--img_size", "64",
                 "--train_samples_per_class", "2",
                 "--test_samples_per_class", "0", "--seed", "3"])
    ds = TransformedDataset(ImageFolder(root / "train"), _no_augment(64))
    assert len(ds) == N
    return DataLoader(ds, 1, shuffle=False, num_workers=1)


def _family(kind, seed=7, keep=None):
    """The flax and the port's model on the same parameters: a gumbel
    Count-PIPNet or a PIP-Net, layer scales 0.2, the trainer's classifier
    init; with ``keep``, the classifier's columns of every other
    prototype zeroed, so that only those pass the importance filter."""
    jb = JFeatures(stage_settings=STAGES, stride_threshold=40,
                   num_stages=NUM_STAGES)
    tb = ConvNeXtFeatures(STAGES, 40, NUM_STAGES)
    if kind == "count":
        jm = JCountPIPNet(num_classes=NC, num_prototypes=P, max_count=3,
                          backbone=jb, num_features=P)
        tm = CountPIPNet(num_classes=NC, num_prototypes=P, max_count=3,
                         backbone=tb, num_features=P)
    else:
        jm = JPIPNet(num_classes=NC, num_prototypes=P, backbone=jb,
                     num_features=P)
        tm = PIPNet(num_classes=NC, num_prototypes=P, backbone=tb,
                    num_features=P)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))["params"])
    rng = np.random.default_rng(seed)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    clf = {"weight": (1.0 + 0.1 * rng.normal(
        size=params["classification"]["weight"].shape)).astype(np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)}
    if keep is not None:
        attr = (tm.intermediate.classifier_input_weight_matrix().numpy()
                if kind == "count" else np.eye(P))  # [P, classifier input]
        used = np.abs(attr[list(keep)]).sum(axis=0) > 0
        clf["weight"][:, ~used] = 0.0
    params = dict(params, backbone=bb, classification=clf)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _inject_noise(monkeypatch):
    """The same Gumbel noise on both sides: JAX draws a [PAD, ...] block
    for its padded batch; the port takes its first rows."""
    noise = np.random.default_rng(11).gumbel(size=(PAD, LAT, LAT, P)) \
        .astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    monkeypatch.setattr(tgumbel, "sample_gumbel",
                        lambda shape, generator=None, device=None:
                        torch.from_numpy(noise[:shape[0]]))


@pytest.mark.parametrize("kind", ["count", "pipnet"])
def test_score_projection_set_matches_jax(monkeypatch, projectloader, kind):
    _inject_noise(monkeypatch)
    jm, params, tm = _family(kind)
    want = jvis.score_projection_set(jm, params, {}, projectloader,
                                     tau=1.0, batch=PAD)
    got = vis_pipnet.score_projection_set(tm, projectloader, tau=1.0,
                                          batch=PAD)
    assert got["pooled"].shape == (N, P)
    np.testing.assert_array_equal(got["ys"], want["ys"])
    for k in ("pooled", "max_act"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    _check_argmax(jm, params, projectloader, got, want, exact=kind != "count")
    acts, labels = histograms.collect_activations(tm, projectloader,
                                                  batch=PAD)
    acts_j, labels_j = jhist.collect_activations(jm, params, {},
                                                 projectloader, batch=PAD)
    np.testing.assert_array_equal(labels, labels_j)
    np.testing.assert_allclose(acts, acts_j, rtol=RTOL, atol=ATOL)


def _check_argmax(jm, params, loader, got, want, exact):
    """Each (image, prototype)'s argmax patch equals JAX's wherever JAX's
    map has a unique maximum (its top two cells more than ATOL apart);
    elsewhere the port's patch holds JAX's maximum within ATOL. A hard
    Gumbel map is one-hot up to an ulp (y_hard + y_soft - y_soft), so its
    ties fall by rounding noise; the softmax maps of a PIP-Net must agree
    everywhere (``exact``)."""
    xs = np.concatenate([np.asarray(x) for x, _ in loader])
    xs = np.concatenate([xs, np.repeat(xs[-1:], PAD - N, axis=0)])
    maps = np.asarray(jax.jit(lambda x: jm.apply(
        {"params": params}, x, inference=True,
        rngs={"gumbel": jax.random.PRNGKey(0)})[0])(jnp.asarray(xs)))[:N]
    flat = maps.reshape(N, LAT * LAT, P)
    top2 = np.sort(flat, axis=1)[:, -2:]
    unique = top2[:, 1] - top2[:, 0] > ATOL
    cell = lambda d: d["h_idx"] * LAT + d["w_idx"]  # noqa: E731
    np.testing.assert_array_equal(cell(want), flat.argmax(axis=1))
    assert unique.any()
    np.testing.assert_array_equal(cell(got)[unique], cell(want)[unique])
    picked = np.take_along_axis(flat, cell(got)[:, None, :], axis=1)[:, 0]
    assert (picked >= top2[:, 1] - ATOL).all()
    if exact:
        assert unique.all()


def _tree(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))


@pytest.mark.parametrize("kind", ["count", "pipnet"])
def test_vizualize_network_matches_jax(monkeypatch, tmp_path, projectloader,
                                       kind):
    """The same top-k picks (image index; scores within RTOL/ATOL), so the
    same patch, grid, prototype-map (and histogram) files."""
    _inject_noise(monkeypatch)
    jm, params, tm = _family(kind, keep=(1, 6))
    hist = kind == "pipnet"
    kw = dict(k=10, visualize_prototype_maps=True, plot_histograms=hist,
              max_feature_maps_per_prototype=2)
    jargs = types.SimpleNamespace(log_dir=str(tmp_path / "jax"),
                                  image_size=64, wshape=LAT)
    targs = types.SimpleNamespace(log_dir=str(tmp_path / "port"),
                                  image_size=64, wshape=LAT)
    want = jvis.vizualize_network(
        types.SimpleNamespace(model=jm, params=params, batch_stats={},
                              tau=1.0), projectloader, NC, "viz", jargs,
        **kw)
    got = vis_pipnet.vizualize_network(
        types.SimpleNamespace(model=tm, tau=1.0, dtype="float32"),
        projectloader, NC, "viz", targs, **kw)
    assert got.keys() == want.keys() == {1, 6}
    for p in want:
        assert [i for i, _ in got[p]] == [i for i, _ in want[p]], p
        np.testing.assert_allclose([s for _, s in got[p]],
                                   [s for _, s in want[p]], rtol=RTOL,
                                   atol=ATOL)
    files = _tree(tmp_path / "port" / "viz")
    assert files == _tree(tmp_path / "jax" / "viz")
    assert "grid_topk_all.png" in files
    assert any(f.startswith("feature_maps/prototype_6/") for f in files)
    assert ("histograms/histograms.html" in files) == hist


def test_histograms_accept_histogram_type(tmp_path, projectloader):
    """``plot_prototype_activations_by_class`` takes the JAX signature's
    ``histogram_type="per-class"`` (unused on both sides): the same
    per-class means and the same files as the JAX call with it. Two
    prototypes pass the importance filter, so two histograms a side."""
    jm, params, tm = _family("pipnet", keep=(1, 6))
    kw = dict(histogram_type="per-class", max_images=N)
    want = jhist.plot_prototype_activations_by_class(
        types.SimpleNamespace(model=jm, params=params, batch_stats={},
                              tau=1.0), projectloader, NC,
        str(tmp_path / "jax"), None, **kw)
    got = histograms.plot_prototype_activations_by_class(
        types.SimpleNamespace(model=tm, tau=1.0, dtype="float32"),
        projectloader, NC, str(tmp_path / "port"), None, **kw)
    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key in tree
                    for k, v in flat(tree[key], path + (key,)).items()}
        return {path: float(tree)}

    got, want = flat(got), flat(want)
    assert want and got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=str(k))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
