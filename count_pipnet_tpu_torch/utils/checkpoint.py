"""Checkpoints with the reference's roles and config-hash discovery.

Port of count_pipnet_tpu/utils/checkpoint.py (reference
util/checkpoint_manager.py, util/selective_loading.py):

* roles: ``net_pretrained`` (after phase 1) plus a copy named by the
  config hash, rolling ``net_trained`` + ``net_trained_last``, and
  ``net_best`` kept when the stored accuracy improves;
* the same md5 ``config_hash`` over the pretraining-relevant settings;
* search order: ``pretrained_checkpoints_dir/checkpoints`` then
  ``log_dir/checkpoints`` (own directory first for the trained roles);
* resume: model and optimizer state, epoch and Gumbel ``tau`` from the
  JSON sidecar;
* backbone-only loading across architectures, skipping shape mismatches.

Format: ``torch.save`` of ``{"model": state_dict, "optimizer": state
dict or {}}`` plus a JSON sidecar, each written to a temporary file and
renamed. Every loader also reads the JAX package's files: flax msgpack of
``{"params", "batch_stats", "opt_state"}`` with the same sidecar
(count_pipnet_tpu/utils/checkpoint.py), told apart by the first bytes (a
``torch.save`` file is a zip) and carried over by :func:`from_jax_state`.

As in the JAX package, the pretrained and shared-backbone routes graft
parameters only (a BatchNorm's running statistics keep their fresh
values there); a resume restores the running statistics and the AdamW
state too.
"""

import hashlib
import json
import os
import shutil

import torch

from ..models.convert import from_jax_params, jax_path
from .msgpack import unpackb

__all__ = ["CheckpointManager", "config_hash", "load_backbone_only",
           "find_shared_backbone", "graft_state_dict", "graft_pretrained",
           "from_jax_state"]

_ZIP_MAGIC = b"PK\x03\x04"


def config_hash(args) -> str:
    """md5 over pretraining-relevant params (reference main.py:27-40)."""
    pretraining_params = {
        "max_count": getattr(args, "max_count", 3),
        "use_mid_layers": getattr(args, "use_mid_layers", False),
        "num_stages": getattr(args, "num_stages", 2),
        "num_features": args.num_features,
        "activation": getattr(args, "activation", "gumbel_softmax"),
        "net": args.net,
        "dataset": args.dataset,
    }
    param_str = json.dumps(pretraining_params, sort_keys=True)
    return hashlib.md5(param_str.encode()).hexdigest()[:10]


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save_file(path, state, meta):
    tmp = path + ".tmp"
    torch.save(_cpu(state), tmp)
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def _load_meta(path):
    """A checkpoint's .json sidecar; None if absent or corrupt."""
    try:
        with open(path + ".json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def from_jax_state(tree):
    """A JAX package checkpoint ``{"params", "batch_stats", "opt_state"}``
    -> the port's ``{"model": state dict, "optimizer": {},
    "adamw_by_name": {name: {"step", "exp_avg", "exp_avg_sq"}}}``. The
    JAX AdamW state (count_pipnet_tpu/train/optim.py: adamw_init) holds
    ``mu`` / ``nu`` trees shaped as the parameters and a per-leaf ``step``;
    a leaf that never stepped gets no entry, as a PyTorch parameter that
    never had a gradient has no optimizer state."""
    model = from_jax_params(tree["params"], tree.get("batch_stats") or {})
    by_name = {}
    opt = tree.get("opt_state") or {}
    if opt:
        mu, nu = from_jax_params(opt["mu"]), from_jax_params(opt["nu"])
        for name in mu:
            step = opt["step"]
            for k in jax_path(name):
                step = step[k]
            if int(step) > 0:
                by_name[name] = {"step": torch.tensor(float(step)),
                                 "exp_avg": mu[name],
                                 "exp_avg_sq": nu[name]}
    return {"model": model, "optimizer": {}, "adamw_by_name": by_name}


def _load_file(path):
    """(state, meta) of a checkpoint in either format."""
    with open(path, "rb") as f:
        jax_file = f.read(4) != _ZIP_MAGIC
        f.seek(0)
        state = (from_jax_state(unpackb(f.read())) if jax_file else
                 torch.load(f, map_location="cpu", weights_only=True))
    return state, _load_meta(path) or {}


def graft_state_dict(model, saved, prefixes=None):
    """Copy the entries of ``saved`` whose key names a parameter of
    ``model`` with the same shape (and, with ``prefixes``, starts with one
    of them); keep the model's own values elsewhere, its buffers (running
    statistics) included. Returns (loaded, skipped) counts."""
    own = dict(model.named_parameters())
    new, loaded, skipped = {}, 0, 0
    for key, value in own.items():
        if prefixes is not None and not key.startswith(tuple(prefixes)):
            continue
        src = saved.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            new[key] = src.to(value.dtype)
            loaded += 1
        else:
            skipped += 1
    model.load_state_dict(new, strict=False)
    return loaded, skipped


def graft_pretrained(model, saved):
    """graft_state_dict of a whole pretrained model, with the JAX package's
    line when some parameters keep their fresh init (e.g. an onehot
    checkpoint loaded into a model with another intermediate layer)."""
    loaded, skipped = graft_state_dict(model, saved)
    if skipped:
        print(f"Partial checkpoint restore: {loaded} leaves loaded, "
              f"{skipped} kept at fresh init (tree/shape mismatch — e.g. "
              f"different intermediate layer)", flush=True)
    return loaded, skipped


class CheckpointManager:
    """The checkpoint roles of one run (``log_dir/checkpoints``)."""

    def __init__(self, args):
        self.args = args
        self.hash = config_hash(args)
        self.log_ckpt_dir = os.path.join(args.log_dir, "checkpoints")
        os.makedirs(self.log_ckpt_dir, exist_ok=True)
        self.search_dirs = []
        if getattr(args, "pretrained_checkpoints_dir", ""):
            self.search_dirs.append(
                os.path.join(args.pretrained_checkpoints_dir, "checkpoints"))
        self.search_dirs.append(self.log_ckpt_dir)
        # a resumed run keeps the best accuracy of the run it continues,
        # so its first (worse) epoch cannot overwrite net_best
        self.best_accuracy = -1.0
        if getattr(args, "resume_training", False):
            meta = _load_meta(os.path.join(self.log_ckpt_dir, "net_best"))
            if meta and "accuracy" in meta:
                self.best_accuracy = float(meta["accuracy"])

    # -- save ---------------------------------------------------------------
    @staticmethod
    def _state(model_state, opt_state=None):
        return {"model": model_state, "optimizer": opt_state or {}}

    def save_pretrained_checkpoint(self, model_state, opt_state=None):
        """net_pretrained + a copy named by the config hash."""
        state = self._state(model_state, opt_state)
        meta = {"config_hash": self.hash}
        _save_file(os.path.join(self.log_ckpt_dir, "net_pretrained"),
                   state, meta)
        _save_file(
            os.path.join(self.log_ckpt_dir, f"net_pretrained_{self.hash}"),
            state, meta)

    def save_trained_checkpoint(self, model_state, opt_state, epoch,
                                tau=None, rng=None):
        """Rolling net_trained + net_trained_last, with the epoch and the
        Gumbel temperature in the sidecar so a resumed run continues at
        the annealed ``tau``, and ``rng`` (the states of the run's random
        streams, under ``"rng"``) so that it draws what the uninterrupted
        run would."""
        meta = {"epoch": epoch if isinstance(epoch, int) else str(epoch),
                "config_hash": self.hash}
        if tau is not None:
            meta["tau"] = float(tau)
        state = self._state(model_state, opt_state)
        if rng is not None:
            state["rng"] = rng
        first = os.path.join(self.log_ckpt_dir, "net_trained")
        _save_file(first, state, meta)
        second = os.path.join(self.log_ckpt_dir, "net_trained_last")
        shutil.copyfile(first, second + ".tmp")
        os.replace(second + ".tmp", second)
        shutil.copyfile(first + ".json", second + ".json.tmp")
        os.replace(second + ".json.tmp", second + ".json")

    def save_best_checkpoint(self, model_state, opt_state, epoch, accuracy):
        """Keep net_best when accuracy improves."""
        if accuracy <= self.best_accuracy:
            return False
        self.best_accuracy = float(accuracy)
        meta = {"epoch": epoch, "accuracy": float(accuracy),
                "config_hash": self.hash}
        _save_file(os.path.join(self.log_ckpt_dir, "net_best"),
                   self._state(model_state, opt_state), meta)
        return True

    # -- load ---------------------------------------------------------------
    def _find(self, names, own_first=False):
        dirs = list(reversed(self.search_dirs)) if own_first \
            else self.search_dirs
        for d in dirs:
            for name in names:
                path = os.path.join(d, name)
                if os.path.exists(path):
                    return path
        return None

    def load_pretrained_checkpoint(self):
        """Explicit ``--state_dict_dir_net`` (a file or a directory holding
        net_pretrained), else the hash-matched copy. Returns (state, meta)
        or None."""
        explicit = getattr(self.args, "state_dict_dir_net", "")
        if explicit:
            if os.path.isdir(explicit):
                cand = os.path.join(explicit, "net_pretrained")
                path = cand if os.path.exists(cand) else None
            elif os.path.isfile(explicit):
                path = explicit
            else:
                path = self._find([os.path.basename(explicit)])
        else:
            path = self._find([f"net_pretrained_{self.hash}"])
        if path is None:
            return None
        print(f"Loading pretrained checkpoint: {path}", flush=True)
        return _load_file(path)

    def load_trained_checkpoint(self, name="net_trained_last"):
        path = self._find([name], own_first=True)
        if path is None:
            return None
        print(f"Resuming from checkpoint: {path}", flush=True)
        return _load_file(path)

    def load_best_checkpoint(self):
        path = self._find(["net_best"], own_first=True)
        return None if path is None else _load_file(path)


def load_backbone_only(checkpoint_path, model,
                       prefixes=("backbone.", "add_on."), verbose=True):
    """Load only the backbone (and add-on) entries of any checkpoint into
    ``model``, skipping shape mismatches (reference
    util/selective_loading.py:14-162). Returns an info dict."""
    state, _ = _load_file(checkpoint_path)
    loaded, skipped = graft_state_dict(model, state.get("model", state),
                                       prefixes)
    if verbose:
        print(f"Loaded {loaded}/{loaded + skipped} backbone parameters "
              f"from {checkpoint_path}", flush=True)
    return {"success": loaded > 0, "loaded_params": loaded,
            "total_backbone_params": loaded + skipped}


def find_shared_backbone(directory):
    """A candidate checkpoint in ``directory``, pretrained ones first
    (reference selective_loading.py:164-200)."""
    candidates = []
    for sub in ("checkpoints", "."):
        d = os.path.join(directory, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith((".json", ".tmp")):
                continue
            if name.startswith("net_pretrained"):
                candidates.insert(0, os.path.join(d, name))
            elif name.startswith("net_"):
                candidates.append(os.path.join(d, name))
    return candidates[0] if candidates else None
