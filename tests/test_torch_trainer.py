"""The torch port's trainer (``repro_torch.launch.train``), the
counterparts of the JAX package's ``tests/integration/test_train_loop.py``
with the reference's own criteria (loss falls, e2afs tracks exact, resume
exact to rtol 1e-4, ...), run on the CPU; and a step written by the port's
trainer read back by the JAX package's ``checkpoint.restore``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ck
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro_torch.launch.train import train_loop
from repro_torch.models import convert


def test_the_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    """A step of the port's trainer carries the reference's leaf names and
    shapes: ``repro.checkpoint.restore`` reads it into the reference's own
    parameter and optimizer trees."""
    model, opt, _ = train_loop(steps=2, seq=32, batch=2, ckpt_dir=str(tmp_path), log_every=1000,
                               device="cpu")
    params, _ = jax_lm.init(jax_smoke_config("qwen3-4b", sqrt_unit="e2afs"), jax.random.key(1))
    out = jax_ck.restore(tmp_path, 2, {"params": params, "opt": jax_adamw.adamw_init(params)})
    ours = convert.params_to_numpy(model)
    flat_ref = jax.tree_util.tree_flatten_with_path(out["params"])[0]
    for path, leaf in flat_ref:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(np.asarray(leaf), node)
    assert int(out["opt"]["step"]) == 2 == int(opt["step"])


# ---------------------------------------------------------------------------
# the trainer (counterparts of tests/integration/test_train_loop.py)
# ---------------------------------------------------------------------------


def test_trainer_loss_decreases():
    _, _, losses = train_loop(steps=30, seq=64, batch=4, sqrt_unit="exact", log_every=1000,
                              device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_trainer_e2afs_tracks_exact():
    _, _, le = train_loop(steps=25, seq=64, batch=4, sqrt_unit="exact", log_every=1000,
                          device="cpu")
    _, _, la = train_loop(steps=25, seq=64, batch=4, sqrt_unit="e2afs", log_every=1000,
                          device="cpu")
    assert np.mean(la[-5:]) < np.mean(la[:5]) - 0.1
    assert abs(np.mean(la[-5:]) - np.mean(le[-5:])) < 0.5


def test_trainer_restart_resumes_exactly(tmp_path):
    kw = dict(steps=12, seq=32, batch=2, ckpt_every=6, log_every=1000, device="cpu")
    _, _, l_full = train_loop(ckpt_dir=str(tmp_path / "full"), **kw)
    train_loop(ckpt_dir=str(tmp_path / "int"), abort_after=6, **kw)
    _, _, l_resumed = train_loop(ckpt_dir=str(tmp_path / "int"), **kw)
    assert len(l_resumed) == 6
    np.testing.assert_allclose(l_resumed[-1], l_full[-1], rtol=1e-4)


def test_trainer_straggler_checkpoints(tmp_path):
    d = tmp_path / "s"
    train_loop(steps=8, seq=32, batch=2, ckpt_dir=str(d), ckpt_every=100, log_every=1000,
               inject_straggler_at=3, device="cpu")
    found = {int(p.name.split("-")[1]) for p in d.iterdir() if p.name.startswith("step-")}
    assert 4 in found and 8 in found
    hb = json.loads((d / "heartbeat.json").read_text())
    assert len(hb) == 8 and all("wall_s" in h for h in hb)


def test_trainer_compressed_grads_train():
    _, _, losses = train_loop(steps=20, seq=64, batch=4, compress=True, log_every=1000,
                              device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_trainer_microbatches_match_full_batch():
    _, _, l1 = train_loop(steps=6, seq=32, batch=4, microbatches=1, log_every=1000, device="cpu")
    _, _, l2 = train_loop(steps=6, seq=32, batch=4, microbatches=2, log_every=1000, device="cpu")
    assert abs(l1[0] - l2[0]) < 0.05
    assert abs(l1[-1] - l2[-1]) < 0.3


def test_trainer_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(steps=1, seq=16, batch=2)
