"""The port's SimCLR trainer (tpumil_torch/train/simclr_trainer.py) against
the JAX package's: one train step from the same weights, images and draws
(plain SGD swapped in on both sides, as tests/test_simclr.py does: the
updated weights are then linear in the gradients), the schedule, the split
and each epoch's order. On the CPU, bitwise: the grad-cache step whose
microbatch is the batch, remat, and a resume at an epoch end or mid-epoch
against an uninterrupted run. A grad-cache step with smaller microbatches
(2 of a batch of 4) sums each weight's gradient over them in another order:
its loss is bitwise, its updated weights within rtol 1e-5
(tests/test_simclr.py's bar). A microbatch of 1 is left out: there the
CPU's convolutions take another algorithm, and the forward differs too.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_simclr_util import pair_uniforms
from tpumil.models.simclr import SimCLRConfig as JSimCLRConfig
from tpumil.ops.augment import pair_keys
from tpumil.train import simclr_trainer as jtrainer
from tpumil_torch.io import from_jax, native_ckpt
from tpumil_torch.models import simclr
from tpumil_torch.models.simclr import SimCLRConfig
from tpumil_torch.ops.augment import draw_uniforms
from tpumil_torch.train import simclr_trainer
from tpumil_torch.train.simclr_trainer import SimCLRTrainConfig, SimCLRTrainer

CPU = torch.device("cpu")
CFG32 = SimCLRConfig(compute_dtype=torch.float32)


def _trainer(**kw):
    return SimCLRTrainer(CFG32, SimCLRTrainConfig(**kw), device=CPU)


def _images(b, size, seed=0):
    return (np.random.default_rng(seed).random((b, size, size, 3)) * 255) \
        .astype(np.uint8)


class _SGD:
    def init(self, params):
        return ()

    def step(self, params, opt_state, grads, lr):
        return jax.tree.map(lambda p, g: p - lr * g, params, grads), opt_state


# The gradient of the step, the port's against JAX's, relative L2 distance
# per tensor. At batch 4, 64^2, f32 the two lie up to 5.6e-3 apart, and each
# from a float64 step of the same weights and views: JAX's (XLA on the CPU)
# up to 5.6e-3, the port's up to 3.2e-4. A halved, zeroed or sign-flipped
# gradient is 0.5, 1 or 2 away.
GRAD_RL2 = 2e-2


@pytest.fixture(scope="module")
def jax_step():
    """JAX's SGD train step at batch 4, 64^2, f32: (weights before, weights
    after a step of lr 1e-3, JAX's gradient, loss, key, uint8 images). The
    gradient is read off a step of lr 1 from the same weights (before -
    after), where it dominates the weights' rounding."""
    tr = jtrainer.SimCLRTrainer(JSimCLRConfig(compute_dtype=jnp.float32),
                                jtrainer.SimCLRTrainConfig(
                                    batch_size=4, input_size=64, lr=1e-3))
    tr.optimizer = _SGD()
    params = tr.init(jax.random.PRNGKey(0))[0]
    before = jax.tree.map(np.asarray, params)
    images = _images(4, 64)
    key = jax.random.PRNGKey(11)
    x = jnp.asarray(images.astype(np.float32) / 255.0)
    after, _, loss = tr._train_step(params, (), key, x,
                                    jnp.asarray(1e-3, jnp.float32))
    unit, _, _ = tr._train_step(params, (), key, x,
                                jnp.asarray(1.0, jnp.float32))
    b = from_jax.simclr_state_dict(before, CFG32)
    u = from_jax.simclr_state_dict(jax.tree.map(np.asarray, unit), CFG32)
    grad = {k: b[k].double() - u[k].double() for k in b}
    return before, jax.tree.map(np.asarray, after), grad, float(loss), key, \
        images


def test_train_step_matches_jax(jax_step):
    before, after, want_grad, want_loss, key, images = jax_step
    tr = _trainer(batch_size=4, input_size=64, lr=1e-3)
    model = simclr.SimCLR(CFG32, CPU)
    start = from_jax.simclr_state_dict(before, CFG32)
    model.load_state_dict(start)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    loss = tr.train_step(model, opt, pair_uniforms(*pair_keys(key, 4)),
                         torch.from_numpy(images), 1e-3)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    want = from_jax.simclr_state_dict(after, CFG32)
    got = model.state_dict()
    assert list(got) == list(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=2e-5, err_msg=k)
        assert not torch.equal(v, start[k]), k  # every tensor took a step
    # the step itself: SGD moves each weight by lr * grad
    for k, p in model.named_parameters():
        assert p.grad is not None, k
        g, w = p.grad.double(), want_grad[k]
        assert torch.isfinite(g).all() and g.abs().max() > 0, k
        rl2 = ((g - w).norm() / w.norm()).item()
        assert rl2 <= GRAD_RL2, (k, rl2)


def _step(mb=None, remat=False):
    tr = _trainer(batch_size=4, input_size=64, lr=1e-3,
                  grad_cache_microbatch=mb, remat=remat)
    model, _ = tr.init(0)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    u = draw_uniforms(torch.Generator().manual_seed(1), 4)
    images = torch.from_numpy(_images(4, 64, seed=1))
    eval_loss = tr.eval_step(model, u, images)  # microbatched when mb
    loss = tr.train_step(model, opt, u, images, 1e-3)
    return loss, eval_loss, model.state_dict()


def test_grad_cache_and_remat_against_the_monolithic_step():
    loss, eval_loss, want = _step()
    for kw in ({"mb": 4}, {"remat": True}):
        got = _step(**kw)
        assert torch.equal(got[0], loss) and torch.equal(got[1], eval_loss)
        for k, v in want.items():
            assert torch.equal(got[2][k], v), (kw, k)
    got_loss, got_eval, got = _step(mb=2)
    assert torch.equal(got_loss, loss) and torch.equal(got_eval, eval_loss)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


def test_schedule_and_batch_units_match_jax():
    jcfg = JSimCLRConfig()
    for mb in (None, 256):
        kw = dict(batch_size=4096, epochs=100, grad_cache_microbatch=mb)
        port = SimCLRTrainer(CFG32, SimCLRTrainConfig(**kw), device=CPU)
        jax_tr = jtrainer.SimCLRTrainer(jcfg, jtrainer.SimCLRTrainConfig(**kw))
        for n in (0, 3, 255, 256, 4000, 5000):
            assert port._valid_batch_size(n) == jax_tr._valid_batch_size(n)
        assert [port.lr_at(e) for e in range(101)] == \
            [jax_tr.lr_at(e) for e in range(101)]
    with pytest.raises(ValueError, match="must divide"):
        _trainer(batch_size=8, grad_cache_microbatch=3)


class _Recorder:
    """A PatchBatchLoader that records what it is asked to load and yields
    no batch."""
    calls = []

    def __init__(self, paths, batch_size, patch_size=None, num_workers=8):
        type(self).calls.append((list(paths), batch_size, patch_size))

    def __iter__(self):
        return iter(())


def test_split_and_epoch_order_match_jax(tmp_path, monkeypatch):
    """The 90/10 split and every epoch's order, as the loaders receive
    them: numpy's generators on both sides, so bitwise."""
    paths = [f"p{i:03d}.jpeg" for i in range(53)]
    seen = {}
    for name, module, trainer in (
            ("jax", jtrainer, lambda cfg: jtrainer.SimCLRTrainer(
                JSimCLRConfig(compute_dtype=jnp.float32),
                jtrainer.SimCLRTrainConfig(**cfg))),
            ("port", simclr_trainer, lambda cfg: SimCLRTrainer(
                CFG32, SimCLRTrainConfig(**cfg), device=CPU))):
        _Recorder.calls = []
        monkeypatch.setattr(module, "PatchBatchLoader", _Recorder)
        trainer(dict(batch_size=4, epochs=3, input_size=32, seed=5)).fit(
            paths, str(tmp_path / name), log=lambda s: None)
        seen[name] = _Recorder.calls
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 6  # a train and a validation loader a epoch


def _patch_files(tmp_path, n=20, size=48):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"p{i}.jpeg")
        Image.fromarray((rng.random((size, size, 3)) * 255)
                        .astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _crash_after(monkeypatch, n):
    """Make the n-th save of the resume state raise right after it wrote."""
    real = native_ckpt.save_train_state
    calls = {"n": 0}

    def bomb(path, state, *, meta=None):
        real(path, state, meta=meta)
        calls["n"] += 1
        if calls["n"] == n:
            raise KeyboardInterrupt

    monkeypatch.setattr(native_ckpt, "save_train_state", bomb)


@pytest.mark.parametrize("every,crash_at,resumed", [
    (None, 2, "Resuming SimCLR pretraining at epoch 2 "),
    (1, 2, "Resuming SimCLR pretraining at epoch 0 step 2 ")])
def test_resume_matches_an_uninterrupted_run(tmp_path, monkeypatch, every,
                                             crash_at, resumed):
    """A crash right after a saved state, then resume: the model, the Adam
    moments, the data order and the augmentation draws continue exactly
    (bitwise on the CPU)."""
    paths = _patch_files(tmp_path)
    cfg = SimCLRTrainConfig(batch_size=4, epochs=3, input_size=48,
                            num_workers=2, lr=1e-4, log_every_n_steps=100,
                            save_every_n_steps=every)
    straight = SimCLRTrainer(CFG32, cfg, device=CPU).fit(
        paths, str(tmp_path / "a"), log=lambda s: None)
    run = str(tmp_path / "b")
    with monkeypatch.context() as m:
        _crash_after(m, crash_at)
        with pytest.raises(KeyboardInterrupt):
            SimCLRTrainer(CFG32, cfg, device=CPU).fit(paths, run,
                                                      log=lambda s: None)
    logs = []
    out = SimCLRTrainer(CFG32, cfg, device=CPU).fit(paths, run,
                                                    log=logs.append,
                                                    resume=True)
    assert any(line.startswith(resumed) for line in logs), logs
    for k, v in straight["model"].state_dict().items():
        assert torch.equal(out["model"].state_dict()[k], v), k
    assert out["history"]["valid_loss"][-1] == \
        straight["history"]["valid_loss"][-1]
    with open(os.path.join(run, "state", "meta.json")) as f:
        assert json.load(f)["epoch"] == 3


def test_foreign_or_unreadable_state_trains_from_scratch(tmp_path):
    paths = _patch_files(tmp_path, n=10, size=32)
    cfg = SimCLRTrainConfig(batch_size=4, epochs=1, input_size=32,
                            num_workers=2, log_every_n_steps=100)
    run = str(tmp_path / "run")
    SimCLRTrainer(CFG32, cfg, device=CPU).fit(paths, run, log=lambda s: None)
    for other in (dataclasses.replace(cfg, lr=5e-5), cfg):
        if other is cfg:  # an unreadable state
            with open(os.path.join(run, "state", "state.pt"), "wb") as f:
                f.write(b"not a torch file")
        logs = []
        SimCLRTrainer(CFG32, other, device=CPU).fit(paths, run,
                                                    log=logs.append,
                                                    resume=True)
        assert any("different config; training from scratch" in line
                   for line in logs), logs
        assert not any(line.startswith("Resuming") for line in logs)


def test_fine_tune_from_resolves_a_run_name(tmp_path, monkeypatch):
    """fine_tune_from names a run (./runs/<name>/checkpoints/model.pth) or
    a file; a missing one warns and trains from scratch."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(simclr_trainer, "PatchBatchLoader", _Recorder)
    src = simclr.init_model(3, CFG32, CPU)
    os.makedirs("runs/old/checkpoints")
    SimCLRTrainer(CFG32, SimCLRTrainConfig(), device=CPU).save(
        src, "runs/old/checkpoints/model.pth")
    cfg = SimCLRTrainConfig(batch_size=4, epochs=1)
    paths = [f"p{i}.jpeg" for i in range(12)]
    for name, line in (("old", "Loaded pre-trained model with success."),
                       ("missing", "Pre-trained weights not found. "
                                   "Training from scratch.")):
        logs = []
        out = SimCLRTrainer(CFG32, cfg, device=CPU).fit(
            paths, f"run_{name}", log=logs.append, fine_tune_from=name)
        assert line in logs
        same = all(torch.equal(out["model"].state_dict()[k], v)
                   for k, v in src.state_dict().items())
        assert same == (name == "old")


def test_device_default_and_mesh_refusal():
    with pytest.raises(NotImplementedError, match="scale-out slice"):
        SimCLRTrainer(CFG32, SimCLRTrainConfig(), mesh=object(), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimCLRTrainer(CFG32, SimCLRTrainConfig())
