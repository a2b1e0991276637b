"""The port's ``Trainer`` on the CPU, and held to the reference's.

The loop behaves as ``tests/test_trainer.py`` requires of the reference
(the loss falls over 30 steps, a restart from a checkpoint resumes with
equal parameters and the sampler's epoch, ``health`` and ``tuning_hint``
report), and four logged steps on the same parameters and documents give
the reference's losses (f32 smoke config, within 2e-5) and parameters.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import CheckpointableSampler, SyntheticTokenDataset, build_lm_loader  # noqa: E402
from repro_torch.models import params_from_reference, tree_to_numpy  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import reference_stack  # noqa: E402,F401

SHAPE = ShapeConfig("tiny_train", seq_len=32, global_batch=4, kind="train")
ARCH = "qwen3-0.6b"


def make_parts(tmp_path, *, ckpt_every=5, seed=0, dataset=SyntheticTokenDataset, loader=build_lm_loader, **kw):
    cfg = get_smoke_config(ARCH)
    ds = dataset(200, vocab=cfg.vocab_size, min_len=8, max_len=32, seed=3)
    sampler = CheckpointableSampler(len(ds), batch_size=4, seed=seed)
    pipe, sampler = loader(
        ds, seq_len=SHAPE.seq_len, batch_size=SHAPE.global_batch, sampler=sampler, num_threads=4, **kw,
    )
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=ckpt_every, log_every=5)
    return cfg, pipe, sampler, tcfg


def test_train_loss_decreases(tmp_path):
    cfg, pipe, sampler, tcfg = make_parts(tmp_path, device="cpu")
    trainer = Trainer(cfg, SHAPE, tcfg=tcfg, device="cpu")
    with pipe.auto_stop():
        out = trainer.fit(pipe, steps=30, sampler=sampler)
    hist = out["history"]
    assert trainer.step == 30 and [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, f"no learning: {first} -> {last}"


def test_checkpoint_restart_resumes_exactly(tmp_path):
    cfg, pipe, sampler, tcfg = make_parts(tmp_path, ckpt_every=10, device="cpu")
    trainer = Trainer(cfg, SHAPE, tcfg=tcfg, device="cpu")
    with pipe.auto_stop():
        trainer.fit(pipe, steps=10, sampler=sampler)
    params_at_10 = tree_to_numpy(trainer.params)
    opt_at_10 = tree_to_numpy(trainer.opt_state)

    # a new process's state: resume from disk
    cfg2, pipe2, sampler2, _ = make_parts(tmp_path, device="cpu")
    resumed = Trainer.from_checkpoint(cfg2, SHAPE, sampler=sampler2, tcfg=tcfg, device="cpu")
    assert resumed.step == 10
    for (k, a), (_, b) in zip(tree_items(tree_to_numpy(resumed.params)), tree_items(params_at_10)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for (k, a), (_, b) in zip(tree_items(tree_to_numpy(resumed.opt_state)), tree_items(opt_at_10)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert sampler2.state_dict()["epoch"] == sampler.state_dict()["epoch"]
    with pipe2.auto_stop():
        out = resumed.fit(pipe2, steps=5, sampler=sampler2)
    assert resumed.step == 15
    assert np.isfinite(out["history"][-1]["loss"])


def test_health_reports_starvation_signal(tmp_path):
    cfg, pipe, sampler, tcfg = make_parts(tmp_path, device="cpu")
    trainer = Trainer(cfg, SHAPE, tcfg=tcfg, device="cpu")
    with pipe.auto_stop():
        trainer.fit(pipe, steps=6, sampler=sampler)
        h = trainer.health()
        assert 0.0 <= h["data_wait_frac"] <= 1.0 and isinstance(h["starved"], bool)
        hint = trainer.tuning_hint(pipe)
        assert isinstance(hint, str) and hint
        trainer.data_wait_s, trainer.step_s = 3.0, 1.0  # a loader that cannot keep up
        assert trainer.health() == {"data_wait_frac": 0.75, "starved": True}
        assert "bottleneck stage is" in trainer.tuning_hint(pipe)


def test_four_steps_match_the_reference_trainer(reference_stack, tmp_path):  # noqa: F811
    """The slice as a whole: loader, trainer, train step and AdamW, f32.
    The reference reads its collate path (F-ref-3), the port its slab path."""
    from repro.data import SyntheticTokenDataset as JTokens
    from repro.data.sampler import CheckpointableSampler as JSampler

    ref = reference_stack
    ref_cfg = dataclasses.replace(ref.get_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dict(ckpt_every=100, log_every=1)

    ds = JTokens(200, vocab=cfg.vocab_size, min_len=8, max_len=32, seed=3)
    ref_pipe, ref_sampler = ref.build_lm_loader(
        ds, seq_len=SHAPE.seq_len, batch_size=SHAPE.global_batch, num_threads=4,
        sampler=JSampler(len(ds), batch_size=4, seed=0), zero_copy=False,
    )
    ref_trainer = ref.Trainer(ref_cfg, SHAPE, tcfg=ref.TrainerConfig(ckpt_dir=str(tmp_path / "r"), **tcfg))
    _, pipe, sampler, _ = make_parts(tmp_path, device="cpu")
    trainer = Trainer(cfg, SHAPE, tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "p"), **tcfg), device="cpu")
    trainer.params = params_from_reference(jax.tree.map(np.asarray, ref_trainer.params), device="cpu")
    trainer.opt_state = init_opt_state(trainer.opt_cfg, trainer.params)

    with ref_pipe.auto_stop():
        want = ref_trainer.fit(ref_pipe, steps=4, sampler=ref_sampler)["history"]
    with pipe.auto_stop():
        got = trainer.fit(pipe, steps=4, sampler=sampler)["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "loss_lm", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= 2e-5 * max(1.0, abs(w[k])), (g["step"], k, g[k], w[k])
    want_params = dict(tree_items(jax.tree.map(np.asarray, ref_trainer.params)))
    for k, a in tree_items(tree_to_numpy(trainer.params)):
        np.testing.assert_allclose(a, want_params[k], atol=2e-5, rtol=0, err_msg=k)
