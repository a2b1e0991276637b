"""``chip_smoke.py``'s AdamW update check run on the CPU at qwen1.5-smoke
size, the "card" side on the CPU too.

On the card, ``train qwen1.5-110b`` captures step 1's ``adamw_bf16`` update
of a few parts of the parameter tree (``UpdateCapture``: every layer's QKV
biases, layer 0's wq, the first rows of layer 0's w_down and of the
embedding) and holds the parameters and both bf16 moments after it to the
same update run on the host (``adamw_update_check``), one bf16 ulp an
element.  Here one ``build_train_step`` step of qwen1.5-smoke (QKV biases
drawn, as on the card) runs under the capture: the optimizer's own update
must pass the check, with the clip idle and with it scaling the gradients,
and two planted faults must fail it: β1 and β2 swapped in the update, and
the clip scale taken from the captured parts' own gradient norm in place
of the whole tree's, under a ``clip_norm`` below both norms so that either
scale is active.
"""

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import OptConfig, apply_update, global_norm, init_opt_state  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLIP = 1e-3  # under the captured parts' gradient norm, so both scales are active
IDLE = 1e3  # over the whole tree's (5.2 here), so the clip leaves the gradients as they are


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _captured(monkeypatch, clip: float | None = None, update=None, optimizer: str | None = None):
    """One train step of qwen1.5-smoke under ``UpdateCapture``: 2 packed
    rows of 32 tokens, seed-0 weights with the QKV biases drawn (seed 3)."""
    cfg = get_smoke_config("qwen1.5-110b")
    if optimizer is not None:
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    if clip is not None:
        monkeypatch.setattr(steps, "opt_config_for", lambda c: OptConfig(kind=c.optimizer, clip_norm=clip))
    bundle = steps.build_train_step(cfg, ShapeConfig("t", 32, 2, "train"), grad_accum=1, device="cpu")
    params = Model(cfg).init(seed=0, device="cpu")
    cs.draw_zero_leaves(params, 3)
    state = init_opt_state(bundle.opt_cfg, params)
    with cs.UpdateCapture(cs.ADAMW_CHECK_PICKS, update) as cap:
        bundle.fn(params, state, cs.packed_batch(cfg.vocab_size, 2, 32, seed=6))
    assert steps.apply_update is apply_update  # the capture put the optimizer's update back
    return cap


@pytest.mark.parametrize("clip", [IDLE, CLIP])
def test_the_optimizer_s_update_passes_the_check(monkeypatch, clip):
    cap = _captured(monkeypatch, clip)
    out = cs.adamw_update_check(cap)
    assert out["over"] == {}, out["over"]
    assert out["kind"] == "adamw_bf16" and out["step"] == 1
    assert set(out["leaves"]) == set(cs.ADAMW_CHECK_PICKS)
    assert out["clip_active"] == (clip == CLIP), (out["grad_norm"], out["clip_norm"])


def test_the_check_fails_with_beta1_and_beta2_swapped(monkeypatch):
    def swapped(opt_cfg, params, grads, state):
        return apply_update(dataclasses.replace(opt_cfg, b1=opt_cfg.b2, b2=opt_cfg.b1), params, grads, state)

    out = cs.adamw_update_check(_captured(monkeypatch, update=swapped))
    assert set(out["over"]) == set(out["leaves"])
    assert all(row["m"]["max_ulps"] > 1 and row["v"]["max_ulps"] > 1 for row in out["over"].values())


def test_the_check_fails_on_the_sub_tree_s_norm(monkeypatch):
    cap = _captured(monkeypatch, CLIP)
    sub = float(global_norm([b["g"] for b in cap.before.values()]))
    assert CLIP < sub < cap.metrics["grad_norm"]
    out = cs.adamw_update_check(cap, grad_norm=sub)
    assert out["clip_active"] and set(out["over"]) == set(out["leaves"])


def test_the_check_refuses_f32_moments(monkeypatch):
    with pytest.raises(AssertionError, match="must be bf16"):
        cs.adamw_update_check(_captured(monkeypatch, optimizer="adamw"))
