"""The port's optimizers and checkpoints held to the reference's.

Optimizers: the same parameters and seeded gradients go through the
reference's ``apply_update`` and the port's for 3 steps, every kind; the
parameters, the state, ``lr`` and ``grad_norm`` are compared after each
(f32 within 2e-5 absolute and relative; bf16 leaves within one bf16 ulp).

Checkpoints: the on-disk format is the reference's, so each package
restores what the other wrote, bit for bit, bf16 and the int32 ``step``
included; retention and the atomic publish behave as the reference's
(``tests/test_optim_ckpt_server.py``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
import jax.numpy as jnp  # noqa: E402

from repro_torch.ckpt import CheckpointManager, latest_step, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.models import params_from_reference, tree_to_numpy  # noqa: E402
from repro_torch.optim import OptConfig, apply_update, init_opt_state, lr_schedule  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import assert_bf16_within_ulp, reference_stack  # noqa: E402,F401

KINDS = ["adamw", "adamw_bf16", "sgdm", "adafactor"]


def _tree_np(seed: int) -> dict:
    """A small parameter tree: matrices, a stacked 3-D leaf, a vector and a
    bf16 leaf, nested in dicts and a list, as a model's."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {
        "w": f(4, 6),
        "segments": [{"blocks": [{"stack": f(2, 3, 5), "scale": f(5)}]}],
        "half": f(3, 4).astype(ml_dtypes.bfloat16),
        "head": {},
    }


def _flat_np(tree) -> dict:
    """keystr → numpy leaf of a reference tree, through JAX's own flattening."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if want.dtype.name == "bfloat16":
        assert_bf16_within_ulp(got, np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-5, rtol=2e-5, err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_three_steps_of_each_optimizer_match_the_reference(reference_stack, kind):  # noqa: F811
    ref = reference_stack
    ref_cfg = ref.OptConfig(kind=kind, lr=0.05, warmup_steps=2, total_steps=10)
    cfg = OptConfig(kind=kind, lr=0.05, warmup_steps=2, total_steps=10)
    ref_params = jax.tree.map(jnp.asarray, _tree_np(0))
    ref_state = ref.init_opt_state(ref_cfg, ref_params)
    params = params_from_reference(_tree_np(0), device="cpu")
    state = init_opt_state(cfg, params)
    assert {k: (v.shape, str(v.dtype)) for k, v in _flat_np(jax.tree.map(np.asarray, ref_state)).items()} == {
        k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in tree_items(state)
    }
    for step in range(3):
        grads_np = _tree_np(10 + step)
        ref_params, ref_state, ref_m = ref.apply_update(ref_cfg, ref_params, jax.tree.map(jnp.asarray, grads_np), ref_state)
        params, state, m = apply_update(cfg, params, params_from_reference(grads_np, device="cpu"), state)
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(ref_m[name]), rtol=2e-6, err_msg=name)
        got = dict(tree_items(tree_to_numpy({"p": params, "s": state})))
        want = _flat_np({"p": ref_params, "s": ref_state})
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], f"step {step + 1} {k}")
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32


def test_lr_schedule_matches_the_reference(reference_stack):  # noqa: F811
    ref_cfg = reference_stack.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 1000):
        want = float(reference_stack.lr_schedule(ref_cfg, jnp.int32(s)))
        got = float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def _state_trees(ref, kind="adamw"):
    """Reference params and a stepped optimizer state, as numpy trees."""
    ref_cfg = ref.OptConfig(kind=kind)
    params = jax.tree.map(jnp.asarray, _tree_np(1))
    state = ref.init_opt_state(ref_cfg, params)
    params, state, _ = ref.apply_update(ref_cfg, params, jax.tree.map(jnp.asarray, _tree_np(2)), state)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _bits(tree) -> dict:
    """keystr → (dtype name, raw bytes) of a tree of tensors or numpy
    arrays: equal for two trees that hold the same bits."""
    out = {}
    for k, v in tree_items(tree):
        if isinstance(v, torch.Tensor):
            name = str(v.dtype).replace("torch.", "")
            v = v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            name = v.dtype.name
        out[k] = (name, np.ascontiguousarray(v).tobytes())
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_the_reference_writes_and_the_port_loads_bit_for_bit(reference_stack, tmp_path, kind):  # noqa: F811
    ref = reference_stack
    params_np, state_np = _state_trees(ref, kind)
    ref.save_checkpoint(tmp_path, 7, params_np, state_np, sampler_state={"epoch": 1, "cursor": 9}, extra={"a": 1})
    params_t = params_from_reference(params_np, device="cpu")
    state_t = init_opt_state(OptConfig(kind=kind), params_t)
    out = load_checkpoint(tmp_path, params_t, state_t)
    assert out["step"] == 7 and out["sampler"] == {"epoch": 1, "cursor": 9} and out["extra"] == {"a": 1}
    assert _bits(out["params"]) == _bits(params_np)
    assert _bits(out["opt_state"]) == _bits(state_np)
    assert out["opt_state"]["step"].dtype == torch.int32 and out["opt_state"]["step"].dim() == 0


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16"])
def test_the_port_writes_and_the_reference_loads_bit_for_bit(reference_stack, tmp_path, kind):  # noqa: F811
    ref = reference_stack
    params_np, state_np = _state_trees(ref, kind)
    params_t = params_from_reference(params_np, device="cpu")
    state_t = params_from_reference(state_np, device="cpu")
    save_checkpoint(tmp_path, 3, params_t, state_t, sampler_state={"epoch": 2, "cursor": 0})
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["dtypes"]["params['half']"] == "bfloat16" and meta["dtypes"]["opt['step']"] == "int32"
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert z["params['half']"].dtype == np.uint16
        assert "params['segments'][0]['blocks'][0]['stack']" in z.files
    out = ref.load_checkpoint(tmp_path, params_np, state_np)
    assert out["step"] == 3 and out["sampler"] == {"epoch": 2, "cursor": 0}
    assert _bits(jax.tree.map(np.asarray, out["params"])) == _bits(params_t)
    assert _bits(jax.tree.map(np.asarray, out["opt_state"])) == _bits(state_t)


def test_checkpoint_manager_retention(tmp_path):
    params = {"w": torch.zeros(2)}
    mgr = CheckpointManager(tmp_path, every=1, keep=2)
    for step in (1, 2, 3, 4):
        assert mgr.maybe_save(step, params, {"step": torch.tensor(step, dtype=torch.int32)})
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert latest_step(tmp_path) == 4
    assert not CheckpointManager(tmp_path, every=2).maybe_save(5, params, {})


def test_checkpoint_atomic_no_partial(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros(4)})
    assert not list(tmp_path.glob(".tmp_*"))
    assert (tmp_path / "step_00000001" / "meta.json").exists()
    assert latest_step(tmp_path / "missing") is None


def test_the_snapshot_is_taken_before_the_caller_moves_on(tmp_path):
    """The manager copies leaves to the host on the caller's thread: an
    in-place update right after ``maybe_save`` does not reach the file."""
    params = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(tmp_path, every=1, keep=1)
    mgr.maybe_save(1, params, {"step": torch.tensor(1, dtype=torch.int32)})
    params["w"].add_(100.0)
    mgr.wait()
    out = load_checkpoint(tmp_path, {"w": torch.empty(6)})
    assert torch.equal(out["params"]["w"], torch.arange(6, dtype=torch.float32))
    assert mgr.snapshot_ms >= 0.0
