"""Tolerances and fixtures shared by the tests that hold ``repro_torch`` to
``repro``.

bf16 output may differ by one bf16 ulp (the two frameworks may round an
intermediate at another place); f32 output by 2e-5 absolute, the kernel
suite's f32 bar (``tests/test_kernels.py``).  ``reference_stack`` imports
the reference's model stack for the tests of the serving path, and puts
``tools/`` on the import path for ``route_check``.
"""

import contextlib
import pathlib
import sys

import numpy as np
import pytest

_TOOLS = str(pathlib.Path(__file__).resolve().parents[1] / "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

F32_ATOL = 2e-5
SWAP_GAP = 1e-2  # a route may differ only where the reference's k-th and (k+1)-th probabilities are closer


def _bf16_order(a: np.ndarray) -> np.ndarray:
    """bf16 values (held exactly in f32) as integers in value order."""
    bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def assert_bf16_within_ulp(got, want, ulps: int = 1) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    steps = np.abs(_bf16_order(got) - _bf16_order(want))
    assert steps.max(initial=0) <= ulps, f"{int(steps.max())} bf16 ulps apart"


def assert_f32_close(got, want) -> None:
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=F32_ATOL
    )


def condition_attention(cfg, params_np):
    """A parameter tree of the reference (numpy leaves) with each attention
    block's wq and wk scaled as if drawn at fan-in d_model: by sqrt(heads /
    d_model) and sqrt(kv_heads / d_model); an MLA block's w_uq and w_uk as if
    drawn at fan-in over their latent rank: by sqrt(heads / q_lora_rank) and
    sqrt(heads / kv_lora_rank).  The reference draws them with
    fan-in over the heads dim, so without qk_norm a score spreads over tens
    and attention is nearly one-hot: bf16 rounding then moves the weights
    of near-tied keys far, in each framework's own way, and a bf16 bar
    between them shows little.  Measured on the CPU, granite-smoke
    (PRNGKeys 0-3): the port's bf16 outputs 1.5-4.0e-2 of the largest
    value from the reference's on the reference's weights, 0.66-0.91e-2 on
    these; olmo, yi and qwen1.5 (PRNGKeys 0-2) 1.3-6.8e-2 and 0.71-1.12e-2;
    deepseek (PRNGKeys 0-2, the reference's routes replayed) logits
    2.4-3.0e-2 and 1.10-1.64e-2, the port's own MoE choices differing at
    gaps up to 1.2e-2 and 2.3e-3.  Both frameworks get the same scaled
    weights."""
    import jax

    scale = {"wq": (cfg.num_heads / cfg.d_model) ** 0.5, "wk": (cfg.num_kv_heads / cfg.d_model) ** 0.5}
    if cfg.mla is not None:
        scale = {"w_uq": (cfg.num_heads / cfg.mla.q_lora_rank) ** 0.5,
                 "w_uk": (cfg.num_heads / cfg.mla.kv_lora_rank) ** 0.5}

    def one(path, a):
        name = getattr(path[-1], "key", None)
        return (np.asarray(a, np.float32) * scale[name]).astype(a.dtype) if name in scale else a

    return jax.tree_util.tree_map_with_path(one, params_np)


# ---------------------------------------------------------------------------
# the reference model stack, importable through a stub ``repro.dist``
# ---------------------------------------------------------------------------

_STACK = ("repro.dist", "repro.models", "repro.launch", "repro.runtime")


def _in_stack(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in _STACK)


def _dist_stub() -> dict:
    """``repro.dist`` as far as the reference's serving path reads it: no
    mesh, no sharding hints, and a plan that repeats no kv heads."""
    import contextlib
    import dataclasses
    import types

    @dataclasses.dataclass(frozen=True)
    class ParallelPlan:
        kv_repeat: int = 1
        mesh: object = None

    hints = types.ModuleType("repro.dist.hints")
    hints.hint = lambda x, *a, **k: x
    hints.mesh_context = lambda *a, **k: contextlib.nullcontext()
    sharding = types.ModuleType("repro.dist.sharding")
    sharding.ParallelPlan = ParallelPlan
    sharding.NULL_PLAN = ParallelPlan()
    sharding.make_plan = lambda *a, **k: ParallelPlan()
    sharding.batch_axes_for = lambda *a, **k: None
    dist = types.ModuleType("repro.dist")
    dist.hints, dist.sharding = hints, sharding
    return {"repro.dist": dist, "repro.dist.hints": hints, "repro.dist.sharding": sharding}


@pytest.fixture
def reference_stack(monkeypatch):
    """The reference's ``Model``, ``BatchServer``, configs and training path
    (``build_train_step``, ``init_opt_state``, ``apply_update``, ``Trainer``,
    the checkpoint functions and ``build_lm_loader``), imported with a stub
    ``repro.dist`` (ROADMAP F-ref-1: the package does not exist).

    On teardown every module of the stack leaves ``sys.modules`` (and the
    ``repro`` package's attributes), so other test files of the same worker
    still find ``repro.dist`` missing and skip as before."""
    import sys
    import types

    import repro

    before = {k for k in sys.modules if _in_stack(k)}
    for name in before:
        monkeypatch.delitem(sys.modules, name)
    for name, mod in _dist_stub().items():
        monkeypatch.setitem(sys.modules, name, mod)
    try:
        from repro import ckpt, optim
        from repro.configs import get_smoke_config
        from repro.data import build_lm_loader
        from repro.launch.steps import build_train_step
        from repro.models import Model
        from repro.runtime import Trainer, TrainerConfig
        from repro.runtime.server import BatchServer

        yield types.SimpleNamespace(
            Model=Model, BatchServer=BatchServer, get_smoke_config=get_smoke_config,
            build_train_step=build_train_step, init_opt_state=optim.init_opt_state,
            apply_update=optim.apply_update, OptConfig=optim.OptConfig, lr_schedule=optim.lr_schedule,
            Trainer=Trainer, TrainerConfig=TrainerConfig, save_checkpoint=ckpt.save_checkpoint,
            load_checkpoint=ckpt.load_checkpoint, CheckpointManager=ckpt.CheckpointManager,
            latest_step=ckpt.latest_step, build_lm_loader=build_lm_loader,
        )
    finally:
        for name in [k for k in sys.modules if _in_stack(k) and k not in before]:
            del sys.modules[name]
        for attr in ("dist", "models", "launch", "runtime"):
            if f"repro.{attr}" not in before:
                repro.__dict__.pop(attr, None)


@contextlib.contextmanager
def reference_routes(monkeypatch):
    """Records, for each MoE layer the reference runs and in call order, its
    router probabilities (B, S, E) into ``.probs`` and its top-k experts
    (B, S, k) into ``.idx``, as ``tools/route_check.py`` records
    the port's: the reference's own routing lines
    (``repro/models/moe.py:65-67``) beside its ``apply_moe``, read out of
    its traced code by an ordered ``jax.debug.callback``.  Needs
    ``reference_stack``; the records are complete when the block ends."""
    import types

    import jax
    import jax.numpy as jnp
    from repro.models import moe as ref_moe

    log = types.SimpleNamespace(probs=[], idx=[])
    real = ref_moe.apply_moe

    def keep(probs, idx):
        log.probs.append(np.asarray(probs))
        log.idx.append(np.asarray(idx).astype(np.int64))

    def apply_moe(cfg, p, x):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
        jax.debug.callback(keep, probs, jax.lax.top_k(probs, cfg.moe.experts_per_token)[1], ordered=True)
        return real(cfg, p, x)

    monkeypatch.setattr(ref_moe, "apply_moe", apply_moe)
    yield log
    jax.effects_barrier()
    monkeypatch.setattr(ref_moe, "apply_moe", real)


# ---------------------------------------------------------------------------
# prefill at positions that restart, repeat or reverse
# ---------------------------------------------------------------------------


def odd_positions(s: int) -> np.ndarray:
    """(3, s) int32 rows the kernel's index mask would get wrong: two packed
    prompts that restart at 0, every position twice, and reversed."""
    half = s // 2
    return np.stack([
        np.concatenate([np.arange(half), np.arange(s - half)]),
        np.arange(s) // 2,
        np.arange(s)[::-1],
    ]).astype(np.int32)


def prefill_at_positions(ref, monkeypatch, arch: str, seed: int = 0):
    """``arch``'s smoke config in f32, the reference's seed-``seed`` weights
    in both packages, one prefill of three seeded prompts at
    ``odd_positions``: ``(port, reference)``, each ``(logits, cache)`` as
    numpy.  A MoE config replays the reference's expert choices (so a
    near-tie broken the other way cannot move other tokens)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import route_check
    import torch

    from repro_torch import configs as port_configs
    from repro_torch.models import Model, params_from_reference

    ref_cfg = dataclasses.replace(ref.get_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="float32")
    ref_model = ref.Model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    positions = odd_positions(24)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, positions.shape, dtype=np.int32)
    with reference_routes(monkeypatch) as routes:
        want = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions)})
        want = jax.tree.map(np.asarray, want)
    with route_check.RouteRecorder(replay=routes.idx if cfg.moe else None):
        got = Model(cfg).prefill(params, {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(positions)})
    return jax.tree.map(lambda t: t.numpy(), got), want
