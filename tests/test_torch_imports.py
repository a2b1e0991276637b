"""The port stands alone: it imports torch and numpy, never JAX and
nothing of the JAX package, and its copied modules do not drift.
"""

import ast
import filecmp
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def test_every_port_module_imports_without_jax_or_the_reference():
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m, v in sys.modules.items() if v is not None)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("repro_torch.data.loader", "repro_torch.optim.optimizer", "repro_torch.ckpt.checkpoint",
                   "repro_torch.runtime.trainer", "repro_torch.launch.train", "repro_torch.data.shards.peer",
                   "repro_torch.data.shards.__main__", "repro_torch.data.baselines", "repro_torch.core.health"):
        assert module in loaded
    assert [m for m in loaded if _is_reference(m) or m.split(".")[0] == "jax"] == []


@pytest.mark.parametrize("path", ["chip_smoke.py", "tools/route_check.py", *sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
)])
def test_no_source_names_jax_or_the_reference_in_an_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] != "jax", f"{path} imports {name}"
            assert not _is_reference(name), f"{path} imports {name}"


COPIED = [
    "core/_compat.py", "core/errors.py", "core/trace.py", "core/stats.py",
    "core/queues.py", "core/engine.py", "core/pipeline.py", "core/builder.py",
    "core/metrics.py", "core/health.py", "core/chaos.py", "core/autotune.py",
    "data/codec.py", "data/dataset.py", "data/packing.py", "data/sampler.py", "data/tokenizer.py",
    "data/baselines.py",
    # data/shards/testing.py is not a copy: its origin fixture reads only the
    # requested byte range, where the reference's reads the whole shard for
    # each range request (tests/test_torch_shards.py holds their answers equal)
    *sorted(str(p.relative_to(SRC / "repro")) for p in (SRC / "repro" / "data" / "shards").glob("*.py")
            if p.name != "testing.py"),
    *sorted(str(p.relative_to(SRC / "repro")) for p in (SRC / "repro" / "configs").glob("*.py")),
]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_match_the_reference_byte_for_byte(rel):
    """A change to a copy is a deliberate act: change both, or move the
    module out of this list with the reason."""
    assert filecmp.cmp(SRC / "repro" / rel, PORT / rel, shallow=False)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch, tmp_path):
    """``DeviceTransfer()``, ``build_image_loader(ds)``, ``Model.init`` and
    ``BatchServer`` mean CUDA; with no card they raise rather than pick the
    CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticImageDataset, build_image_loader
    from repro_torch.data.transfer import DeviceTransfer
    from repro_torch.models import Model
    from repro_torch.runtime import BatchServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTransfer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_image_loader(SyntheticImageDataset.materialize(tmp_path, 2, hw=(8, 8)))
    assert DeviceTransfer("cpu").device == torch.device("cpu")
    model = Model(get_smoke_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(model.cfg, params)
    assert BatchServer(model.cfg, params, device="cpu").device == torch.device("cpu")


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``params_from_reference``, ``build_lm_loader``, ``build_train_step``,
    ``Trainer`` and the training launcher mean CUDA unless given the CPU;
    with no card they raise."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenDataset, build_lm_loader
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import params_from_reference
    from repro_torch.runtime import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32), "step": np.zeros((), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(tree)
    on_cpu = params_from_reference(tree, device="cpu")
    assert on_cpu["step"].dtype == torch.int32 and on_cpu["step"].dim() == 0
    ds = SyntheticTokenDataset(8, vocab=64, min_len=8, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lm_loader(ds, seq_len=16, batch_size=2)
    cfg, shape = get_smoke_config("qwen3-0.6b"), ShapeConfig("t", 16, 2, "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, shape)
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, shape, tcfg=tcfg)
    assert Trainer(cfg, shape, tcfg=tcfg, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main()
