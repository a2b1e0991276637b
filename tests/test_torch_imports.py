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
    assert "repro_torch.data.loader" in loaded
    assert [m for m in loaded if _is_reference(m) or m.split(".")[0] == "jax"] == []


@pytest.mark.parametrize("path", ["chip_smoke.py", *sorted(
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
    "data/codec.py", "data/dataset.py", "data/sampler.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_match_the_reference_byte_for_byte(rel):
    """A change to a copy is a deliberate act: change both, or move the
    module out of this list with the reason."""
    assert filecmp.cmp(SRC / "repro" / rel, PORT / rel, shallow=False)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch, tmp_path):
    """``DeviceTransfer()`` and ``build_image_loader(ds)`` mean CUDA; with no
    card they raise rather than pick the CPU."""
    from repro_torch.data import SyntheticImageDataset, build_image_loader
    from repro_torch.data.transfer import DeviceTransfer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTransfer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_image_loader(SyntheticImageDataset.materialize(tmp_path, 2, hw=(8, 8)))
    assert DeviceTransfer("cpu").device == torch.device("cpu")
