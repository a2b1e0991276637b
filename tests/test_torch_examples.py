"""The torch twins of the reference's four examples, held to the reference
on the CPU (``--device cpu``; the card runs them in ``chip_smoke.py``).

- ``quickstart``: the same batches, in input order.
- ``imagenet_pipeline``: both examples run whole; the twin prints the
  reference's lines (numbers and paths aside) section for section, each
  section that consumes the dataset counts every image, every batch its
  consumer decodes with ``dequant_normalize`` equals the reference's
  ``dequant_normalize`` (Pallas, interpret mode) on the same uint8 batch
  within one bf16 ulp, as does every ``device_decode`` batch against the
  reference's ``dequant_normalize_augment``, and the exported trace holds
  the reference's span names.
- ``serve_llm``: ``serve`` on the reference's smoke-Yi parameters (f32,
  PRNGKey 0), converted, gives the reference's ``BatchServer`` token ids
  for the example's prompts at its sizes, as ``tests/test_torch_server.py``
  holds the servers.
- ``train_lm``: 2 layers at d_model 64, 4 steps; a second run on the same
  directory resumes at the saved step with the checkpoint's parameters.
"""

import ast
import dataclasses
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from torch_parity import assert_bf16_within_ulp, reference_stack  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def twin(name: str):
    return _load(ROOT / "examples_torch" / f"{name}.py", f"examples_torch_{name}")


def test_quickstart_delivers_the_references_batches():
    ref = _load(ROOT / "examples" / "quickstart.py", "examples_quickstart")  # builds its pipeline on import
    with ref.pipeline.auto_stop():
        want = [np.asarray(b["images"]) for b in ref.pipeline]
    got = twin("quickstart").main(["--device", "cpu"])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.uint8 and tuple(g.shape) == (16, 64, 64, 3)
        np.testing.assert_array_equal(g.numpy(), w)


def _lines(text: str) -> list[str]:
    """Printed lines with numbers and paths masked and runs of spaces
    collapsed: what the two examples print alike."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"(?<![\w])/[^\s']+", "PATH", line)
        line = re.sub(r"\d+(\.\d+)?", "N", line)
        out.append(re.sub(r"\s+", " ", line).strip())
    return out


def _span_names(path: pathlib.Path) -> tuple[set, set]:
    """(span names that do not depend on timing, categories) of a Chrome
    trace: a queue's get_wait/put_wait span appears only when it waited."""
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("ph") != "M"]
    return ({e["name"] for e in spans if not e["name"].startswith(("get_wait", "put_wait"))},
            {e.get("cat") for e in spans} - {None})


def test_imagenet_pipeline_matches_the_reference_section_by_section(monkeypatch, capsys, tmp_path):
    from repro.kernels import ops as ref_ops

    monkeypatch.setenv("REPRO_TRACE_PATH", str(tmp_path / "ref_trace.json"))
    _load(ROOT / "examples" / "imagenet_pipeline.py", "examples_imagenet_pipeline").main()
    ref_out = capsys.readouterr().out

    example = twin("imagenet_pipeline")
    k2, k1 = [], []

    def recorded(fn, log):
        def call(x, *args, **kwargs):
            y = fn(x, *args, **kwargs)
            log.append((x.clone(), args, kwargs, y))
            return y
        return call

    monkeypatch.setattr(example, "dequant_normalize", recorded(example.dequant_normalize, k2))
    monkeypatch.setattr(port_ops, "dequant_normalize_augment", recorded(port_ops.dequant_normalize_augment, k1))
    monkeypatch.setenv("REPRO_TRACE_PATH", str(tmp_path / "port_trace.json"))
    mean = jnp.asarray(example.MEAN, jnp.float32)
    std = jnp.asarray(example.STD, jnp.float32)
    d = tmp_path / "run"
    d.mkdir()
    reports = []
    for report in example.run(str(d), "cpu"):
        reports.append(report)
        section = report["section"]
        if "images" in report:
            assert report["images"] == example.FRAMES, section
        calls, log = (k1, "dequant_normalize_augment") if section == "hot_path" else (k2, "dequant_normalize")
        if section in ("hot_path", "local", "remote", "http", "peers", "projection", "per_file"):
            # each batch as the reference's kernel decodes it; the hot path's first call is the
            # warm-up on zeros, as in the reference
            assert sum(x.shape[0] for x, *_ in calls) == example.FRAMES + (example.BATCH if section == "hot_path" else 0)
            x = np.concatenate([x.numpy() for x, *_ in calls])
            got = torch.cat([y for *_, y in calls])
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == (len(x), 3, *example.HW)
            want = getattr(ref_ops, log)(jnp.asarray(x), mean, std, use_pallas="interpret")
            assert_bf16_within_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        else:
            assert not calls, section
        calls.clear()
    port_out = capsys.readouterr().out

    assert [r["section"] for r in reports] == ["pack", "local", "read_path", "hot_path", "remote", "http",
                                                "peers", "warm_restart", "projection", "per_file", "mploader"]
    assert reports[0] == {"section": "pack", "samples": 96, "shards": 4}
    assert reports[3]["host_decode_images"] == 96
    assert reports[4]["spans"] > 0
    assert reports[8]["bytes_skipped"] > 0
    # the reference's hot-path line also points at a benchmark of the JAX package
    want_lines = [re.sub(r" \(toy size — .*\)$", "", line) for line in _lines(ref_out)]
    assert _lines(port_out) == want_lines
    assert "SPDL (local shards, mmap): N images in" in " ".join(_lines(port_out))
    ref_names, ref_cats = _span_names(tmp_path / "ref_trace.json")
    names, cats = _span_names(tmp_path / "port_trace.json")
    assert cats == ref_cats == {"queue", "shard", "stage", "transfer"}
    assert ref_names <= names, ref_names - names


def _reference_prompts() -> list[str]:
    """The prompt list literal of ``examples/serve_llm.py``."""
    tree = ast.parse((ROOT / "examples" / "serve_llm.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign) and n.targets[0].id == "prompts")
    return ast.literal_eval(node.value)


def test_serve_llm_serves_the_reference_examples_tokens(reference_stack, capsys):  # noqa: F811
    ref = reference_stack
    example = twin("serve_llm")
    assert example.PROMPTS == _reference_prompts()
    ref_cfg = dataclasses.replace(ref.get_smoke_config("yi-6b"), dtype="float32")
    cfg = dataclasses.replace(port_configs.get_smoke_config("yi-6b"), dtype="float32")
    ref_params = ref.Model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    kw = {"batch_size": 4, "prompt_len": 16, "max_new": 8}  # the example's
    want = ref.BatchServer(ref_cfg, ref_params, **kw).generate(example.PROMPTS)
    got = example.serve(cfg, params, example.PROMPTS, device="cpu", **kw)

    assert [r.prompt for r in got] == [r.prompt for r in want] == example.PROMPTS
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(len(r.token_ids) == kw["max_new"] for r in got)
    assert len({tuple(r.token_ids) for r in got}) > 1
    assert capsys.readouterr().out.splitlines() == [f"{r.prompt!r} -> tokens {r.token_ids}" for r in want]


def test_train_lm_resumes_at_the_saved_step(monkeypatch, capsys, tmp_path):
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.tree import tree_items

    example = twin("train_lm")
    monkeypatch.setattr(example, "CKPT_EVERY", 2)  # the example saves every 100 steps
    argv = ["--device", "cpu", "--d-model", "64", "--layers", "2", "--steps", "4", "--seq-len", "32",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    first = example.main(argv)
    assert [h["step"] for h in first["history"]] == [4]
    assert np.isfinite(first["history"][-1]["loss"])
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke" in out and "start_step=0" in out and "data-wait fraction" in out

    trainer, pipe, sampler = example.build(example.parse_args(argv))
    assert trainer.step == 4 and "start_step=4" in capsys.readouterr().out
    saved = load_checkpoint(str(tmp_path), trainer.params, trainer.opt_state)
    assert saved["step"] == 4
    for (path, got), (_, want) in zip(tree_items(trainer.params), tree_items(saved["params"])):
        assert torch.equal(got, want), path
    second = example.train(trainer, pipe, sampler, 2)
    assert trainer.step == 6 and [h["step"] for h in second["history"]] == [6]
