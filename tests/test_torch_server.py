"""The port's ``BatchServer`` emits the reference's tokens.

Both servers run an f32 smoke config (qwen3, mamba2, granite-moe, jamba
and deepseek, whose MoE layers route in f32 on both sides; olmo, yi and
qwen1.5, the other dense decoders) on the same carried
weights: the reference's through its jitted steps (with the stub
``repro.dist``), the port's on the CPU, its prefill attention in
``flash_attention``'s plain version and its SSD scan in ``ssd_scan``'s.  Prompts of mixed lengths, one longer than ``prompt_len``
(cut to it), and a count that leaves a ragged tail batch; greedy decoding
must give the same token ids, for the same prompts, in the same order.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.runtime import BatchServer  # noqa: E402
from torch_parity import reference_stack  # noqa: E402,F401

PROMPTS = [
    "hello world",
    "data loading is",
    "x",
    "a prompt that runs well past the thirty-two bytes the server keeps",
    "SPDL",
    "0123456789",
    "the tail batch holds three",
]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "granite-moe-1b-a400m", "jamba-1.5-large-398b",
                                  "deepseek-v3-671b", "olmo-1b", "yi-6b", "qwen1.5-110b"])
def test_greedy_tokens_match_the_reference(reference_stack, arch):  # noqa: F811
    ref = reference_stack
    ref_cfg = dataclasses.replace(ref.get_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="float32")
    ref_params = ref.Model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")

    kw = {"batch_size": 4, "prompt_len": 32, "max_new": 6}
    want = ref.BatchServer(ref_cfg, ref_params, **kw).generate(PROMPTS)
    got = BatchServer(cfg, params, device="cpu", **kw).generate(PROMPTS)

    assert [r.prompt for r in got] == [r.prompt for r in want] == PROMPTS
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert all(len(r.token_ids) == kw["max_new"] for r in got)
    assert len({tuple(r.token_ids) for r in got}) > 1  # the prompts steer the output


def test_a_prompt_length_off_the_kernel_tile_serves_the_reference_tokens(reference_stack):  # noqa: F811
    """prompt_len 20 is no multiple of the flash kernel's tile: the port pads
    q, k and v to 64 inside the prefill and serves the reference's tokens."""
    ref = reference_stack
    ref_cfg = dataclasses.replace(ref.get_smoke_config("qwen3-0.6b"), dtype="float32")
    cfg = dataclasses.replace(port_configs.get_smoke_config("qwen3-0.6b"), dtype="float32")
    ref_params = ref.Model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")

    kw = {"batch_size": 4, "prompt_len": 20, "max_new": 6}
    want = ref.BatchServer(ref_cfg, ref_params, **kw).generate(PROMPTS)
    got = BatchServer(cfg, params, device="cpu", **kw).generate(PROMPTS)

    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert len({tuple(r.token_ids) for r in got}) > 1


def test_a_finished_server_is_freed_with_its_last_reference():
    """The request pipeline's objects hold one another in reference cycles,
    so a stage that captured the server would keep it, and its parameters
    (on the card, a model's worth of memory), alive until the collector
    runs; the stages capture only what they read."""
    cfg = dataclasses.replace(port_configs.get_smoke_config("qwen3-0.6b"), dtype="float32")
    server = BatchServer(cfg, Model(cfg).init(0, "cpu"), device="cpu", batch_size=2, prompt_len=8, max_new=2)
    assert len(server.generate(PROMPTS[:3])) == 3
    ref = weakref.ref(server)
    gc.disable()
    try:
        del server
        assert ref() is None
    finally:
        gc.enable()
