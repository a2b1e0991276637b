"""The port's mesh-free planning names held to the reference's.

``abstract_params`` (parameters on the meta device for the reference's
``ShapeDtypeStruct``s), ``Model.batch_spec``, ``abstract_opt_state``,
``logical_specs``, ``resolve_pspec``, ``param_pspecs`` and ``shard_info``
for all ten full-size configs, at every ``SHAPES`` entry that
``shape_applicable`` admits, against the reference's (imported through the
stub ``repro.dist`` of ``reference_stack``); nothing is allocated on either
side.  ``build_step`` dispatches on the shape's kind as the reference's does.

Beside them, the oracles of ``kernels/ref.py`` against the reference's on
the same seeded inputs: f32 within 2e-5, bf16 within one bf16 ulp.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import params as port_params  # noqa: E402
from repro_torch.optim import OptConfig, abstract_opt_state, init_opt_state  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import assert_bf16_within_ulp, assert_f32_close, reference_stack  # noqa: E402,F401

ARCHS = port_configs.all_archs()
OPT_KINDS = ("adamw", "adamw_bf16", "sgdm", "adafactor")
# three rules dicts over the configs' logical axes: data over embed and
# model over the rest; tuples of mesh axes, with "model" wanted twice by
# experts and ffn; and the dedup case of tests/test_dist_and_elastic.py
RULES = [
    {"embed": "data", "vocab_in": "model", "vocab": "model", "heads": "model", "kv_heads": "model",
     "ffn": "model", "experts": "model", "expert_embed": "data", "expert_ffn": "model",
     "ssd_heads": "model", "d_inner": "model", "conv_dim": "model", "layers": None},
    {"embed": ("pod", "data"), "vocab": ("data", "model"), "vocab_in": "model", "heads": "model",
     "kv_heads": None, "ffn": ("model",), "experts": ("pod", "model"), "expert_embed": "data",
     "expert_ffn": ("data", "model"), "ssd_heads": ("model",), "d_inner": "model", "conv_dim": "pod",
     "layers": "pod"},
    {"embed": ("data",), "ffn": ("data", "model")},
]
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _ref_items(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _port_spec_items(tree, path: str = "") -> dict:
    """(keystr path → leaf) of a port tree whose leaves are tuples (the
    containers are dicts and lists)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _port_spec_items(tree[k], f"{path}[{k!r}]").items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _port_spec_items(t, f"{path}[{i}]").items()}
    return {path: tree}


def _meta_items(tree) -> dict:
    out = {}
    for path, t in tree_items(tree):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    return out


def _struct_items(tree) -> dict:
    return {p: (tuple(s.shape), str(s.dtype)) for p, s in _ref_items(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_batch_spec_and_opt_state_match_the_reference(reference_stack, arch):  # noqa: F811
    from repro.optim import optimizer as ref_optim
    from repro.configs import SHAPES, get_config, shape_applicable

    ref_cfg, cfg = get_config(arch), port_configs.get_config(arch)
    ref_model, model = reference_stack.Model(ref_cfg), Model(cfg)
    ref_abstract = ref_model.abstract_params()
    abstract = model.abstract_params()
    got = _meta_items(abstract)
    assert got == _struct_items(ref_abstract)
    assert model.param_count() == ref_model.param_count() == sum(int(np.prod(s)) for s, _ in got.values())
    shapes = [s for s in SHAPES.values() if shape_applicable(ref_cfg, s)[0]]
    assert len(shapes) >= 3
    for shape in shapes:
        assert _meta_items(model.batch_spec(port_configs.SHAPES[shape.name])) == \
            _struct_items(ref_model.batch_spec(shape)), shape.name
    for kind in OPT_KINDS:
        want = _struct_items(ref_optim.abstract_opt_state(ref_optim.OptConfig(kind=kind), ref_abstract))
        assert _meta_items(abstract_opt_state(OptConfig(kind=kind), abstract)) == want, kind


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_pspecs_and_shard_info_match_the_reference(reference_stack, arch):  # noqa: F811
    from jax.sharding import PartitionSpec

    from repro.configs import get_config
    from repro.models import params as ref_params

    ref_defs = reference_stack.Model(get_config(arch)).param_defs()
    defs = Model(port_configs.get_config(arch)).param_defs()
    axes = lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)  # noqa: E731
    assert _port_spec_items(port_params.logical_specs(defs)) == _ref_items(ref_params.logical_specs(ref_defs), axes)
    used = {a for spec in _port_spec_items(port_params.logical_specs(defs)).values() for a in spec} - {None}
    assert used <= set(RULES[0]), used - set(RULES[0])  # every logical axis has a rule in RULES[0]
    for rules in RULES:
        want = {p: tuple(s) for p, s in _ref_items(
            ref_params.param_pspecs(ref_defs, rules), lambda x: isinstance(x, PartitionSpec)).items()}
        got = _port_spec_items(port_params.param_pspecs(defs, rules))
        assert got == want
        assert all(type(s) is tuple for s in got.values())
        for mesh_shape in MESHES:
            assert port_params.shard_info(defs, rules, mesh_shape) == \
                ref_params.shard_info(ref_defs, rules, mesh_shape)


def test_resolve_pspec_gives_the_references_entries(reference_stack):  # noqa: F811
    from repro.models.params import resolve_pspec as ref_resolve

    cases = [
        (("embed", "ffn"), {"embed": ("data",), "ffn": ("data", "model")}),  # the dedup case
        (("embed", "ffn"), {"embed": ("pod", "data"), "ffn": ("data", "model")}),
        (("vocab", "embed"), {"vocab": "model", "embed": "model"}),  # taken: replicated
        ((None, "heads", None), {"heads": "model"}),  # trailing None dropped
        (("experts", "embed", "ffn"), {"experts": ("pod", "model"), "embed": "data", "ffn": "model"}),
        (("embed",), {}),
        ((), {"embed": "data"}),
    ]
    for axes, rules in cases:
        got = port_params.resolve_pspec(axes, rules)
        assert got == tuple(ref_resolve(axes, rules)), (axes, rules)
    assert port_params.resolve_pspec(("embed", "ffn"), cases[0][1]) == ("data", "model")
    assert port_params.resolve_pspec((None, "heads", None), {"heads": "model"}) == (None, "model")


def test_abstract_params_allocate_nothing():
    """DeepSeek-V3's 671 B parameters and its AdamW state, on meta."""
    cfg = port_configs.get_config("deepseek-v3-671b")
    model = Model(cfg)
    abstract = model.abstract_params()
    state = abstract_opt_state(OptConfig(kind="adamw"), abstract)
    leaves = [t for _, t in tree_items(abstract)] + [t for _, t in tree_items(state)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for _, t in tree_items(abstract)) == model.param_count() > 6.7e11
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


def test_build_step_dispatches_on_the_shape_kind():
    cfg = port_configs.get_smoke_config("qwen3-0.6b")
    shape = port_configs.ShapeConfig
    train = build_step(cfg, shape("t", 16, 2, "train"), device="cpu", grad_accum=2)
    prefill = build_step(cfg, shape("p", 16, 2, "prefill"), device="cpu")
    decode = build_step(cfg, shape("d", 16, 2, "decode"), device="cpu")
    assert [b.shape.kind for b in (train, prefill, decode)] == ["train", "prefill", "decode"]
    assert train.opt_cfg is not None and prefill.opt_cfg is None and decode.opt_cfg is None
    params = train.model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    logits, cache = prefill.fn(params, {"tokens": tokens}, seq_cap=17)
    step_logits, _ = decode.fn(params, cache, logits.argmax(-1, keepdim=True), 16)
    assert step_logits.shape == logits.shape == (2, cfg.padded_vocab)
    _, state, metrics = train.fn(params, init_opt_state(train.opt_cfg, params), {"tokens": tokens, "labels": tokens})
    assert int(state["step"]) == 1 and torch.isfinite(metrics["loss"])


# ---------------------------------------------------------------------------
# kernels/ref.py: the oracles
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want.astype(jax.numpy.float32))
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:
        assert_bf16_within_ulp(got.float().numpy(), want)
    else:
        assert_f32_close(got.numpy(), want)


def _bf16_ulp_of_largest(want) -> float:
    """One bf16 ulp at the largest |value| of ``want``."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,hd,causal", [
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 2, 48, 80, 64, True),  # q right-aligned to the keys
    (2, 3, 3, 40, 40, 16, False),
    (1, 4, 1, 17, 33, 128, True),
])
def test_flash_attention_ref_matches_the_references(dtype, b, h, hkv, sq, skv, hd, causal):
    import jax.numpy as jnp

    from repro.kernels import ref

    rng = np.random.default_rng(sq * skv + hd)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = port_ref.flash_attention_ref(*(torch.from_numpy(a).to(td) for a in (q, k, v)), causal=causal)
    want = ref.flash_attention_ref(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal)
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want)
        return
    # bf16: both round p to bf16 before p @ v, and the two frameworks' f32
    # softmax differ in the last f32 bit, which now and then rounds one p the
    # other way (1 of 24,576 at the second shape; with the reference's p the
    # outputs are equal).  An output near zero then moves by a few of its own
    # ulps (29 ulps of a 1e-3 value there), so the bar is one ulp at the
    # output's largest value, absolute
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_bf16_ulp_of_largest(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_the_references(reference_stack, dtype):  # noqa: F811
    import jax.numpy as jnp

    from repro.kernels import ref

    rng = np.random.default_rng(7)
    b, l, h, p, g, n = 2, 24, 4, 8, 2, 16
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    bb, cc = (rng.standard_normal((b, l, g, n), dtype=np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    for init in (None, h0):
        y, hf = port_ref.ssd_ref(torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(a),
                                 torch.from_numpy(bb).to(td), torch.from_numpy(cc).to(td),
                                 None if init is None else torch.from_numpy(init))
        wy, whf = ref.ssd_ref(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bb, jd),
                              jnp.asarray(cc, jd), None if init is None else jnp.asarray(init))
        assert y.dtype == td and hf.dtype == torch.float32
        _close(y, wy)
        _close(hf, whf)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequant_normalize_refs_match_the_references(out_dtype):
    import jax.numpy as jnp

    from repro.kernels import ref

    rng = np.random.default_rng(3)
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    tm, ts, jm, js = torch.from_numpy(mean), torch.from_numpy(std), jnp.asarray(mean), jnp.asarray(std)
    td, jd = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    x = rng.integers(0, 256, (3, 11, 13, 3), dtype=np.uint8)
    got = port_ref.dequant_normalize_ref(torch.from_numpy(x), tm, ts, out_dtype=td)
    assert got.dtype == td and got.is_contiguous()
    _close(got, ref.dequant_normalize_ref(jnp.asarray(x), jm, js, out_dtype=jd))
    flip = np.array([1, 0, 3], np.int32)
    crop = np.array([[2, 1], [-4, 99], [5, 6]], np.int32)  # the last two clamped in-bounds
    for xs in (x, rng.uniform(0, 1, x.shape).astype(np.float32)):
        for kw in ({}, {"flip": flip}, {"flip": flip, "crop": crop, "out_hw": (6, 7)}, {"crop": crop, "out_hw": (11, 9)}):
            got = port_ref.dequant_normalize_augment_ref(torch.from_numpy(xs), tm, ts, out_dtype=td,
                                                         **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                                            for k, v in kw.items()})
            want = ref.dequant_normalize_augment_ref(jnp.asarray(xs), jm, js, out_dtype=jd,
                                                     **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                                        for k, v in kw.items()})
            assert got.dtype == td and got.is_contiguous()
            _close(got, want)
