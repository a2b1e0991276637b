"""How far the port's bf16 serving path drifts from the reference's, seed
by seed: the spread behind the 2e-2 bar of
``test_torch_models.py::test_prefill_and_decode_match_the_reference``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_parity_spread.py [arch] [seeds]

For each seed: the reference's smoke model initialized from
``PRNGKey(seed)``, carried to the port, fed the same seeded prompt and
four forced tokens; prints the largest |port - reference| over the
largest |reference| for the prefill logits, each cache entry after
prefill, each decode step's logits and each cache entry after decode.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import _dist_stub

B, S, STEPS = 2, 24, 4  # as in test_torch_models.py


def _rel(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def spread(arch: str, seed: int) -> list[float]:
    from repro.configs import get_smoke_config
    from repro.models import Model as RefModel
    from repro_torch import configs as port_configs
    from repro_torch.models import Model, params_from_reference

    ref_cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="bfloat16")
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    model = Model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    forced = rng.integers(0, cfg.vocab_size, (STEPS, B, 1), dtype=np.int32)

    def caches(cache, want_cache):
        return [_rel(blk[k], want_blk[k]) for seg, want_seg in zip(cache, want_cache)
                for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]) for k in sorted(blk)
                if k not in ("k", "v")]  # k/v are compared by the test itself

    want_logits, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, seq_cap=S + STEPS)
    errs = [_rel(logits, want_logits), *caches(cache, want_cache)]
    pad = [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]  # the reference server grows k/v to capacity
    want_cache = [{"blocks": [{k: jnp.pad(x, pad) if k in ("k", "v") else x for k, x in blk.items()}
                              for blk in seg["blocks"]]} for seg in want_cache]
    for t in range(STEPS):
        want_logits, want_cache = ref_model.decode_step(ref_params, want_cache, jnp.asarray(forced[t]), jnp.int32(S + t))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(forced[t]), S + t)
        errs.append(_rel(logits, want_logits))
    return errs + caches(cache, want_cache)


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "mamba2-780m"
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    sys.modules.update(_dist_stub())  # the reference model stack needs a repro.dist
    for seed in range(seeds):
        errs = spread(arch, seed)
        print(f"{arch} seed {seed}: max {max(errs):.4f}  " + " ".join(f"{e:.4f}" for e in errs), flush=True)


if __name__ == "__main__":
    main()
