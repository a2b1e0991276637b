"""How far rounding alone moves a smoke config's f32 prefill logits at the
long shapes' CPU cut (2 rows of 4,096 tokens through ``prefill_32k``'s
step, past the reference's 2,048-key threshold), on the CPU: the port's
logits at the weights W against the port's at W * (1 + 2^-23 s), s a
seeded -1, 0 or +1 an element (each weight moved by at most one f32 ulp),
and against the reference's prefill at W; on the seed-0 weights and on
``condition_attention``'s.  Where one ulp in the weights moves the logits
by as much as the port differs from the reference, a 2e-5 bar between the
two measures the weights' conditioning, not the port.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_parity_conditioning.py [arch ...]   # default internvl2-2b

Needs the reference (jax); imports its model stack through
``tests/torch_parity.py``'s stub ``repro.dist``.  One JSON line an arch
and weights: ``vs_reference`` and ``ulp_moved`` (two draws of s), each the
largest difference over the reference's largest |logit| on the real
vocabulary."""

import dataclasses
import json
import sys

import numpy as np

B, S = 2, 4096


def main(archs: list[str]) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import torch_parity
    from repro_torch import configs as port_configs
    from repro_torch.models import params_from_reference
    from repro_torch.tree import tree_map

    sys.modules.update(torch_parity._dist_stub())
    from repro.configs import get_smoke_config
    from repro.models import Model as RefModel

    for arch in archs:
        ref_model = RefModel(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
        seed0 = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="float32")
        rng = np.random.default_rng(3)
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}
        if cfg.vis_prefix_len:
            batch["vis_embed"] = rng.standard_normal((B, cfg.vis_prefix_len, cfg.d_model)).astype(np.float32)
        prefill, _ = torch_parity.long_steps(cfg, "prefill_32k", S, B)
        v = cfg.vocab_size
        for weights, params_np in (("seed 0", seed0), ("condition_attention", torch_parity.condition_attention(
                cfg, seed0))):
            want, _ = ref_model.prefill(jax.tree.map(jnp.asarray, params_np),
                                        {k: jnp.asarray(x) for k, x in batch.items()})
            want = np.asarray(want)[..., :v]
            params = params_from_reference(params_np, device="cpu")
            logits = prefill(params, batch)[0][..., :v].numpy()
            moved = []
            for draw in range(2):
                gen = torch.Generator().manual_seed(draw)
                nudged = tree_map(lambda t: t * (1 + (torch.randint(0, 3, t.shape, generator=gen) - 1) * 2.0**-23)
                                  if t.is_floating_point() else t, params)
                moved.append(float(np.abs(prefill(nudged, batch)[0][..., :v].numpy() - logits).max()
                                   / np.abs(want).max()))
            print(json.dumps({"arch": arch, "weights": weights, "rows": B, "seq": S,
                              "vs_reference": float(np.abs(logits - want).max() / np.abs(want).max()),
                              "ulp_moved": moved}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["internvl2-2b"])
