"""How far rounding alone moves the f32 gradients of ``chip_smoke.py``'s
``train_check`` step (full width, 2 layers, two packed rows of 512, TF32
off), on the card: every gradient leaf at the weights W against the same
step at W * (1 + 2^-23 s), s a seeded +-1 an element (each weight moved by
about one f32 ulp), on the seed-0 weights and on ``condition_attention``'s.
Where one ulp in the weights moves a leaf by more than ``train_check``'s
1e-4 of its largest value, a card-against-CPU check of that leaf at that
bar measures the weights' conditioning, not the port: the two sides round
every product differently by as much.

    python3 probes_torch/train_conditioning.py [arch ...]   # default olmo-1b

Then the same weights at the config's full depth, one packed row of
4,096 tokens (``train``'s sequence), one step in f32 and one in bf16: the
loss and the gradients' global norm, to see whether the norm grows with
depth on either set of weights.

Needs a CUDA card.  One JSON line an arch and weights: the loss and grad
norm at W, and each leaf's largest difference over its largest |value|
(``leaf_rel``) with the largest of them (``max_leaf_rel``); then one line
an arch, weights and dtype at full depth."""

import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(archs: list[str], dev: torch.device = torch.device("cuda", 0)) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_items, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32")
        batch = cs.train_batch(cfg, cs.CHECK_BATCH, cs.CHECK_SEQ, seed=6)
        for weights in ("seed 0", "conditioned"):
            params = Model(cfg).init(seed=0, device=dev)
            if weights == "conditioned":
                cs.condition_attention(cfg, params)
            gen = torch.Generator(device=dev).manual_seed(1)
            moved = tree_map(lambda t: t * (1 + 2.0**-23 * (torch.randint(
                0, 2, t.shape, generator=gen, device=dev, dtype=t.dtype) * 2 - 1)), params)
            names = [k for k, _ in tree_items(params)]
            m0, g0, _ = cs.one_train_step(cfg, dev, params, batch)
            m1, g1, _ = cs.one_train_step(cfg, dev, moved, batch)
            rel = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in zip(names, g1, g0)}
            print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers, "weights": weights, "dtype": cfg.dtype,
                              "perturbation": "each weight x (1 + 2^-23 s), s = +-1 seeded",
                              "loss": m0["loss"], "loss_moved": m1["loss"], "grad_norm": m0["grad_norm"],
                              "grad_norm_moved": m1["grad_norm"], "max_leaf_rel": max(rel.values()),
                              "leaf_rel": rel}), flush=True)
            del params, moved
            cs.release_card()
        for weights in ("seed 0", "conditioned"):
            for dtype in ("float32", "bfloat16"):
                full = dataclasses.replace(get_config(arch), dtype=dtype)
                params = Model(full).init(seed=0, device=dev)
                if weights == "conditioned":
                    cs.condition_attention(full, params)
                m, _, _ = cs.one_train_step(full, dev, params, cs.train_batch(full, 1, cs.TRAIN_SEQ, seed=6))
                print(json.dumps({"arch": full.name, "layers": full.num_layers, "weights": weights, "dtype": dtype,
                                  "seq": cs.TRAIN_SEQ, "rows": 1, **m}), flush=True)
                del params
                cs.release_card()
    print(cs.phase_device(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["olmo-1b"])
