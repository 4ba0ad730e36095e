#!/usr/bin/env python3
"""Read the bf16 gap between the port's and the reference's LM logits on
the CPU, the reading behind ``tests/test_torch_lm.py``'s bf16 test.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_bf16_lm_gap.py

Like the parity tests it imports both stacks.  For qwen3-14b and
mamba2-1.3b at ``reduced()`` (bf16), for five (weights, tokens) seeds:
the test's redrawn weights cast to bf16 on the reference's side and
converted, a 37-token prompt's prefill and 8 decode steps; per step the
largest |port − reference| of the logits, that over the step's largest
|logit| (what the test holds to 2e-2), and the largest ratio of the gap to
the elementwise allowance ``2e-2 + 2e-2·|reference|`` (above 1 where the
elementwise form of the pin would fail).  Then one Mamba layer of the
reference in bf16, jitted against eager, its largest gap and |output|.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

SEEDS = ((0, 4), (9, 10), (1, 2), (3, 5), (7, 7))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget
    from repro.models import decode_step as jdecode
    from repro.models import init_model as jinit
    from repro.models import layers as JL
    from repro.models import prefill as jprefill
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import decode_step, prefill
    from test_torch_lm import _np_tree, _t, _tokens
    torch.set_num_threads(1)
    for arch in ("qwen3-14b", "mamba2-1.3b"):
        for seed, tseed in SEEDS:
            jcfg, tcfg = jget(arch).reduced(), get_config(arch).reduced()
            tree = _np_tree(jinit(jax.random.PRNGKey(seed), jcfg)[0], seed)
            tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                          tree)
            jp = jax.tree_util.tree_map(jnp.asarray, tree)
            tp = lm_params_from_jax(tree, tcfg, device="cpu")
            prompt, gen = 37, 8
            toks = _tokens(2, prompt + gen, jcfg.vocab_size, seed=tseed)
            lt, ct = prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                             prompt + gen)
            lj, cj = jprefill(jp, jcfg,
                              {"tokens": jnp.asarray(toks[:, :prompt])},
                              prompt + gen)
            rows = []
            for i in range(prompt, prompt + gen + 1):
                a = lt.float().numpy()
                b = np.asarray(lj, np.float32)
                d = np.abs(a - b)
                rows.append((d.max(), d.max() / np.abs(b).max(),
                             (d / (2e-2 + 2e-2 * np.abs(b))).max()))
                if i < prompt + gen:
                    lt, ct = decode_step(tp, tcfg, _t(toks[:, i]), ct)
                    lj, cj = jdecode(jp, jcfg, jnp.asarray(toks[:, i]), cj)
            gap, rel, ratio = (max(r[j] for r in rows) for j in range(3))
            print(f"{arch} seeds ({seed}, {tseed}): prefill + {gen} decode "
                  f"steps, largest gap {gap:.4f}, of the largest |logit| "
                  f"{rel:.3e}, of the elementwise allowance {ratio:.3f}")
    jcfg = jget("mamba2-1.3b").reduced()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jnp.bfloat16),
        _np_tree(JL.mamba_init(jax.random.PRNGKey(3), jcfg)[0], 3))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    u = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 37, jcfg.d_model)).astype(jnp.bfloat16))
    eager, _ = JL.mamba_apply(jp, u, jcfg, mode="train")
    jitted, _ = jax.jit(lambda p, x: JL.mamba_apply(p, x, jcfg,
                                                    mode="train"))(jp, u)
    e, j = np.asarray(eager, np.float32), np.asarray(jitted, np.float32)
    print(f"reference mamba layer, bf16, jit against eager: largest gap "
          f"{np.abs(e - j).max():.4f}, largest |output| {np.abs(e).max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
