#!/usr/bin/env python3
"""How far the port's bf16 serving paths drift apart at full width, and how
far a known fault moves them: the readings behind ``chip_smoke.py``'s
phase 11 limits (``SELF_TOL_BF16``).

    python3 scripts/torch_serve_drift.py [--arch qwen3-14b mamba2-1.3b]
                                         [--out build/serve_drift.json]
    python3 scripts/torch_serve_drift.py --zoo [--arch ARCH ...]
    python3 scripts/torch_serve_drift.py --modal

For each arch at full width in bf16, ``chip_smoke.serve_gaps`` (prefill
against forward at the last prompt position, one decode step against
forward at the next; max |diff| and max |diff| / (1 + |forward|) of the
logits, prompt 200) under:

* ``sound``: the port as it is, on phase 11's weights (seed 11), and
  ``sound_seed0`` on ``run_serve``'s (seed 0);
* ``plain``: the arch's kernel swapped for its plain version in every path
  (qwen3-14b: ``layers._sdpa``, probabilities rounded to bf16, as the
  reference computes all three paths; mamba2-1.3b: ``ssd_apply_ref``), to
  tell bf16 rounding from the kernel;
* known faults, each put in by patching ``repro_torch.models.layers`` for
  one reading and taken out after it:

  - qwen3-14b ``decode_rope_off_by_one``: decode rotates q and k for
    position idx + 1;
  - qwen3-14b ``cache_without_rope``: prefill writes un-rotated keys into
    the cache;
  - qwen3-14b ``attention_sees_next_key``: train/prefill attention lets
    each query see one key past the causal frontier;
  - mamba2-1.3b ``scan_decay_doubled``: the scan decays by exp(2 dt A);
  - mamba2-1.3b ``conv_tail_one_step_early``: prefill leaves the conv
    tail one token early.

With ``--zoo``, the readings behind phase 20's limits instead
(``chip_smoke.zoo_gaps``): each arch of ``chip_smoke.ZOO_LAYERS`` (or those
named) at its phase-20 depth on its weights (seed 11), the MoE archs with
``moe_dropless``, in each dtype of ``chip_smoke.ZOO_SELF_DTYPES``: ``sound``,
and for the MoE archs two known faults that touch only one-token calls
(decode steps), as a fault of the decode path would:

  - ``gates_not_renormalised``: the top-k gates are used as the softmax
    gives them, without dividing by their sum;
  - ``dense_residual_left_out`` (arctic-480b): a ``moe+dense`` block adds
    the MoE's output alone.

With ``--modal``, the readings behind phase 21's limits
(``chip_smoke.MODAL_SELF_TOL_BF16``): phi-3-vision-4.2b and whisper-tiny at
full width and depth in bf16 on phase 21's weights and stub inputs (seed
11), ``sound`` and with known faults of their decode paths:

  - phi-3-vision-4.2b ``decode_position_without_patches``: a decode step
    rotates q and k at its text position, as if the cache held no patches;
  - phi-3-vision-4.2b ``decode_rope_off_by_one`` (as qwen3-14b's);
  - whisper-tiny ``cross_attention_sees_half_the_frames``: a decode step's
    cross-attention reads only the first 750 frames' K/V;
  - whisper-tiny ``cross_kv_of_the_first_layer``: every decoder layer's
    decode step reads layer 0's cross K/V.

Needs a CUDA device; prints one line a reading and writes them as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def patched(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def qwen3_patches() -> dict:
    import torch
    from repro_torch.models import layers

    rope, attention_apply = layers.rope, layers.attention_apply

    def attention(q_offset):
        def fn(q, k, v, causal=True, window=0):
            s = q.shape[1]
            mask = layers.causal_mask(s, s, q_offset, window, device=q.device)
            return layers._sdpa(q, k, v, mask, k.shape[2])
        return fn

    def rope_off_by_one(x, positions, theta):
        if positions.shape[1] == 1:
            positions = positions + 1
        return rope(x, positions, theta)

    def cache_without_rope(p, x, cfg, *, mode="train", cache=None, window=0):
        out, new = attention_apply(p, x, cfg, mode=mode, cache=cache,
                                   window=window)
        if mode == "prefill":
            b, s, _ = x.shape
            pos = torch.arange(s, device=x.device)[None].expand(b, s)
            with patched(layers, "rope", lambda x, positions, theta: x):
                _, k, _ = layers._qkv(p, x, cfg, pos)
            new["k"][:, :s] = k
        return out, new

    return {"plain": [("gqa_flash_attention", attention(0))],
            "decode_rope_off_by_one": [("rope", rope_off_by_one)],
            "cache_without_rope": [("attention_apply", cache_without_rope)],
            "attention_sees_next_key": [("gqa_flash_attention",
                                         attention(1))]}


def mamba2_patches() -> dict:
    import torch
    from repro_torch.kernels.ssd_scan import ssd_apply_ref
    from repro_torch.models import layers

    ssd_apply, mamba_apply = layers.ssd_apply, layers.mamba_apply

    def conv_tail_early(p, u, cfg, *, mode="train", cache=None):
        out, new = mamba_apply(p, u, cfg, mode=mode, cache=cache)
        if mode == "prefill":
            b, s, _ = u.shape
            cw = cfg.ssm_conv_width
            _, xBC, _ = layers._mamba_split(cfg, u @ p["in_proj"])
            xpad = torch.cat([xBC.new_zeros((b, cw, xBC.shape[-1])), xBC], 1)
            new["conv"].copy_(xpad[:, s:s + cw - 1])   # inputs s-cw .. s-2
        return out, new

    return {"plain": [("ssd_apply", lambda x, dt, A, B, C, chunk=128:
                       ssd_apply_ref(x, dt, A, B, C))],
            "scan_decay_doubled": [("ssd_apply",
                                    lambda x, dt, A, B, C, chunk=128:
                                    ssd_apply(x, dt, 2 * A, B, C,
                                              chunk=chunk))],
            "conv_tail_one_step_early": [("mamba_apply", conv_tail_early)]}


def moe_patches(cfg) -> dict:
    """Faults of the MoE feed-forward that only one-token calls see."""
    import torch
    from repro_torch.models import layers, transformer

    moe_apply, block_apply = layers.moe_apply, transformer.block_apply

    def unnormalised(p, x, cfg_):
        if x.shape[1] != 1:
            return moe_apply(p, x, cfg_)
        # The renormalised gates times their sum are the softmax's top k.
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True,
                         stable=True)[0][:, :cfg_.experts_per_token]
        y, aux = moe_apply(p, x, cfg_)
        return y * top.sum(-1).reshape(x.shape[:2] + (1,)).to(y.dtype), aux

    def without_dense(p, x, cfg_, kind, **kw):
        if kind[1] == "moe+dense" and x.shape[1] == 1:
            kind = (kind[0], "moe")
        return block_apply(p, x, cfg_, kind, **kw)

    out = {"gates_not_renormalised": [(layers, "moe_apply", unnormalised)]}
    if cfg.dense_residual_d_ff:
        out["dense_residual_left_out"] = [(transformer, "block_apply",
                                           without_dense)]
    return out


def modal_patches(cfg) -> dict:
    """Faults of the VLM's and the encoder-decoder's decode paths
    (one-token calls only)."""
    from repro_torch import models
    from repro_torch.models import layers, transformer

    rope = layers.rope
    if cfg.arch_type == "vlm":
        def shifted(by):
            def fn(x, positions, theta):
                if positions.shape[1] == 1:
                    positions = positions + by
                return rope(x, positions, theta)
            return fn
        return {"decode_position_without_patches":
                [(layers, "rope", shifted(-cfg.num_patch_tokens))],
                "decode_rope_off_by_one": [(layers, "rope", shifted(1))]}
    cross = layers.cross_attention_apply
    decode_step = transformer.decode_step

    def half_the_frames(p, x, enc_kv, cfg_):
        if x.shape[1] == 1:
            f = enc_kv[0].shape[1] // 2
            enc_kv = (enc_kv[0][:, :f], enc_kv[1][:, :f])
        return cross(p, x, enc_kv, cfg_)

    def first_layer_kv(params, cfg_, tokens, caches):
        first = caches["cross"][0]
        wrong = {"self": caches["self"],
                 "cross": [first] * len(caches["cross"])}
        logits, new = decode_step(params, cfg_, tokens, wrong)
        return logits, {"self": new["self"], "cross": caches["cross"]}

    return {"cross_attention_sees_half_the_frames":
            [(layers, "cross_attention_apply", half_the_frames)],
            "cross_kv_of_the_first_layer":
            [(models, "decode_step", first_layer_kv)]}


def drift_modal_arch(arch: str) -> dict:
    """Phase 21's bf16 readings of ``arch``: sound and with its decode
    faults, on phase 21's weights and stub inputs."""
    import contextlib as cl
    import torch
    from chip_smoke import (modality_batch, self_consistency_inputs,
                            serve_gaps)
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    cfg = get_config(arch)
    params, toks = self_consistency_inputs(dev, cfg)
    extra = modality_batch(cfg, toks.shape[0], seed=11, device=dev)
    readings = {}
    for name, fns in {"sound": [], **modal_patches(cfg)}.items():
        with cl.ExitStack() as stack:
            for module, attr, fn in fns:
                stack.enter_context(patched(module, attr, fn))
            readings[f"bfloat16 {name}"] = serve_gaps(params, cfg, toks,
                                                      extra)
    del params, toks, extra
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "readings": readings}


def drift_zoo_arch(arch: str) -> dict:
    """Phase 20's readings of ``arch``: sound and with the MoE faults, in
    each of its checked dtypes (the float32 weights the bf16 ones cast
    up, as phase 20 takes them)."""
    import torch
    from chip_smoke import ZOO_SELF_DTYPES, zoo_config, zoo_gaps
    dev = torch.device("cuda")
    cfg = zoo_config(arch, dropless=True)
    patches = moe_patches(cfg) if cfg.num_experts else {}
    readings = {}
    for name, fns in {"sound": [], **patches}.items():
        with contextlib.ExitStack() as stack:
            for module, attr, fn in fns:
                stack.enter_context(patched(module, attr, fn))
            for dtype, g in zoo_gaps(dev, arch,
                                     ZOO_SELF_DTYPES[arch]).items():
                readings[f"{dtype} {name}"] = g
    return {"arch": arch, "readings": readings}


def drift_arch(arch: str) -> dict:
    import torch
    from chip_smoke import self_consistency_inputs, serve_gaps
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, layers

    dev = torch.device("cuda")
    cfg = get_config(arch)
    params, toks = self_consistency_inputs(dev, cfg)
    readings = {"sound": serve_gaps(params, cfg, toks)}
    patches = {name: [(layers, attr, fn) for attr, fn in fns]
               for name, fns in (qwen3_patches() if arch == "qwen3-14b"
                                 else mamba2_patches()).items()}
    for name, fns in patches.items():
        with contextlib.ExitStack() as stack:
            for module, attr, fn in fns:
                stack.enter_context(patched(module, attr, fn))
            readings[name] = serve_gaps(params, cfg, toks)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = init_model(rng.PRNGKey(0, dev), cfg, device=dev)
    readings["sound_seed0"] = serve_gaps(params, cfg, toks)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "readings": readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=None)
    ap.add_argument("--zoo", action="store_true",
                    help="phase 20's archs and depths (see the note)")
    ap.add_argument("--modal", action="store_true",
                    help="phase 21's archs (see the note)")
    ap.add_argument("--out", default=str(ROOT / "build" / "serve_drift.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_drift: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    results = {"card": card, "archs": []}
    if args.arch is None:
        from chip_smoke import AUDIO, VLM, ZOO_LAYERS
        args.arch = (list(ZOO_LAYERS) if args.zoo
                     else [VLM, AUDIO] if args.modal
                     else ["qwen3-14b", "mamba2-1.3b"])
    for arch in args.arch:
        r = (drift_zoo_arch(arch) if args.zoo
             else drift_modal_arch(arch) if args.modal else drift_arch(arch))
        results["archs"].append(r)
        for name, g in r["readings"].items():
            label = name if args.zoo or args.modal else f"bf16 {name}"
            print(f"{arch} {label}: prefill vs forward {g['prefill']:.4f}"
                  f" (rel {g['prefill_rel']:.4f}), decode vs forward "
                  f"{g['decode']:.4f} (rel {g['decode_rel']:.4f}), |logits| "
                  f"up to {g['scale']:.2f}, finite {g['finite']} on {card}",
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
