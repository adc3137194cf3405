"""Batched serving: prefill + greedy decode loop (the port of
``repro.launch.serve``, all six families).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --reduced --batch 4 --prompt 32 --gen 16 --device cpu

``--arch`` takes any id of ``configs.list_archs()``: granite-3-2b,
qwen1.5-32b, qwen3-14b, granite-20b, zamba2-2.7b (hybrid: Mamba2 states and
the shared blocks' K/V), llava-next-mistral-7b (vlm: the prompt carries
stub patch embeddings from ``data.tokens.add_modality_stub`` before its
tokens, so the cache needs ``--cache`` >= patches + prompt + gen rows and
decoding starts at position patches + prompt), deepseek-v3-671b (MLA,
whose decode cache is the
latent ``{"ckv", "kr"}``), llama4-scout-17b-a16e, whisper-tiny (encdec:
the prompt carries stub frames from ``data.tokens.add_modality_stub``) and
rwkv6-3b (ssm: the recurrent state is the cache). Runs on
the CUDA card by default (``--device cuda``), where the prefill attention
launches the flash_attention kernel. Weights and the prompt are random,
from ``--seed``. Reports tokens/s.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data import tokens as DATA
from repro_torch.models import param as PM
from repro_torch.models.registry import Model


# names of a layer's cache that cross whole from the prefill: the hybrid's
# recurrent Mamba2 states and whisper's cross-attention K/V over the frames
WHOLE = ("mamba", "xk", "xv")


def build_cache(model, prefill_cache, B, S_cache):
    """Splice a prefill cache (for the vlm family, over the patch prefix
    and the prompt) into a zero decode cache of length S_cache,
    layer (or hybrid segment) by layer and name by name (``{"k", "v"}``,
    MLA's ``{"ckv", "kr"}``, the hybrid's ``{"attn_k", "attn_v"}``), along
    the sequence axis; the names of :data:`WHOLE` cross whole. The ssm
    family's cache is its recurrent state (one dict of stacked states),
    which crosses whole."""
    if model.cfg.family == "ssm":
        descs = model.cache_descs(B, S_cache)
        return {n: t.to(PM.torch_dtype(descs[n].dtype))
                for n, t in prefill_cache.items()}
    big = PM.materialize(model.cache_descs(B, S_cache), None, model.device)
    for layer, part in zip(big, prefill_cache):
        for name, t in part.items():
            if name in WHOLE:
                layer[name] = _cast_like(t, layer[name])
            else:
                layer[name][:, :t.shape[1]] = t.to(layer[name].dtype)
    return big


def _cast_like(t, like):
    """``t`` (a tensor or a dict of them) in ``like``'s dtypes."""
    if isinstance(t, dict):
        return {n: _cast_like(s, like[n]) for n, s in t.items()}
    return t.to(like.dtype)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model, params, batch, prompt_len, gen_steps, S_cache,
          stats: Optional[dict] = None):
    """Greedy generation; returns (generated tokens (B, gen_steps),
    tokens/s). With ``stats`` (a dict) the prefill is timed on its own
    (one extra synchronize) and ``prefill_s`` / ``decode_s`` are stored
    in it."""
    dev = model.device
    t0 = time.perf_counter()
    logits, pcache = model.prefill(params, batch)
    B = batch["tokens"].shape[0]
    cache = build_cache(model, pcache, B, S_cache)
    del pcache
    pos = torch.full((B,), prompt_len, dtype=torch.int64, device=dev)
    tok = logits.argmax(-1)[:, None]
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    out = [tok]
    for _ in range(gen_steps - 1):
        logits, cache = model.decode(params, tok, pos, cache)
        tok = logits.argmax(-1)[:, None]
        pos = pos + 1
        out.append(tok)
    toks = torch.cat(out, dim=1)
    _sync(dev)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats["decode_s"] = time.perf_counter() - t1
    return toks, (B * gen_steps) / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, args.device)
    params = model.init(args.seed)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size,
                                      (args.batch, args.prompt),
                                      generator=gen).to(model.device)}
    prompt = DATA.add_modality_stub(prompt, cfg, 0, args.seed)
    n_prefix = cfg.vision.num_patches if cfg.family == "vlm" else 0
    toks, tps = serve(model, params, prompt, args.prompt + n_prefix,
                      args.gen, args.cache)
    print(f"[serve] {args.arch}: generated {tuple(toks.shape)} at "
          f"{tps:.1f} tok/s on {model.device}")
    assert int(toks.min()) >= 0
    return toks


if __name__ == "__main__":
    main()
