"""Serving command line: batched greedy decode against a KV cache / SSM state
(the port of `src/repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --reduced --batch 8 --prompt 32 --decode 64 [--device cpu]

The prompt is teacher-forced through `make_serve_step` (the decode step, as
the reference does), then `--decode` tokens are decoded greedily.  For the
encdec family (whisper) the batch's frames are encoded first (the flash
kernel, one call an encoder layer) and `prefill_cross` fills each decoder
layer's cross-attention K/V from the encoder states; for the vlm family
(llama-3.2-vision) `prefill_cross` fills each cross layer's K/V from the
batch's image embeddings (plain products, no kernel), as the reference's
CLI does.  Prints the decode rate and `ok`; exits nonzero on NaN logits.
Runs on the CUDA device unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.launch.train import make_serve_step
from repro_torch.models import api, encdec, vlm
from repro_torch.utils.device import resolve_device


def prepare_cache(cfg, params, batch_size: int, cache_len: int, device,
                  frames=None, image_embeds=None):
    """The decode cache of `api.init_cache`; for encdec, with the
    cross-attention K/V of the encoded (B, T_enc, d_model) `frames`, for
    vlm with those of the (B, n_image_tokens, d_model) `image_embeds`."""
    cache = api.init_cache(cfg, batch_size, cache_len, device=device)
    memory = {"encdec": ("frames", frames),
              "vlm": ("image_embeds", image_embeds)}.get(cfg.family)
    if memory is None:
        return cache
    name, embeds = memory
    if embeds is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family decodes "
                         f"against cross-attention K/V; pass the batch's "
                         f"`{name}`")
    with torch.inference_mode():
        if cfg.family == "vlm":
            return vlm.prefill_cross(cfg, params, cache, embeds)
        enc_out = encdec.encode(cfg, params, embeds)
        return encdec.prefill_cross(cfg, params, cache, enc_out)


def serve(cfg, params, tokens, decode: int, device, frames=None,
          image_embeds=None):
    """Teacher-force the (B, P) prompt `tokens`, then decode greedily; for
    encdec, the (B, T_enc, d_model) `frames` are encoded into the cache
    first, for vlm the (B, n_image_tokens, d_model) `image_embeds` fill its
    image K/V.  Returns dict(logits (B, 1, V) of the last step, generated (B,
    decode), encode_s, prompt_s, decode_s, tok_per_s); times are
    synchronised on a card."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch, prompt = tokens.shape
    t_enc = time.perf_counter()
    cache = prepare_cache(cfg, params, batch, prompt + decode, dev, frames,
                          image_embeds)
    step = make_serve_step(cfg)
    sync()
    t0 = time.perf_counter()
    logits = None
    for i in range(prompt):
        logits, cache = step(params, cache, tokens[:, i:i + 1], i)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync()
    t1 = time.perf_counter()
    out = []
    for i in range(decode):
        logits, cache = step(params, cache, tok, prompt + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    sync()
    dt = time.perf_counter() - t1
    return dict(logits=logits, generated=torch.cat(out, dim=1),
                encode_s=t0 - t_enc, prompt_s=t1 - t0, decode_s=dt,
                tok_per_s=batch * decode / dt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = api.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = api.make_batch(cfg, gen, args.batch, args.prompt, device=dev)
    res = serve(cfg, params, batch["tokens"], args.decode, dev,
                frames=batch.get("frames"),
                image_embeds=batch.get("image_embeds"))
    print(f"{cfg.name}: decoded {args.decode} x batch {args.batch} in "
          f"{res['decode_s']:.2f}s -> {res['tok_per_s']:.1f} tok/s on {dev}")
    if bool(torch.isnan(res["logits"]).any()):
        raise SystemExit("NaN logits")
    print("ok")


if __name__ == "__main__":
    main()
